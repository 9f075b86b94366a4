"""Stable-Diffusion-inpainting guidance: the stack, the score-distillation
step and the train-step hook.

Port of gbnerf_tpu/guidance/stable.py: ``SDModules``, ``build_sd_modules``
(with the direction-suffixed prompt embeddings of Perp-Neg), ``_resize``,
``_gate_negative``, ``sd_train_step`` (2-way SDS and the 3-way CSD
combine), ``sd_train_step_colla`` (collaborative guidance over K views),
``sd_train_step_perpneg``, ``precompute_masked_latents``,
``guidance_params`` and ``make_guidance_fn`` for the RGB (plain or
Perp-Neg), collaborative and normal-map modalities. As in the JAX package
the prompts are encoded once at build time, the UNet runs without gradient
(its CFG copies batched on the leading axis), and only the VAE encode of
the renders is differentiated.

Every random draw is an optional argument (the noise ε, the VAE posterior
ε of the render and of the masked image, Perp-Neg's orbit uniforms), else
drawn from a ``torch.Generator`` or from a ``JaxKey`` (utils/jax_random.py),
split as the JAX package splits its key so that the draws are that
package's: the stack's init, every modality (RGB, Perp-Neg, colla,
normal) and the masked-latents cache. The VAE posterior's ε is drawn in
the modules' dtype, the latents' (bf16 in the bf16 stack), as the JAX
package's encode draws it.

Resizing: ``jax.image.resize`` samples at half-pixel centres. Its
"nearest" at the 512 → 64 mask downsample is torch's "nearest-exact"
(pixel 8i + 4), not "nearest" (8i); its "bilinear" upsampling is
``F.interpolate(mode="bilinear", align_corners=False)``. When it
downsamples, jax antialiases (a triangle kernel widened by the scale);
the port then passes ``antialias=True``, torch's kernel of the same shape.

LoRA: with ``weights_dir`` the config's ``model_path`` (a PEFT-LoRA
dir) merges into the UNet's state dict as it loads; ``sd_lora_ckpt`` (the
adapters of train_lora, guidance/lora.py) merges into the UNet and, when
the file has them, the text tower before the prompt embeddings are
computed, unless ``sd_prior_ckpt`` is set: the prior replaces the UNet
after the build, so train/loop.py merges after loading it.

Versions: ``sd_version`` "1.5" (also "1" and "1.4", the SD1.x-inpaint
architecture) or "xl", diffusers' SDXL-inpainting stack (unet.py's
``UNetConfig.sdxl_inpaint``, two text towers, the VAE at 0.13025, 1024²
latents); any other is refused. The XL UNet takes an added conditioning,
the pooled prompt embedding and the size and crop ids. A set of prompt
rows travels as ``Prompts`` (each row's context and, on SDXL, its pooled
embedding, gated, sliced and repeated together; a bare context tensor is
a set without pooled rows), and every UNet call passes
``mods.added_cond`` of the rows' pooled embeddings with the stack's one
set of size ids (``SDModules.time_ids``; None on SD1.x).
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from ..utils import jax_random as jr
from .blocks import init_weights_
from .schedule import DiffusionSchedule
from .directional import adjust_text_embeddings, wrap_azimuth
from .orchestrator import progressive_ranges, rand_poses
from .perpneg import weighted_perpendicular_aggregator
from .sds import (cfg_combine_bsd, cfg_combine_colla, cfg_combine_sds,
                  inject_gradient, score_distillation_grad)
from .text import CLIPTextConfig, CLIPTextEncoder, Tokenizer
from .unet import UNet2DCondition, UNetConfig
from .vae import SDXL_VAE_SCALING, AutoencoderKL, VAEConfig

LATENT_SIZE = 512  # the reference resizes every render to 512² (sd_utils.py:344)
XL_LATENT_SIZE = 1024  # SDXL's native resolution
SD1_VERSIONS = ("1", "1.4", "1.5")


class Prompts(NamedTuple):
    """Prompt rows as the UNet is conditioned on them: the context
    [k, L, D] and, on SDXL, each row's pooled embedding [k, P] (None on
    SD1.x). ``rows``, ``repeat`` and ``cat`` act on both, so that a row's
    context and pooled embedding stay together."""

    context: torch.Tensor
    pooled: Optional[torch.Tensor] = None

    @staticmethod
    def of(embeds) -> "Prompts":
        """``embeds`` as it is, or a bare context [k, L, D] (SD1.x, and
        the JAX package's embeddings) as rows without pooled ones."""
        return embeds if isinstance(embeds, Prompts) else Prompts(embeds)

    def rows(self, idx) -> "Prompts":
        """The rows ``idx`` (an index, a slice, a list, or None for a new
        leading axis) of both."""
        return Prompts(self.context[idx],
                       None if self.pooled is None else self.pooled[idx])

    def repeat(self, n: int) -> "Prompts":
        """Each row n times in turn (the K views of a row)."""
        return Prompts(*(None if x is None else x.repeat_interleave(n, dim=0)
                         for x in self))

    @staticmethod
    def cat(parts: Sequence["Prompts"]) -> "Prompts":
        pooled = [p.pooled for p in parts]
        return Prompts(torch.cat([p.context for p in parts]),
                       None if pooled[0] is None else torch.cat(pooled))


@dataclass
class SDModules:
    """The models and the precomputed prompt embeddings."""

    unet: UNet2DCondition
    vae: AutoencoderKL
    schedule: DiffusionSchedule
    embeds_rgb: torch.Tensor       # [3, L, D] (null, uncond, text), f32
    embeds_normal: torch.Tensor    # the same triple for the normal prompt
    # {front, side, back} → [L, D]: the direction-suffixed prompt embeds
    # of Perp-Neg; None unless gcfg.perpneg
    embeds_dir: Optional[Dict[str, torch.Tensor]] = None
    latent_size: int = LATENT_SIZE
    text_model: Any = None
    tokenizer: Any = None
    # SDXL: the second text tower, the pooled embeddings of the prompt
    # rows above ([3, P] each; a dict of [P] for Perp-Neg's; read as pairs
    # through prompts_rgb, prompts_normal) and the size and crop ids [6]
    # (original H, W, crop top, left, target H, W) of every UNet call
    text_model_2: Any = None
    tokenizer_2: Any = None
    pooled_rgb: Optional[torch.Tensor] = None
    pooled_normal: Optional[torch.Tensor] = None
    pooled_dir: Optional[Dict[str, torch.Tensor]] = None
    time_ids: Optional[torch.Tensor] = None

    @property
    def latent_res(self) -> int:
        return self.latent_size // 8

    @property
    def prompts_rgb(self) -> Prompts:
        return Prompts(self.embeds_rgb, self.pooled_rgb)

    @property
    def prompts_normal(self) -> Prompts:
        return Prompts(self.embeds_normal, self.pooled_normal)

    def encode_prompts(self, prompts: Sequence[str]) -> Prompts:
        """prompts → their rows: the UNet's context [B, L, D] and the
        pooled embedding [B, P] (None without a second tower)."""
        return encode_prompts(self.text_model, self.tokenizer, prompts,
                              self.text_model_2, self.tokenizer_2)

    def added_cond(self, pooled: Optional[torch.Tensor]
                   ) -> Optional[Dict[str, torch.Tensor]]:
        """The UNet's added conditioning of prompt rows whose pooled
        embeddings are ``pooled`` [k, P]: {"text_embeds", "time_ids"};
        None for a stack without it (pooled None)."""
        if pooled is None:
            return None
        return {"text_embeds": pooled,
                "time_ids": self.time_ids.expand(pooled.shape[0], -1)}


def size_time_ids(size: int, device) -> torch.Tensor:
    """SDXL's size and crop ids [6] of an uncropped size² image, as
    diffusers' add_time_ids: the original size, the crop's top-left (0,
    0), the target size; made on the device, with no copy from the
    host."""
    ids = torch.full((6,), float(size), device=device)
    ids[2:4] = 0.0
    return ids


def encode_prompts(text, tok, prompts: Sequence[str], text_2=None,
                   tok_2=None) -> Prompts:
    """The rows of ``prompts``: one tower's context, or SDXL's two towers'
    contexts concatenated on the width with the second tower's pooled
    embedding."""
    if text_2 is None:
        return Prompts(text(tok(prompts)))
    ctx2, pooled = text_2(tok_2(prompts), pooled=True)
    return Prompts(torch.cat([text(tok(prompts)), ctx2], dim=-1), pooled)


def _build(ctor, generator, device, dtype):
    """ctor() built without storage, placed on ``device``, initialised from
    ``generator`` there, then cast to ``dtype``: a full-size init on the
    card takes a fraction of a second, on the host tens of seconds. A
    JaxKey leaves the storage for ``init_sd`` to fill."""
    with torch.device("meta"):
        module = ctor()
    module = module.to_empty(device=device)
    if not jr.is_jax(generator):
        init_weights_(module, generator)
    return module.to(dtype).eval().requires_grad_(False)


def tiny_configs(sd_version: str = "1.5") -> Dict[str, Any]:
    """build_sd_modules' configs of the tiny stack (tests, smoke runs) of
    a version: the same topology at tiny widths."""
    if sd_version != "xl":
        return dict(unet_config=UNetConfig.tiny(),
                    vae_config=VAEConfig.tiny(),
                    text_config=CLIPTextConfig(vocab_size=49408, width=32,
                                               layers=2, heads=2))
    return dict(unet_config=UNetConfig.sdxl_tiny(),
                vae_config=VAEConfig(block_out_channels=(16, 16, 32, 32),
                                     layers_per_block=1,
                                     scaling_factor=SDXL_VAE_SCALING),
                text_config=CLIPTextConfig(width=16, layers=2, heads=2,
                                           layer_norm_eps=1e-5,
                                           output="penultimate"),
                text_config_2=CLIPTextConfig(width=24, layers=2, heads=2,
                                             hidden_act="gelu",
                                             layer_norm_eps=1e-5,
                                             output="penultimate",
                                             projection_dim=16))


def sd_version(gcfg) -> str:
    """The config's SD version, checked: "1.5" for the SD1.x versions,
    "xl"; any other is refused."""
    ver = str(getattr(gcfg, "sd_version", "1.5") or "1.5")
    if ver.startswith("2"):
        raise NotImplementedError(
            f"sd_version={ver!r}: SD2.x is not implemented (the SD1.x- and "
            "SDXL-inpaint architectures are); use sd_version=1.5 with an "
            "SD1.x-inpaint checkpoint or sd_version=xl with SDXL's.")
    if ver in SD1_VERSIONS:
        return "1.5"
    if ver != "xl":
        raise NotImplementedError(
            f"sd_version={ver!r} is unknown: 1.5 (or 1, 1.4: SD1.x) or xl")
    return ver


def build_sd_modules(gcfg, generator: Optional[torch.Generator] = None, *,
                     unet_config: Optional[UNetConfig] = None,
                     vae_config: Optional[VAEConfig] = None,
                     text_config: Optional[CLIPTextConfig] = None,
                     text_config_2: Optional[CLIPTextConfig] = None,
                     weights_dir: Optional[str] = None,
                     latent_size: Optional[int] = None,
                     dtype=torch.bfloat16, device=None) -> SDModules:
    """Init (or load) the SD-inpainting stack on ``device`` and precompute
    the prompt embeddings.

    generator: draws the random init, on ``device`` (default: one seeded
    with 0); a JaxKey gives the JAX package's init from that key
    (utils/jax_init.py::init_sd). weights_dir: a local diffusers-layout
    checkpoint; without it the models keep their random init — the
    pipeline runs, quality needs real weights. The UNet and VAE compute in
    ``dtype`` (bf16 on the card; the JAX package keeps f32 params and
    computes in bf16, the same rounding); the text towers in f32.
    gcfg.sd_version "xl" builds SDXL's stack (the module note) from the
    configs given, else its published ones; latent_size: the guidance
    resolution, by default 512 (SD1.x) or 1024 (SDXL).
    """
    xl = sd_version(gcfg) == "xl"
    device = torch.device(device if device is not None else "cpu")
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    if xl and jr.is_jax(generator):
        raise ValueError("the SDXL stack has no JAX twin to take draws "
                         "from: use torch draws")
    ucfg = unet_config or (UNetConfig.sdxl_inpaint() if xl
                           else UNetConfig.sd15_inpaint())
    vcfg = vae_config or (VAEConfig.sdxl() if xl else VAEConfig())
    tcfg = text_config or (CLIPTextConfig.sdxl_l() if xl
                           else CLIPTextConfig())
    latent_size = latent_size or (XL_LATENT_SIZE if xl else LATENT_SIZE)

    unet = _build(lambda: UNet2DCondition(ucfg), generator, device, dtype)
    vae = _build(lambda: AutoencoderKL(vcfg), generator, device, dtype)
    text = _build(lambda: CLIPTextEncoder(tcfg), generator, device,
                  torch.float32)
    text_2 = tok_2 = None
    if xl:
        tcfg2 = text_config_2 or CLIPTextConfig.sdxl_bigg()
        text_2 = _build(lambda: CLIPTextEncoder(tcfg2), generator, device,
                        torch.float32)
    if jr.is_jax(generator):
        from ..utils.jax_init import init_sd

        init_sd(unet, vae, text, generator)

    tok_dir = weights_dir and os.path.join(weights_dir, "tokenizer")
    if tok_dir and not os.path.isdir(tok_dir):
        print(f"[text] WARNING: {weights_dir} has no tokenizer/ dir — "
              "prompts use the deterministic hash fallback, NOT real CLIP "
              "BPE. Do not use this for a real-weights run.")
        tok_dir = None
    tok = Tokenizer(tok_dir, max_length=tcfg.max_length,
                    vocab_size=tcfg.vocab_size)
    if xl:
        tok2_dir = tok_dir and os.path.join(weights_dir, "tokenizer_2")
        tok_2 = Tokenizer(tok2_dir if tok2_dir and os.path.isdir(tok2_dir)
                          else None, max_length=tcfg2.max_length,
                          vocab_size=tcfg2.vocab_size)
    if weights_dir:
        from .weights import load_sd_weights

        load_sd_weights(weights_dir, unet, vae, text,
                        lora_dir=gcfg.model_path, lora_rank=gcfg.lora_rank,
                        text_2=text_2)
    if gcfg.sd_lora_ckpt and not gcfg.sd_prior_ckpt:
        from .lora import merge_lora_strict, split_adapters

        unet_ad, text_ad = split_adapters(gcfg.sd_lora_ckpt)
        merge_lora_strict(unet, unet_ad, what="unet",
                          source=gcfg.sd_lora_ckpt)
        if text_ad is not None:
            merge_lora_strict(text, text_ad, what="text encoder",
                              source=gcfg.sd_lora_ckpt)
        print(f"[guidance] merged LoRA adapters from {gcfg.sd_lora_ckpt}"
              + (" (unet+text)" if text_ad is not None else " (unet)"))

    @torch.no_grad()
    def encode(prompts):
        return encode_prompts(text, tok, prompts, text_2, tok_2)

    # (null, uncond, text) triples
    embeds_rgb, pooled_rgb = encode(["", gcfg.negative_prompt, gcfg.prompt])
    embeds_normal, pooled_normal = encode(
        ["", gcfg.negative_prompt, gcfg.prompt_normal or gcfg.prompt])
    embeds_dir = pooled_dir = None
    if gcfg.perpneg:
        # direction-suffixed prompts (stable-dreamfusion's convention)
        z, zp = encode([f"{gcfg.prompt}, {d} view"
                        for d in ("front", "side", "back")])
        embeds_dir = {"front": z[0], "side": z[1], "back": z[2]}
        if zp is not None:
            pooled_dir = {"front": zp[0], "side": zp[1], "back": zp[2]}
    time_ids = size_time_ids(latent_size, device) if xl else None

    return SDModules(
        unet=unet, vae=vae, schedule=DiffusionSchedule.sd_v1(),
        embeds_rgb=embeds_rgb, embeds_normal=embeds_normal,
        embeds_dir=embeds_dir, latent_size=latent_size, text_model=text,
        tokenizer=tok, text_model_2=text_2, tokenizer_2=tok_2,
        pooled_rgb=pooled_rgb, pooled_normal=pooled_normal,
        pooled_dir=pooled_dir, time_ids=time_ids)


def _resize(img: torch.Tensor, size, method: str = "bilinear"
            ) -> torch.Tensor:
    """[B, H, W, C] → [B, h, w, C] with (h, w) = size (an int: square), as
    jax.image.resize (see the module note)."""
    h, w = (size, size) if isinstance(size, int) else size
    x = img.permute(0, 3, 1, 2)
    if method == "nearest":
        x = F.interpolate(x, size=(h, w), mode="nearest-exact")
    else:
        down = h < img.shape[1] or w < img.shape[2]
        x = F.interpolate(x, size=(h, w), mode="bilinear",
                          align_corners=False, antialias=down)
    return x.permute(0, 2, 3, 1)


def _gate_negative(prompts: Prompts, gate_step: int,
                   use_negative: int) -> Prompts:
    """Delayed negative-prompt gate: until the global iteration passes
    use_negative the uncond slot is the null ("") row. The step counter
    is 0-based, the reference's 1-based: its ``i > use_negative`` is
    ``step + 1 > use_negative``."""
    return prompts.rows([0, 1 if gate_step + 1 > use_negative else 0, 2])


def _randn(shape, generator, dtype, device) -> torch.Tensor:
    return jr.draw("randn", shape, generator, dtype, device)


def sd_train_step(mods: SDModules, gcfg, step_i: int, rgb: torch.Tensor,
                  mask: torch.Tensor,
                  generator: Optional[torch.Generator] = None, *,
                  embeds, guidance_scale: float,
                  mode: Optional[str] = None, w_triple=None,
                  gate_step: Optional[int] = None,
                  masked_latents: Optional[torch.Tensor] = None,
                  noise: Optional[torch.Tensor] = None,
                  enc_eps: Optional[torch.Tensor] = None,
                  enc_masked_eps: Optional[torch.Tensor] = None):
    """One score-distillation step on an image modality → scalar loss.

    rgb: [H, W, 3] differentiable render composite in [0, 1]; mask: [H, W]
    (1 = masked); embeds: the rows (null, uncond, text), Prompts or a
    context [3, L, D]; mode "csd" |
    "sds" (default from gcfg.use_csd); w_triple: (w1, w2, w3) of the 3-way
    combine (default the shared gcfg.w1..3); gate_step: the global
    iteration of the use_negative gate (default step_i); masked_latents: a
    cached [1, LR, LR, 4] encoding of the masked conditioning image.
    noise, enc_eps, enc_masked_eps: the injected draws, [1, LR, LR, 4] each
    (the noise ε, the posterior ε of the render's and of the masked image's
    encode); each is drawn from ``generator`` when not given.
    """
    mode = mode or ("csd" if gcfg.use_csd else "sds")
    if w_triple is None:
        w_triple = (gcfg.w1, gcfg.w2, gcfg.w3)
    prompts = _gate_negative(Prompts.of(embeds),
                             step_i if gate_step is None else gate_step,
                             gcfg.use_negative)
    latents_t, noise, mask_latent, unet_in, t = _noised_latents(
        mods, gcfg, step_i, rgb[None], mask[None], generator,
        masked_latents=masked_latents, noise=noise, enc_eps=enc_eps,
        enc_masked_eps=enc_masked_eps)

    k = 3 if mode == "csd" else 2
    if k == 2:
        prompts = prompts.rows(slice(1, None))                # (u, t) 2-way
    with torch.no_grad():
        eps = mods.unet(unet_in.expand(k, -1, -1, -1), t, prompts.context,
                        mods.added_cond(prompts.pooled))
    if mode == "csd":
        pred = cfg_combine_bsd(eps[0], eps[1], eps[2], *w_triple)
    else:
        pred = cfg_combine_sds(eps[0], eps[1], guidance_scale)
    return _inject(mods, gcfg, latents_t, pred[None], noise, t, mask_latent,
                   mode=mode)


def _noised_latents(mods: SDModules, gcfg, step_i: int, rgbs, masks,
                    generator, *, masked_latents=None, noise=None,
                    enc_eps=None, enc_masked_eps=None):
    """The differentiable half of a score-distillation step on B images:
    rgbs [B, H, W, 3] in [0, 1] and masks [B, H, W] → (latents_t, noise,
    mask_latent, unet_in, t). The images are resized to S², encoded (with
    gradient) and noised at the annealed t; the masked images are encoded
    without gradient unless ``masked_latents`` is given; unet_in [B, LR,
    LR, 9] is the UNet's input (noised latents without gradient, the
    latent mask, the masked latents). noise, enc_eps, enc_masked_eps: the
    injected draws [B, LR, LR, 4], else drawn from ``generator`` (a JaxKey
    splits in three as the JAX package's: noise, render, masked image)."""
    S, LR = mods.latent_size, mods.latent_res
    k_noise, k_enc1, k_enc2 = jr.split(generator, 3)
    sched = mods.schedule
    dev, vdt = rgbs.device, mods.vae.quant_conv.weight.dtype
    lat_shape = (rgbs.shape[0], LR, LR, mods.vae.config.latent_channels)

    rgb512 = _resize(rgbs, S) * 2.0 - 1.0                    # [B,S,S,3]
    mask512 = _resize(torch.abs(masks)[..., None], S)         # [B,S,S,1]
    if enc_eps is None:
        enc_eps = _randn(lat_shape, k_enc1, vdt, dev)
    init_latents = mods.vae.encode(rgb512, enc_eps)           # differentiable
    if masked_latents is None:
        if enc_masked_eps is None:
            enc_masked_eps = _randn(lat_shape, k_enc2, vdt, dev)
        with torch.no_grad():
            masked_latents = mods.vae.encode(rgb512 * (mask512 < 0.5),
                                             enc_masked_eps)
    mask_latent = _resize(mask512, LR, method="nearest")      # [B,LR,LR,1]

    t = sched.annealed_t(step_i, gcfg.t_range, gcfg.anneal_iters)
    if noise is None:
        noise = _randn(init_latents.shape, k_noise, torch.float32, dev)
    latents_t = sched.add_noise(init_latents, noise, t)
    unet_in = torch.cat([latents_t.detach(), mask_latent,
                         masked_latents.to(latents_t.dtype)], dim=-1)
    return latents_t, noise, mask_latent, unet_in, t


def _inject(mods: SDModules, gcfg, latents_t, pred, noise, t, mask_latent, *,
            mode: str, standard_sds: bool = False) -> torch.Tensor:
    """The score-distillation gradient of ``pred`` injected into latents_t
    under the latent mask, at weight lambda_guidance."""
    grad = score_distillation_grad(pred, noise,
                                   mods.schedule.sds_weight(t, pred.device),
                                   mode=mode, standard_sds=standard_sds)
    return gcfg.lambda_guidance * inject_gradient(latents_t, grad,
                                                  mask_latent)


def sd_train_step_colla(mods: SDModules, gcfg, step_i: int,
                        rgbs: torch.Tensor, masks: torch.Tensor,
                        generator: Optional[torch.Generator] = None, *,
                        embeds=None,
                        noise: Optional[torch.Tensor] = None,
                        enc_eps: Optional[torch.Tensor] = None,
                        enc_masked_eps: Optional[torch.Tensor] = None):
    """Collaborative score distillation over K neighbour views (the
    reference's train_step_colla_sds) → scalar, summed over the views.

    rgbs: [K, H, W, 3] rendered views in [0, 1]; masks: [K, H, W]. Under
    use_csd the per-view 3-way combine w1·ε_text + (w2 − w1)·ε_null −
    w2·ε_uncond (shared w1/w2), else the 2-way CFG at
    colla_guidance_scale with the textbook gradient w·(ε̂ − ε), which
    differs from sd_train_step's reference-exact w·ε̂ − ε. The masked
    images come from the renders, so they are encoded every call. The
    UNet's batch is [null×K,] uncond×K, text×K, the embeddings repeated
    per view in the same order. noise, enc_eps, enc_masked_eps: the
    injected draws [K, LR, LR, 4]; a JaxKey splits in three over the K
    views as the JAX package's (noise, renders, masked images). embeds:
    the rows (null, uncond, text) as sd_train_step's, by default the
    stack's RGB prompts.
    """
    K, LR = rgbs.shape[0], mods.latent_res
    mode = "csd" if gcfg.use_csd else "sds"
    nc = 3 if mode == "csd" else 2                            # CFG copies
    prompts = _gate_negative(
        mods.prompts_rgb if embeds is None else Prompts.of(embeds), step_i,
        gcfg.use_negative)
    if mode != "csd":
        prompts = prompts.rows(slice(1, None))                # (u, t) 2-way
    prompts = prompts.repeat(K)
    latents_t, noise, mask_latent, unet_in, t = _noised_latents(
        mods, gcfg, step_i, rgbs, masks, generator, noise=noise,
        enc_eps=enc_eps, enc_masked_eps=enc_masked_eps)

    with torch.no_grad():
        eps = mods.unet(unet_in.repeat(nc, 1, 1, 1), t, prompts.context,
                        mods.added_cond(prompts.pooled))
    eps = eps.reshape(nc, K, LR, LR, eps.shape[-1])
    if mode == "csd":
        pred = cfg_combine_colla(eps[0], eps[1], eps[2], gcfg.w1, gcfg.w2)
    else:
        pred = cfg_combine_sds(eps[0], eps[1], gcfg.colla_guidance_scale)
    return _inject(mods, gcfg, latents_t, pred, noise, t, mask_latent,
                   mode=mode, standard_sds=True)


def sd_train_step_perpneg(mods: SDModules, gcfg, step_i: int,
                          rgb: torch.Tensor, mask: torch.Tensor,
                          generator: Optional[torch.Generator] = None, *,
                          text_z, weights: torch.Tensor,
                          guidance_scale: float, uncond,
                          masked_latents: Optional[torch.Tensor] = None,
                          noise: Optional[torch.Tensor] = None,
                          enc_eps: Optional[torch.Tensor] = None,
                          enc_masked_eps: Optional[torch.Tensor] = None):
    """Perp-Neg SDS on one modality → scalar: the azimuth-blended positive
    prompt plus the weighted perpendicular components of the auxiliary
    directions' deltas, one UNet call at batch 1 + (1 + K) (uncond, the
    main direction, the K auxiliaries).

    text_z: the 1+K rows from adjust_text_embeddings; weights: [K];
    uncond: one row; each Prompts or a context ([1+K, L, D], [L, D]).
    masked_latents and the draws as sd_train_step's.
    """
    latents_t, noise, mask_latent, unet_in, t = _noised_latents(
        mods, gcfg, step_i, rgb[None], mask[None], generator,
        masked_latents=masked_latents, noise=noise, enc_eps=enc_eps,
        enc_masked_eps=enc_masked_eps)
    prompts = Prompts.cat([Prompts.of(uncond).rows(None),
                           Prompts.of(text_z)])               # uncond + dirs
    k = prompts.context.shape[0]
    with torch.no_grad():
        eps = mods.unet(unet_in.expand(k, -1, -1, -1), t, prompts.context,
                        mods.added_cond(prompts.pooled))
    e_unc = eps[:1]
    agg = weighted_perpendicular_aggregator(eps[1:] - e_unc, weights, 1)
    pred = e_unc[0] + guidance_scale * agg[0]
    return _inject(mods, gcfg, latents_t, pred[None], noise, t, mask_latent,
                   mode="sds")


@torch.no_grad()
def precompute_masked_latents(mods: SDModules, images: torch.Tensor,
                              masks: torch.Tensor, *,
                              generator: Optional[torch.Generator] = None,
                              eps: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Per-view VAE encodings of the masked conditioning image →
    [N, LR, LR, 4] (the RGB composite equals the GT outside the mask, so
    this is a per-view constant; the divergence from the reference's
    per-iteration encode is documented at the JAX helper). eps: the
    injected posterior draws [N, LR, LR, 4], else drawn from generator (a
    JaxKey: view i's from fold_in(key, i), as the JAX package's)."""
    S, LR = mods.latent_size, mods.latent_res
    vdt = mods.vae.quant_conv.weight.dtype
    out = []
    for i in range(images.shape[0]):
        rgb512 = _resize(images[i][None], S) * 2.0 - 1.0
        m512 = _resize(torch.abs(masks[i])[None, ..., None], S)
        e = (eps[i:i + 1] if eps is not None else
             _randn((1, LR, LR, mods.vae.config.latent_channels),
                    jr.fold_in(generator, i), vdt, images.device))
        out.append(mods.vae.encode(rgb512 * (m512 < 0.5), e))
    return torch.cat(out, dim=0)


def guidance_params(mods: SDModules) -> Dict[str, Any]:
    """The SD state of the stack: the modules and the prompt embeddings
    (the JAX package threads these through its jitted step as arguments;
    the port's hook holds the modules, so nothing needs to)."""
    p = {"unet": mods.unet, "vae": mods.vae,
         "embeds_rgb": mods.embeds_rgb,
         "embeds_normal": mods.embeds_normal}
    if mods.embeds_dir is not None:
        p["embeds_dir"] = mods.embeds_dir
    return p


def make_guidance_fn(mods: SDModules, gcfg, n_iters: int = 10000):
    """The train-step guidance hook (the reference's Pretrain_Model
    .cal_loss): RGB SDS on the composite (Perp-Neg under gcfg.perpneg),
    collaborative SDS on the K neighbour views, normal-map SDS after
    normal_start_iter, each with its own CFG scale and CSD triple; the
    modality losses sum into one scalar.

    guidance_fn(step_i, combin_rgb [H,W,3], normal_map [h,w,3] | None,
    mask [H,W], generator=None, *, rgbs4=None, masks4=None,
    masked_latents=None, draws=None) → scalar. rgbs4 [K,h,w,3] and masks4
    [K,h,w]: the collaborative views (used under is_colla_guidance).
    draws: {"rgb": {...}, "colla": {...}, "normal": {...}}, each the
    injected draws of its step (noise, enc_eps, enc_masked_eps; for
    Perp-Neg also "u", the orbit uniforms [3, 1] of rand_poses).
    Under Perp-Neg a random orbit azimuth is drawn each step (its view
    ranges widened with the step over ``n_iters`` under progressive_view),
    and the direction-suffixed prompt embeddings are blended by it. The
    normal term is not computed while it is gated off (the JAX package
    computes it and multiplies by 0: the same value and gradient).
    """
    use_perpneg = gcfg.perpneg and mods.embeds_dir is not None

    def _perpneg_rgb(step_i, combin_rgb, mask, generator, *,
                     masked_latents, u=None, **draws):
        # a JaxKey: (orbit, SDS step), as the JAX package splits k_rgb
        k_az, k_sd = jr.split(generator)
        theta_r, phi_r, rad_r = progressive_ranges(step_i, gcfg, n_iters)
        _, _, _, phis, _ = rand_poses(
            1, k_az, u=u, radius_range=rad_r, theta_range=theta_r,
            phi_range=phi_r, angle_overhead=gcfg.angle_overhead,
            angle_front=gcfg.angle_front, device=combin_rgb.device,
            ranges_f32=gcfg.progressive_view)
        az = wrap_azimuth(phis * (180.0 / math.pi) - gcfg.default_azimuth)
        decay = dict(front_decay_factor=gcfg.front_decay_factor,
                     side_decay_factor=gcfg.side_decay_factor,
                     negative_w=gcfg.negative_w)
        text_z, weights = adjust_text_embeddings(mods.embeds_dir, az,
                                                 **decay)
        if mods.pooled_dir is not None:     # the pooled rows, blended alike
            text_z = Prompts(text_z, adjust_text_embeddings(
                mods.pooled_dir, az, **decay)[0])
        return sd_train_step_perpneg(
            mods, gcfg, step_i, combin_rgb, mask, k_sd, text_z=text_z,
            weights=weights, guidance_scale=gcfg.guidance_scale,
            uncond=mods.prompts_rgb.rows(1), masked_latents=masked_latents,
            **draws)

    def guidance_fn(step_i: int, combin_rgb, normal_map, mask,
                    generator: Optional[torch.Generator] = None, *,
                    rgbs4=None, masks4=None, masked_latents=None,
                    draws=None):
        draws = draws or {}
        k_rgb, k_n, k_c = jr.split(generator, 3)
        loss = torch.zeros((), device=combin_rgb.device)
        # masked_latents caches the RGB modality's conditioning encode
        # only: the composite is the GT outside the mask. The collaborative
        # and normal modalities' masked images come from the live renders.
        if gcfg.is_rgb_guidance and use_perpneg:
            loss = loss + _perpneg_rgb(step_i, combin_rgb, mask, k_rgb,
                                       masked_latents=masked_latents,
                                       **draws.get("rgb", {}))
        elif gcfg.is_rgb_guidance:
            loss = loss + sd_train_step(
                mods, gcfg, step_i, combin_rgb, mask, k_rgb,
                embeds=mods.prompts_rgb, guidance_scale=gcfg.guidance_scale,
                w_triple=(gcfg.rgb_w1, gcfg.rgb_w2, gcfg.rgb_w3),
                masked_latents=masked_latents, **draws.get("rgb", {}))
        if gcfg.is_colla_guidance and rgbs4 is not None:
            loss = loss + sd_train_step_colla(
                mods, gcfg, step_i, rgbs4, masks4, k_c,
                embeds=mods.prompts_rgb, **draws.get("colla", {}))
        if (gcfg.is_normal_guidance and normal_map is not None
                and step_i > gcfg.normal_start_iter):
            # the normal anneal restarts when it switches on: it runs on
            # i − normal_start_iter; the use_negative gate on the global i
            loss = loss + sd_train_step(
                mods, gcfg, step_i - gcfg.normal_start_iter, normal_map, mask,
                k_n, embeds=mods.prompts_normal,
                guidance_scale=gcfg.normal_guidance_scale,
                w_triple=(gcfg.normal_w1, gcfg.normal_w2, gcfg.normal_w3),
                gate_step=step_i, **draws.get("normal", {}))
        return loss

    return guidance_fn
