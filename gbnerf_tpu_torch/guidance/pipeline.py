"""Offline SD-inpainting pipeline: the multi-step DDIM denoise loop.

Port of gbnerf_tpu/guidance/pipeline.py: ``get_timesteps`` (DDIM-spaced,
``strength``-sliced), ``inpaint`` (latent and mask preparation, per step
one UNet forward over the CFG copies — 2-way SDS or the 3-way BSD combine —
and a DDIM update, then the VAE decode) and the txt2img sanity path
``prompt_to_img``. The JAX package runs the loop as one ``fori_loop`` in a
jit; here it is a plain Python loop on the device, under ``no_grad``.

The draws are arguments, else drawn from ``generator`` (a torch.Generator,
or a JaxKey split in three as the JAX package splits it): ``noise`` (the
initial latents at strength 1, else the noise ``add_noise`` puts on the
encoded image; the JAX package's ``k_lat``), ``enc_masked_eps`` and
``enc_init_eps`` (the VAE posterior draws of the masked and of the whole
image; its ``k_enc1``, ``k_enc2``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils import jax_random as jr
from .sds import cfg_combine_bsd, cfg_combine_sds
from .stable import Prompts, SDModules, _randn, _resize


def get_timesteps(num_inference_steps: int, strength: float,
                  num_train_timesteps: int = 1000) -> np.ndarray:
    """DDIM-spaced timesteps, strength-sliced (the pipeline's
    get_timesteps)."""
    step = num_train_timesteps // num_inference_steps
    ts = (np.arange(0, num_inference_steps) * step).round()[::-1].astype(int)
    init_t = min(int(num_inference_steps * strength), num_inference_steps)
    return ts[num_inference_steps - init_t:]


@torch.no_grad()
def inpaint(mods: SDModules, embeds, image: torch.Tensor,
            mask: torch.Tensor, generator: Optional[torch.Generator] = None,
            *, num_inference_steps: int = 50, guidance_scale: float = 7.5,
            strength: float = 1.0, use_csd: bool = False, w1: float = 8.5,
            w2: float = 7.5, w3: float = 0.5,
            noise: Optional[torch.Tensor] = None,
            enc_masked_eps: Optional[torch.Tensor] = None,
            enc_init_eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full inpainting generation → [S, S, 3] image in [0, 1], f32.

    embeds: the rows (null, uncond, text), Prompts (SDXL's carry their
    pooled rows) or a context [3, L, D]; image [H, W, 3] in [0, 1]; mask
    [H, W] (1 = repaint). The draws: see the module note.
    """
    S, LR = mods.latent_size, mods.latent_res
    sched = mods.schedule
    dev = image.device
    vdt = mods.vae.quant_conv.weight.dtype
    lat_shape = (1, LR, LR, mods.vae.config.latent_channels)

    img512 = _resize(image[None].float(), S) * 2.0 - 1.0
    mask512 = _resize(torch.abs(mask.float())[None, ..., None], S)
    masked_image = img512 * (mask512 < 0.5)
    # a JaxKey splits in three as the JAX package's: the latents' noise,
    # the masked image's posterior ε, the init image's (a generator is
    # drawn in the order masked image, noise, init image)
    k_lat, k_enc1, k_enc2 = jr.split(generator, 3)
    if enc_masked_eps is None:
        enc_masked_eps = _randn(lat_shape, k_enc1, vdt, dev)
    masked_latents = mods.vae.encode(masked_image, enc_masked_eps)
    mask_lat = _resize(mask512, LR, method="nearest")

    ts = get_timesteps(num_inference_steps, strength,
                       sched.num_train_timesteps)
    if noise is None:
        noise = _randn(lat_shape, k_lat, torch.float32, dev)
    if strength >= 1.0:
        latents = noise.float()
    else:
        if enc_init_eps is None:
            enc_init_eps = _randn(lat_shape, k_enc2, vdt, dev)
        init_latents = mods.vae.encode(img512, enc_init_eps)
        latents = sched.add_noise(init_latents, noise.float(), int(ts[0]))

    k = 3 if use_csd else 2
    prompts = Prompts.of(embeds)
    if not use_csd:
        prompts = prompts.rows(slice(1, None))
    added = mods.added_cond(prompts.pooled)
    cond = torch.cat([mask_lat, masked_latents.to(latents.dtype)], dim=-1)
    for i, t in enumerate(ts):
        t_prev = int(ts[i + 1]) if i + 1 < len(ts) else -1
        unet_in = torch.cat([latents, cond], dim=-1).expand(k, -1, -1, -1)
        eps = mods.unet(unet_in, int(t), prompts.context, added)
        if use_csd:
            pred = cfg_combine_bsd(eps[0], eps[1], eps[2], w1, w2, w3)[None]
        else:
            pred = cfg_combine_sds(eps[0], eps[1], guidance_scale)[None]
        latents = sched.ddim_step(latents, pred, int(t), t_prev)
    img = mods.vae.decode(latents).float()
    return torch.clamp(img[0] * 0.5 + 0.5, 0.0, 1.0)


def prompt_to_img(mods: SDModules, embeds,
                  generator: Optional[torch.Generator] = None, *,
                  steps: int = 50, guidance_scale: float = 7.5,
                  noise: Optional[torch.Tensor] = None,
                  enc_masked_eps: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """txt2img sanity path: generation from pure noise through the
    inpainting UNet under a full repaint mask."""
    S = mods.latent_size
    dev = Prompts.of(embeds).context.device
    return inpaint(mods, embeds, torch.zeros((S, S, 3), device=dev),
                   torch.ones((S, S), device=dev), generator,
                   num_inference_steps=steps, guidance_scale=guidance_scale,
                   strength=1.0, noise=noise, enc_masked_eps=enc_masked_eps)
