"""The port's SDXL-inpainting stack against the plain reference
(benchmark/reference/sdxl.py), on the CPU at a tiny size with the full
model's structure: three levels, the first without attention, transformer
depths [1, 2, 3], heads by level at one head width, Linear projections,
the text-time embedding and two text towers (guidance/stable.py::
tiny_configs("xl")).

Tolerances: both sides compute in float32 and differ only in the order of
their sums, which moves an output by ~1e-7 of its size; each check
allows 1e-4 (a relative gap) and says why where it allows more. Rounding
the products to fp8 (e4m3: 3 mantissa bits) moves them by ~1e-2, and
each check is shown to fail that: the reference rounded to fp8
(reference/sd.py::PRECISION) is held to the same tolerance and must miss
it.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from benchmark.reference import sdxl as ref
from gbnerf_tpu_torch.config import GuidanceConfig
from gbnerf_tpu_torch.guidance import lora, stable
from gbnerf_tpu_torch.guidance.pipeline import inpaint
from gbnerf_tpu_torch.train import lora_trainer as lt

TOL = 1e-4
RES = 64                              # the tiny stack's image size
CFGS = stable.tiny_configs("xl")


def ref_unet_config(u) -> dict:
    return dict(in_channels=u.in_channels, out_channels=u.out_channels,
                block_out_channels=list(u.block_out_channels),
                layers_per_block=u.layers_per_block,
                down_block_types=list(u.down_types),
                up_block_types=["CrossAttnUpBlock2D"
                                if t == "CrossAttnDownBlock2D"
                                else "UpBlock2D"
                                for t in reversed(u.down_types)],
                transformer_layers_per_block=list(
                    u.transformer_layers_per_block),
                attention_head_dim=list(u.attention_head_dim),
                cross_attention_dim=u.cross_attention_dim,
                addition_time_embed_dim=u.addition_time_embed_dim,
                projection_class_embeddings_input_dim=(
                    u.projection_class_embeddings_input_dim))


def ref_text_config(t) -> dict:
    return dict(hidden_size=t.width, intermediate_size=4 * t.width,
                num_hidden_layers=t.layers, num_attention_heads=t.heads,
                max_position_embeddings=t.max_length,
                vocab_size=t.vocab_size, hidden_act=t.hidden_act,
                layer_norm_eps=t.layer_norm_eps,
                projection_dim=t.projection_dim,
                architectures=["CLIPTextModelWithProjection"
                               if t.projection_dim else "CLIPTextModel"])


def xl_gcfg(**kw):
    return dataclasses.replace(GuidanceConfig(), sd_version="xl",
                               prompt="a stone bench", **kw)


def build(seed=0, **kw):
    return stable.build_sd_modules(
        xl_gcfg(**kw), torch.Generator().manual_seed(seed), **CFGS,
        latent_size=RES, dtype=torch.float32)


@pytest.fixture(scope="module")
def stacks():
    """The port's tiny XL stack and the reference's, with its weights
    (loaded by name: the names are the same)."""
    mods = build()
    unet = ref.UNet(ref_unet_config(CFGS["unet_config"]))
    vae = ref.VAE({"block_out_channels": [16, 16, 32, 32],
                   "layers_per_block": 1, "latent_channels": 4})
    t1 = ref.CLIPText(ref_text_config(CFGS["text_config"]))
    t2 = ref.CLIPText(ref_text_config(CFGS["text_config_2"]))
    for r, p in ((unet, mods.unet), (vae, mods.vae), (t1, mods.text_model),
                 (t2, mods.text_model_2)):
        r.load_state_dict(p.state_dict())
        r.requires_grad_(False)
    return mods, (unet, vae, t1, t2)


def gap(a, b) -> float:
    """max |a − b| over max |b|."""
    return float((a - b).abs().max() / b.abs().max())


@pytest.fixture
def fp8():
    ref.PRECISION["products"] = "fp8"
    yield
    ref.PRECISION["products"] = "f32"


def _unet_inputs():
    g = torch.Generator().manual_seed(3)
    lat = RES // 8
    return (torch.randn(2, lat, lat, 9, generator=g),
            torch.tensor([10.0, 700.0]), torch.randn(2, 77, 40, generator=g),
            torch.randn(2, 16, generator=g),
            torch.tensor([[64.0, 64, 0, 0, 64, 64], [96.0, 80, 8, 4, 64,
                                                     64]]))


def test_unet_eps_matches_the_reference(stacks):
    mods, (unet, _, _, _) = stacks
    x, t, ctx, pooled, ids = _unet_inputs()
    with torch.no_grad():
        got = mods.unet(x, t, ctx, {"text_embeds": pooled, "time_ids": ids})
        want = unet(x, t, ctx, pooled, ids)
    assert got.shape == (2, RES // 8, RES // 8, 4) and got.dtype == torch.float32
    assert gap(got, want) <= TOL, gap(got, want)
    # the added conditioning moves ε: a UNet that dropped it would not pass
    with torch.no_grad():
        other = unet(x, t, ctx, pooled * 0, ids * 0)
    assert gap(other, want) > 100 * TOL


def test_unet_eps_tolerance_fails_fp8(stacks, fp8):
    mods, (unet, _, _, _) = stacks
    x, t, ctx, pooled, ids = _unet_inputs()
    with torch.no_grad():
        got = mods.unet(x, t, ctx, {"text_embeds": pooled, "time_ids": ids})
        rounded = unet(x, t, ctx, pooled, ids)
    assert gap(rounded, got) > TOL


def test_unet_refuses_a_call_without_the_added_conditioning(stacks):
    mods, _ = stacks
    x, t, ctx, _, _ = _unet_inputs()
    with pytest.raises(ValueError, match="added_cond"):
        mods.unet(x, t, ctx)


@pytest.mark.parametrize("precision", ["f32", "fp8"])
def test_text_towers_match_the_reference(stacks, precision):
    """The context (each tower's penultimate layer, concatenated) and the
    pooled embedding (tower 2's first EOS through text_projection); the
    reference rounded to fp8 misses the tolerance."""
    mods, (_, _, t1, t2) = stacks
    prompts = ["a stone park bench", "", "view 3 of a bench, front"]
    with torch.no_grad():
        ctx, pooled = mods.encode_prompts(prompts)
        ref.PRECISION["products"] = precision
        try:
            ids = torch.as_tensor(ref.tokenize(prompts, 77, 49408))
            want_ctx, want_pooled = ref.encode_text(t1, t2, ids)
        finally:
            ref.PRECISION["products"] = "f32"
    assert ctx.shape == (3, 77, 16 + 24) and pooled.shape == (3, 16)
    gaps = (gap(ctx, want_ctx), gap(pooled, want_pooled))
    if precision == "f32":
        assert max(gaps) <= TOL, gaps
    else:
        assert max(gaps) > TOL, gaps


def _lora_batch(mods):
    g = torch.Generator().manual_seed(5)
    caps = ["a bench, view 1", "a bench, view 2"]
    with torch.no_grad():
        emb, pooled = mods.encode_prompts(caps)
    mask = torch.zeros(2, RES, RES)
    mask[0, 8:40, 16:56] = 1.0
    mask[1, 20:60, 4:30] = 1.0
    imask = torch.zeros(2, RES, RES)
    imask[:, 24:40, 24:40] = 1.0
    return {"image": torch.randint(0, 256, (2, RES, RES, 3), generator=g,
                                   dtype=torch.uint8),
            "mask": mask, "instance_mask": imask, "embeds": emb,
            "pooled": pooled}


def _draws(step):
    g = torch.Generator().manual_seed(100 + step)
    shape = (2, RES // 8, RES // 8, 4)
    return {"t": torch.randint(0, 1000, (2,), generator=g),
            "noise": torch.randn(shape, generator=g),
            "enc_eps": torch.randn(shape, generator=g),
            "enc_masked_eps": torch.randn(shape, generator=g)}


def _reference_steps(stacks, batch, a_init, rank):
    """Three steps of reference/sdxl.py's loss, one sample at a time, and
    AdamW as train/lora_trainer.py's (lr 1e-4, decay 1e-2) → (losses,
    step 1's gradient by leaf, the change after step 3 by leaf)."""
    mods, (unet, vae, _, _) = stacks
    params = dict(unet.named_parameters())
    ad = {}
    for n in ref.lora_targets(unet):
        ad[n + ".A"] = a_init[n].clone().requires_grad_(True)
        ad[n + ".B"] = torch.zeros((rank, params[n].shape[0]),
                                   requires_grad=True)
    start = {k: v.detach().clone() for k, v in ad.items()}
    m = {k: torch.zeros_like(v) for k, v in ad.items()}
    v2 = {k: torch.zeros_like(v) for k, v in ad.items()}
    ac = torch.as_tensor(ref.alphas_cumprod())
    ids = torch.tensor([RES, RES, 0, 0, RES, RES], dtype=torch.float32)
    losses, grad1 = [], None
    for s in range(1, 4):
        d = _draws(s)
        for v in ad.values():
            v.grad = None
        total = 0.0
        for b in range(2):
            sample = {"image": batch["image"][b], "mask": batch["mask"][b],
                      "instance_mask": batch["instance_mask"][b],
                      "embeds": batch["embeds"][b],
                      "pooled": batch["pooled"][b], "time_ids": ids,
                      "t": d["t"][b], "noise": d["noise"][b],
                      "enc_eps": d["enc_eps"][b],
                      "enc_masked_eps": d["enc_masked_eps"][b]}
            loss = ref.lora_loss(unet, vae, ad, 1.0, sample, ac,
                                 0.13025) / 2
            loss.backward()
            total += float(loss.detach())
        losses.append(total)
        if s == 1:
            grad1 = {k: v.grad.clone() for k, v in ad.items()}
        with torch.no_grad():
            for k, v in ad.items():
                g = v.grad
                v.mul_(1 - 1e-4 * 1e-2)
                m[k].mul_(0.9).add_(g, alpha=0.1)
                v2[k].mul_(0.999).addcmul_(g, g, value=0.001)
                den = (v2[k] / (1 - 0.999 ** s)).sqrt() + 1e-8
                v.sub_(1e-4 * (m[k] / (1 - 0.9 ** s)) / den)
    return losses, grad1, {k: v.detach() - start[k] for k, v in ad.items()}


def _leaf_gap(got, want) -> float:
    """The worst leaf's gap of norms over the larger of its reference
    norm and the median leaf's (benchmark/harness/checks.py's leaf gap)."""
    med = float(np.median([float(v.norm()) for v in want.values()]))
    return max(abs(float(got[k].norm()) - float(want[k].norm()))
               / max(float(want[k].norm()), med, 1e-30) for k in want)


@pytest.mark.parametrize("precision", ["f32", "fp8"])
def test_three_lora_steps_match_the_reference(stacks, precision):
    """make_lora_train_step on the XL stack (the added conditioning, the
    size ids built from the resolution) against the reference's loss and
    AdamW: the three losses, step 1's gradient (AdamW's first moment /
    0.1) and the adapters' change after step 3, leaf by leaf. The change
    is AdamW's ±lr a step for every entry whose gradient's sign holds, so
    its gap is that of the few entries whose gradient is near 0: 1e-3.
    The reference rounded to fp8 misses at least one tolerance."""
    mods, (unet, _, _, _) = stacks
    rank = 4
    path_of = {n: p for p, n in lora.lora_targets(mods.unet).items()}
    assert sorted(path_of) == sorted(ref.lora_targets(unet))
    params = dict(mods.unet.named_parameters())
    g = torch.Generator().manual_seed(9)
    a_init = {n: torch.randn(params[n][0].numel(), rank, generator=g) / 2
              for n in path_of}
    batch = _lora_batch(mods)
    init_fn, step = lt.make_lora_train_step(mods, rank=rank, lr=1e-4,
                                            masked_loss=True)
    ad, opt = init_fn(a_init={path_of[n] + ".lora_A": a
                              for n, a in a_init.items()})
    start = {k: v.detach().clone() for k, v in ad.items()}
    losses, grad1 = [], None
    for s in range(1, 4):
        losses.append(float(step(ad, opt, batch, draws=_draws(s))["loss"]))
        if s == 1:
            grad1 = {k: opt.state[v]["exp_avg"] / 0.1 for k, v in ad.items()}
    change = {k: v.detach() - start[k] for k, v in ad.items()}

    ref.PRECISION["products"] = precision
    try:
        want = _reference_steps(stacks, batch, a_init, rank)
    finally:
        ref.PRECISION["products"] = "f32"

    def by_port(d):
        return {path_of[n] + (".lora_A" if k == "A" else ".lora_B"): v
                for (n, k), v in ((kk.rsplit(".", 1), vv)
                                  for kk, vv in d.items())}

    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, want[0]))
    gaps = (loss_gap, _leaf_gap(grad1, by_port(want[1])),
            _leaf_gap(change, by_port(want[2])))
    if precision == "f32":
        assert gaps[0] <= TOL and gaps[1] <= TOL and gaps[2] <= 1e-3, gaps
        # every step moved the adapters, A too from step 2 on
        assert all(float(v.norm()) > 0 for v in change.values())
    else:
        assert gaps[0] > TOL or gaps[1] > TOL or gaps[2] > 1e-3, gaps


def _recording(mods):
    """Record the added conditioning of every UNet call."""
    seen = []
    forward = mods.unet.forward

    def record(sample, t, ctx, added_cond=None):
        seen.append((sample.shape[0], ctx.shape[0], added_cond))
        return forward(sample, t, ctx, added_cond)

    mods.unet.forward = record
    return seen


@pytest.mark.parametrize("path", ["sds", "csd", "colla", "perpneg",
                                  "normal", "inpaint"])
def test_stage2_and_pipeline_pass_the_added_conditioning(path):
    """Each stage-2 guidance step and the DDIM pipeline on the tiny XL
    stack: it runs, its gradient reaches the render, and every UNet call
    receives the pooled rows of its prompts and the size ids of the
    guidance resolution."""
    kw = {"use_csd": path == "csd", "perpneg": path == "perpneg",
          "is_colla_guidance": path == "colla",
          "is_rgb_guidance": path != "normal",
          "is_normal_guidance": path == "normal", "normal_start_iter": 0,
          "prompt_normal": "a normal map of a bench"}
    mods = build(**kw)
    gcfg = xl_gcfg(**kw)
    seen = _recording(mods)
    g = torch.Generator().manual_seed(4)
    rgb = torch.rand(24, 32, 3, generator=g).requires_grad_(True)
    mask = torch.zeros(24, 32)
    mask[6:18, 8:24] = 1.0
    if path == "inpaint":
        out = inpaint(mods, mods.prompts_rgb, rgb.detach(), mask, g,
                      num_inference_steps=2)
        assert out.shape == (RES, RES, 3) and bool(torch.isfinite(out).all())
    else:
        fn = stable.make_guidance_fn(mods, gcfg)
        colla = {}
        if path == "colla":
            colla = dict(rgbs4=rgb[None].repeat(2, 1, 1, 1),
                         masks4=mask[None].repeat(2, 1, 1))
        loss = fn(5, rgb, rgb if path == "normal" else None, mask, g,
                  **colla)
        (grad,) = torch.autograd.grad(loss, rgb)
        assert bool(torch.isfinite(grad).all()) and float(grad.abs().sum()) > 0
    assert seen
    want_ids = torch.tensor([RES, RES, 0, 0, RES, RES], dtype=torch.float32)
    for batch, rows, added in seen:
        assert added is not None and batch == rows
        assert added["text_embeds"].shape == (rows, 16)
        assert torch.equal(added["time_ids"],
                           want_ids.expand(rows, 6))
    # the DDIM steps; colla runs beside the RGB term
    assert len(seen) == (2 if path in ("inpaint", "colla") else 1)


@pytest.mark.parametrize("version", ["2.1", "3", "1.6", "xl-turbo"])
def test_build_refuses_an_unknown_sd_version(version):
    gcfg = dataclasses.replace(GuidanceConfig(), sd_version=version)
    with pytest.raises(NotImplementedError, match="sd_version"):
        stable.build_sd_modules(gcfg, torch.Generator().manual_seed(0),
                                **stable.tiny_configs(), latent_size=64,
                                dtype=torch.float32)


def test_a_diffusers_layout_xl_state_dict_loads_by_name(tmp_path):
    """A diffusers-layout SDXL directory written from one stack (unet/,
    vae/, text_encoder/ and text_encoder_2/, transformers' position_ids
    buffers among the towers' keys) loads into a stack of other weights
    with every key used (strict) and every value taken."""
    from gbnerf_tpu_torch.guidance.weights import (load_sd_weights,
                                                   write_safetensors)

    src, dst = build(seed=1), build(seed=2)
    parts = {"unet/diffusion_pytorch_model": src.unet,
             "vae/diffusion_pytorch_model": src.vae,
             "text_encoder/model": src.text_model,
             "text_encoder_2/model": src.text_model_2}
    for name, module in parts.items():
        sd = dict(module.state_dict())
        if name.startswith("text"):
            sd["text_model.embeddings.position_ids"] = torch.arange(77)[None]
        os.makedirs(tmp_path / os.path.dirname(name), exist_ok=True)
        write_safetensors(str(tmp_path / (name + ".safetensors")), sd)
    assert any(k.startswith("add_embedding.")
               for k in src.unet.state_dict())
    assert "text_projection.weight" in src.text_model_2.state_dict()
    load_sd_weights(str(tmp_path), dst.unet, dst.vae, dst.text_model,
                    text_2=dst.text_model_2, strict=True)
    for a, b in ((src.unet, dst.unet), (src.vae, dst.vae),
                 (src.text_model, dst.text_model),
                 (src.text_model_2, dst.text_model_2)):
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys()
        assert all(torch.equal(sa[k], sb[k]) for k in sa)


def test_train_lora_cli_trains_the_xl_adapters(tmp_path):
    """``train_lora --sd_version xl --tiny``: the XL UNet's adapters on the
    attention, feed-forward and Linear projections, written once at the
    end; text-encoder adapters are refused under xl."""
    from gbnerf_tpu_torch import train_lora
    from gbnerf_tpu_torch.guidance.weights import read_safetensors
    from gbnerf_tpu_torch.utils.png import write_png

    data = tmp_path / "imgs"
    data.mkdir()
    rng = np.random.default_rng(0)
    for i in range(2):
        write_png(str(data / f"{i}.png"),
                  rng.integers(0, 256, (40, 40, 3), dtype=np.uint8))
        (data / f"{i}.txt").write_text(f"a thing {i}")
    args = ["--instance_data_dir", str(data), "--output_dir",
            str(tmp_path / "out"), "--tiny", "--sd_version", "xl",
            "--max_train_steps", "2", "--train_batch_size", "2",
            "--checkpointing_steps", "2", "--rank", "4", "--device", "cpu"]
    adapters = train_lora.main(args)
    saved = read_safetensors(str(tmp_path / "out" /
                                 "lora_000002.safetensors"))
    assert saved.keys() == adapters.keys()
    names = {k.rsplit(".", 2)[0] for k in saved}
    assert any(n.endswith("proj_in") for n in names)
    assert any(".transformer_blocks_2." in n for n in names)   # depth 3
    assert not any(n.startswith(("down_0_", "up_2_")) for n in names)
    with pytest.raises(SystemExit):
        train_lora.main(args + ["--train_text_encoder"])


def test_published_configs_are_the_benchmark_configuration():
    """build_sd_modules' SDXL defaults (UNetConfig.sdxl_inpaint, the two
    CLIPTextConfigs, VAEConfig.sdxl) are the published config.json values
    that benchmark/configs/sdxl_inpaint.json holds."""
    from benchmark.harness import common
    from gbnerf_tpu_torch.guidance.text import CLIPTextConfig
    from gbnerf_tpu_torch.guidance.unet import UNetConfig
    from gbnerf_tpu_torch.guidance.vae import VAEConfig

    _, config, kind, _ = common.load_cell("sdxl_lora")
    unet, vae, text_1, text_2 = common.traffic_module(kind).port_configs(
        config)
    assert unet == UNetConfig.sdxl_inpaint()
    assert vae == VAEConfig.sdxl()
    assert (text_1, text_2) == (CLIPTextConfig.sdxl_l(),
                                CLIPTextConfig.sdxl_bigg())
