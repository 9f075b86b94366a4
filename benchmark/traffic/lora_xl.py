"""Traffic kind "lora_xl": the DreamBooth-inpaint LoRA fine-tune of the
SDXL-inpainting UNet, a closed loop of steps as train_lora runs them under
``--sd_version xl``.

As traffic/lora.py, on SDXL's stack: set-up builds the port's UNet, VAE and
both text towers with the benchmark's seeded weights, writes the seeded
instance data at the cell's resolution, and makes one training object
(the adapters, AdamW and make_lora_train_step's step), driven through its
first three steps, whose losses, first gradient (AdamW's first moment
after step 1) and adapters after step 3 are kept. The window runs the same
loop: on the host, the dataset's batch of images, random masks and
captions, and both text towers on the captions (the context and the
pooled embedding); on the card, the step, with the configuration's size
and crop ids. ``lora_step_ms`` is the window over the steps it completed.
The window's steps are counted by ops/attention.py's routing counter
(``readings.routes``: self-attention calls a step by route and head
width).

After the window the program's state is freed and the plain reference
(reference/sdxl.py) follows the first three steps from the same weights,
adapters, host draws and device draws, one sample at a time.
"""
from __future__ import annotations

import os
import time

import numpy as np

from benchmark.harness import checks as ck
from benchmark.harness.common import span, sub_seed, traffic_module
from benchmark.inputs import lora_data

_lora = traffic_module("lora")
adapter_init, _port_module, _ref_module = (
    _lora.adapter_init, _lora._port_module, _lora._ref_module)


def _with_projection(tc: dict) -> bool:
    return "CLIPTextModelWithProjection" in tc.get("architectures", ())


def port_configs(c: dict):
    """The port's (UNetConfig, VAEConfig, CLIPTextConfig × 2) of a
    configuration file."""
    from gbnerf_tpu_torch.guidance.text import CLIPTextConfig
    from gbnerf_tpu_torch.guidance.unet import UNetConfig
    from gbnerf_tpu_torch.guidance.vae import VAEConfig

    uc, vc = c["unet"], c["vae"]
    ucfg = UNetConfig(
        in_channels=uc["in_channels"], out_channels=uc["out_channels"],
        block_out_channels=tuple(uc["block_out_channels"]),
        layers_per_block=uc["layers_per_block"],
        attention_head_dim=tuple(uc["attention_head_dim"]),
        cross_attention_dim=uc["cross_attention_dim"],
        down_types=tuple(uc["down_block_types"]),
        transformer_layers_per_block=tuple(
            uc["transformer_layers_per_block"]),
        use_linear_projection=uc["use_linear_projection"],
        addition_embed_type=uc["addition_embed_type"],
        addition_time_embed_dim=uc["addition_time_embed_dim"],
        projection_class_embeddings_input_dim=uc[
            "projection_class_embeddings_input_dim"],
        layer_norm_eps=uc["norm_eps"], gelu_approximate="none")
    vcfg = VAEConfig(block_out_channels=tuple(vc["block_out_channels"]),
                     layers_per_block=vc["layers_per_block"],
                     latent_channels=vc["latent_channels"],
                     scaling_factor=vc["scaling_factor"])

    def text(tc):
        return CLIPTextConfig(
            vocab_size=tc["vocab_size"],
            max_length=tc["max_position_embeddings"],
            width=tc["hidden_size"], layers=tc["num_hidden_layers"],
            heads=tc["num_attention_heads"], hidden_act=tc["hidden_act"],
            layer_norm_eps=tc["layer_norm_eps"], output="penultimate",
            projection_dim=(tc["projection_dim"] if _with_projection(tc)
                            else 0))

    return ucfg, vcfg, text(c["text_encoder"]), text(c["text_encoder_2"])


def _routes() -> dict:
    """The routing counter's counts, {"route/head width": calls}; {} where
    the program has no such counter."""
    from gbnerf_tpu_torch.ops import attention

    routes = getattr(attention, "ROUTES", None)
    return {} if routes is None else {f"{r}/{d}": n
                                      for (r, d), n in sorted(routes.items())}


def run(ctx) -> dict:
    import torch

    from gbnerf_tpu_torch.guidance import lora
    from gbnerf_tpu_torch.guidance.schedule import DiffusionSchedule
    from gbnerf_tpu_torch.guidance.stable import SDModules
    from gbnerf_tpu_torch.guidance.text import CLIPTextEncoder, Tokenizer
    from gbnerf_tpu_torch.guidance.unet import UNet2DCondition
    from gbnerf_tpu_torch.guidance.vae import AutoencoderKL
    from gbnerf_tpu_torch.ops import attention
    from gbnerf_tpu_torch.train import lora_trainer as lt

    c, p, dev, seed = ctx.config, ctx.params, ctx.device, ctx.seed
    L = c["lora"]
    dtype = getattr(torch, c["sd_dtype"])
    tdtype = getattr(torch, c["text_dtype"])
    B, res, rank = L["train_batch_size"], L["resolution"], L["rank"]

    # ---- the port's stack with the benchmark's weights
    ucfg, vcfg, tcfg1, tcfg2 = port_configs(c)
    unet = _port_module(lambda: UNet2DCondition(ucfg), sub_seed(seed, 0),
                        dtype, dev)
    vae = _port_module(lambda: AutoencoderKL(vcfg), sub_seed(seed, 1),
                       dtype, dev)
    text1 = _port_module(lambda: CLIPTextEncoder(tcfg1), sub_seed(seed, 2),
                         tdtype, dev)
    text2 = _port_module(lambda: CLIPTextEncoder(tcfg2), sub_seed(seed, 7),
                         tdtype, dev)
    tok = Tokenizer(None, max_length=tcfg1.max_length,
                    vocab_size=tcfg1.vocab_size)
    mods = SDModules(unet=unet, vae=vae, schedule=DiffusionSchedule.sd_v1(),
                     embeds_rgb=torch.empty(0), embeds_normal=torch.empty(0),
                     latent_size=res, text_model=text1, tokenizer=tok,
                     text_model_2=text2, tokenizer_2=tok,
                     time_ids=torch.tensor(L["time_ids"], dtype=torch.float32,
                                           device=dev))
    ctx.mark("the stack")

    # ---- the instance data, written for the port's dataset
    data_dir = os.path.join(ctx.scratch, "lora_data")
    images, inst_masks, captions = lora_data.make(
        data_dir, p["n_images"], res, sub_seed(seed, 3))
    ds = lt.DreamBoothInpaintDataset(
        os.path.join(data_dir, "images"),
        mask_dir=os.path.join(data_dir, "masks"), resolution=res,
        default_caption=lora_data.PROMPT)
    ctx.mark("the instance data")

    # ---- one training object, driven through its first steps
    params = dict(unet.named_parameters())
    path_of = {name: path for path, name in lora.lora_targets(unet).items()}
    targets = {name: params[name][0].numel() for name in path_of}
    a0 = adapter_init(targets, rank, sub_seed(seed, 4), dev)
    init_fn, step = lt.make_lora_train_step(
        mods, rank=rank, lr=L["learning_rate"], masked_loss=L["masked_loss"])
    adapters, opt = init_fn(None, a_init={path_of[n] + ".lora_A": a
                                          for n, a in a0.items()})
    host_rng = np.random.default_rng(sub_seed(seed, 5))
    gen = torch.Generator(device=dev).manual_seed(sub_seed(seed, 6))

    def dev_(a):
        return torch.as_tensor(a, device=dev)

    def one_step():
        with span("batch"):
            imgs, masks, caps, imasks = ds.batch(host_rng, B)
            batch = {"image": dev_(imgs), "mask": dev_(masks),
                     "instance_mask": dev_(imasks)}
            with torch.no_grad():
                batch["embeds"], batch["pooled"] = mods.encode_prompts(caps)
        with span("step"):
            return step(adapters, opt, batch, gen)

    p0 = {k: v.detach().clone() for k, v in adapters.items()}
    losses = [one_step()["loss"]]
    g1 = ck.norms({k: ck.first_moment(opt, v) / 0.1
                   for k, v in adapters.items()})
    losses += [one_step()["loss"] for _ in range(2)]
    d3 = ck.norms({k: v.detach() - p0[k] for k, v in adapters.items()})
    losses = [float(x) for x in losses]
    del p0
    ctx.mark("the first three steps")

    # ---- the window, its self-attention calls counted by route
    out = {"attempted": 0, "failed": 0, "end_to_end": {}, "work": {}}
    routes = getattr(attention, "ROUTES", None)
    if routes is not None:
        routes.clear()
    t0 = ctx.window_opens()
    if ctx.trace:
        n = p["trace_steps"]
        ctx.traced(lambda: [one_step() for _ in range(n)])
        counted = n
    else:
        n = 0
        while True:
            one_step()
            n += 1
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        t1 = ctx.window_closes()
        out["end_to_end"]["lora_step_ms"] = (t1 - t0) * 1e3 / n
        counted = n
    step_routes = {k: v / counted for k, v in _routes().items()}
    out["attempted"] = n
    out["work"]["steps"] = n
    ctx.read_memory_peak()
    del adapters, opt, step, init_fn, mods, unet, vae, text1, text2
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # ---- the reference follows the first three steps
    ref = follow(c, seed, a0, images, inst_masks, captions, p, dev, steps=3)
    got_g, got_d = {}, {}
    for name in a0:
        path = path_of[name]
        for part, suf in (("A", ".lora_A"), ("B", ".lora_B")):
            got_g[f"{name}.{part}"] = g1[path + suf]
            got_d[f"{name}.{part}"] = d3[path + suf]
    out["checks"], out["readings"] = ck.training_checks(
        losses, got_g, got_d, ref, p["limits"])
    out["readings"]["routes"] = step_routes
    if ctx.trace:
        from benchmark.counts import sdxl as counts

        out["work"]["flops"] = n * counts.lora_step_flops(c)
        out["work"]["k7_calls"] = counts.long_self_attention(c, B)
    return out


def _ref_stack(c: dict, seed: int, dev):
    """The reference's UNet, VAE and text towers with the run's weights."""
    import torch

    from benchmark.reference import sdxl as ref

    dtype = getattr(torch, c["sd_dtype"])
    unet = _ref_module(lambda: ref.UNet(c["unet"]), sub_seed(seed, 0),
                       dtype, dev)
    vae = _ref_module(lambda: ref.VAE(c["vae"]), sub_seed(seed, 1), dtype,
                      dev)
    text1 = _ref_module(lambda: ref.CLIPText(c["text_encoder"]),
                        sub_seed(seed, 2), None, dev)
    text2 = _ref_module(lambda: ref.CLIPText(c["text_encoder_2"]),
                        sub_seed(seed, 7), None, dev)
    return unet, vae, text1, text2


def follow(c: dict, seed: int, a0: dict, images, inst_masks, captions,
           p: dict, dev, steps: int = 3, precision: str = "f32") -> dict:
    """The reference's first ``steps`` steps from the run's inputs →
    {losses, grad_norms (a dict a step, by leaf), change_norms}."""
    import torch

    from benchmark.harness.common import no_tf32
    from benchmark.reference import sdxl as ref

    vc, tc, L = c["vae"], c["text_encoder"], c["lora"]
    B, res, rank = L["train_batch_size"], L["resolution"], L["rank"]
    ref.PRECISION["products"] = precision
    try:
        with no_tf32():
            unet, vae, text1, text2 = _ref_stack(c, seed, dev)
            params, ad = dict(unet.named_parameters()), {}
            for n, a in a0.items():
                ad[n + ".A"] = a.clone().float().requires_grad_(True)
                ad[n + ".B"] = torch.zeros((rank, params[n].shape[0]),
                                           device=dev, requires_grad=True)
            start = {k: v.detach().clone() for k, v in ad.items()}
            m = {k: torch.zeros_like(v) for k, v in ad.items()}
            v2 = {k: torch.zeros_like(v) for k, v in ad.items()}
            ac = torch.as_tensor(ref.alphas_cumprod(), device=dev)
            time_ids = torch.tensor(L["time_ids"], dtype=torch.float32,
                                    device=dev)
            host = np.random.default_rng(sub_seed(seed, 5))
            gen = torch.Generator(device=dev).manual_seed(sub_seed(seed, 6))
            lr, wd = L["learning_rate"], L["weight_decay"]
            b1, b2, eps = 0.9, 0.999, 1e-8
            lat = res // 8
            losses, grads = [], []
            for s in range(1, steps + 1):
                idx, masks = lora_data.batch_draws(host, len(images), B, res)
                t = torch.randint(0, 1000, (B,), generator=gen, device=dev)
                shape = (B, lat, lat, vc["latent_channels"])
                noise = torch.randn(shape, generator=gen, device=dev)
                e1 = torch.randn(shape, generator=gen, device=dev)
                e2 = torch.randn(shape, generator=gen, device=dev)
                with torch.no_grad():
                    ids = torch.as_tensor(ref.tokenize(
                        [captions[i] for i in idx],
                        tc["max_position_embeddings"], tc["vocab_size"]),
                        device=dev)
                    emb, pooled = ref.encode_text(text1, text2, ids)
                for v in ad.values():
                    v.grad = None
                total = 0.0
                for b in range(B):
                    sample = {"image": torch.as_tensor(images[idx[b]],
                                                       device=dev),
                              "mask": torch.as_tensor(masks[b], device=dev),
                              "instance_mask": torch.as_tensor(
                                  inst_masks[idx[b]], device=dev),
                              "embeds": emb[b], "pooled": pooled[b],
                              "time_ids": time_ids, "t": t[b],
                              "noise": noise[b], "enc_eps": e1[b],
                              "enc_masked_eps": e2[b]}
                    loss = ref.lora_loss(unet, vae, ad, L["lora_alpha"] / rank,
                                         sample, ac, vc["scaling_factor"]) / B
                    loss.backward()
                    total += float(loss.detach())
                losses.append(total)
                grads.append(ck.norms({k: v.grad for k, v in ad.items()}))
                with torch.no_grad():       # AdamW, decoupled decay
                    for k, v in ad.items():
                        g = v.grad
                        v.mul_(1 - lr * wd)
                        m[k].mul_(b1).add_(g, alpha=1 - b1)
                        v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                        den = (v2[k] / (1 - b2 ** s)).sqrt() + eps
                        v.sub_(lr * (m[k] / (1 - b1 ** s)) / den)
            change = ck.norms({k: v.detach() - start[k]
                               for k, v in ad.items()})
    finally:
        ref.PRECISION["products"] = "f32"
    return {"losses": losses, "grad_norms": grads, "change_norms": change}


def control(ctx, precision: str = "fp8"):
    """The control: the reference in a lower precision than the
    configuration's (bf16 → fp8 e4m3) put in the program's place, held
    against the reference by the run's own checks → (checks, readings)."""
    import torch

    from benchmark.reference import sdxl as ref

    c, p, dev, seed = ctx.config, ctx.params, ctx.device, ctx.seed
    L = c["lora"]
    images, inst_masks, captions = lora_data.make(
        os.path.join(ctx.scratch, "lora_data"), p["n_images"],
        L["resolution"], sub_seed(seed, 3))
    with torch.device("meta"):
        unet = ref.UNet(c["unet"])
    params = dict(unet.named_parameters())
    targets = {n: params[n][0].numel() for n in ref.lora_targets(unet)}
    a0 = adapter_init(targets, L["rank"], sub_seed(seed, 4), dev)
    want = follow(c, seed, a0, images, inst_masks, captions, p, dev)
    got = follow(c, seed, a0, images, inst_masks, captions, p, dev,
                 precision=precision)
    return ck.training_checks(got["losses"], got["grad_norms"][0],
                              got["change_norms"], want, p["limits"])
