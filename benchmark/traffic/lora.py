"""Traffic kind "lora": the DreamBooth-inpaint LoRA fine-tune of the SD
UNet, a closed loop of steps as train_lora runs them.

Set-up builds the port's UNet, VAE and text tower with the benchmark's
seeded weights, writes the seeded instance data, and makes one training
object (the adapters, AdamW and make_lora_train_step's step). It drives
that object through its first three steps, the window's own call and feed
on batches that all differ, and keeps their losses, the first gradient
(from AdamW's first moment after step 1) and the adapters after step 3.
The window then runs the same loop: on the host, the dataset's batch of
images, random masks and captions, and the text tower on the captions;
on the card, the step. ``lora_step_ms`` is the window over the steps it
completed.

After the window the program's state is freed and the plain reference
(reference/sd.py) follows the first three steps from the same weights,
adapters, host draws and device draws, one sample at a time.
"""
from __future__ import annotations

import os
import time

import numpy as np

from benchmark.harness import checks as ck
from benchmark.harness.common import span, sub_seed
from benchmark.inputs import lora_data
from benchmark.harness import weights as wt


def _port_module(ctor, seed, dtype, dev):
    import torch

    with torch.device("meta"):
        m = ctor()
    m = m.to_empty(device=dev)
    wt.fill(m, seed, dtype)
    return m.to(dtype).eval().requires_grad_(False)


def _ref_module(ctor, seed, dtype, dev):
    import torch

    with torch.device("meta"):
        m = ctor()
    m = m.to_empty(device=dev)
    wt.fill(m, seed, dtype)              # the served rounding, held in f32
    return m.float().eval().requires_grad_(False)


def adapter_init(targets, rank: int, seed: int, dev):
    """A [fan-in, r] ~ N(0, 1/r) of every adapted weight, in one draw:
    {port name: A}, in sorted-name order."""
    import torch

    names = sorted(targets)
    fans = [targets[n] for n in names]
    g = torch.Generator(device=dev).manual_seed(seed)
    flat = torch.randn(sum(fans) * rank, generator=g, device=dev) / rank ** 0.5
    out, off = {}, 0
    for n, f in zip(names, fans):
        out[n] = flat[off:off + f * rank].view(f, rank).clone()
        off += f * rank
    return out


def run(ctx) -> dict:
    import torch

    from gbnerf_tpu_torch.guidance import lora
    from gbnerf_tpu_torch.guidance.schedule import DiffusionSchedule
    from gbnerf_tpu_torch.guidance.stable import SDModules
    from gbnerf_tpu_torch.guidance.text import (CLIPTextConfig,
                                                CLIPTextEncoder, Tokenizer)
    from gbnerf_tpu_torch.guidance.unet import UNet2DCondition, UNetConfig
    from gbnerf_tpu_torch.guidance.vae import AutoencoderKL, VAEConfig
    from gbnerf_tpu_torch.train import lora_trainer as lt

    c, p, dev, seed = ctx.config, ctx.params, ctx.device, ctx.seed
    uc, vc, tc, L = c["unet"], c["vae"], c["text_encoder"], c["lora"]
    dtype = getattr(torch, c["sd_dtype"])
    B, res, rank = L["train_batch_size"], L["resolution"], L["rank"]

    # ---- the port's stack with the benchmark's weights
    ucfg = UNetConfig(in_channels=uc["in_channels"],
                      out_channels=uc["out_channels"],
                      block_out_channels=tuple(uc["block_out_channels"]),
                      layers_per_block=uc["layers_per_block"],
                      attention_head_dim=uc["attention_head_dim"],
                      cross_attention_dim=uc["cross_attention_dim"],
                      down_types=tuple(uc["down_block_types"]))
    vcfg = VAEConfig(block_out_channels=tuple(vc["block_out_channels"]),
                     layers_per_block=vc["layers_per_block"],
                     latent_channels=vc["latent_channels"])
    tcfg = CLIPTextConfig(vocab_size=tc["vocab_size"],
                          max_length=tc["max_position_embeddings"],
                          width=tc["hidden_size"],
                          layers=tc["num_hidden_layers"],
                          heads=tc["num_attention_heads"])
    unet = _port_module(lambda: UNet2DCondition(ucfg), sub_seed(seed, 0),
                        dtype, dev)
    vae = _port_module(lambda: AutoencoderKL(vcfg), sub_seed(seed, 1),
                       dtype, dev)
    text = _port_module(lambda: CLIPTextEncoder(tcfg), sub_seed(seed, 2),
                        torch.float32, dev)
    tok = Tokenizer(None, max_length=tcfg.max_length,
                    vocab_size=tcfg.vocab_size)
    mods = SDModules(unet=unet, vae=vae, schedule=DiffusionSchedule.sd_v1(),
                     embeds_rgb=torch.empty(0), embeds_normal=torch.empty(0),
                     latent_size=res, text_model=text, tokenizer=tok)
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
                batch["embeds"] = text(dev_(tok(caps)))
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

    # ---- the window
    out = {"attempted": 0, "failed": 0, "end_to_end": {}, "work": {}}
    t0 = ctx.window_opens()
    if ctx.trace:
        n = p["trace_steps"]
        ctx.traced(lambda: [one_step() for _ in range(n)])
    else:
        n = 0
        while True:
            one_step()
            n += 1
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        t1 = ctx.window_closes()
        out["end_to_end"]["lora_step_ms"] = (t1 - t0) * 1e3 / n
    out["attempted"] = n
    out["work"]["steps"] = n
    ctx.read_memory_peak()
    del adapters, opt, step, init_fn, mods, unet, vae, text
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # ---- the reference follows the first three steps
    ref = follow(c, seed, a0, images, inst_masks, captions, p, dev, steps=3)
    key = {n: path_of[n] for n in a0}
    got_g = {}
    got_d = {}
    for name, path in key.items():
        for part, suf in (("A", ".lora_A"), ("B", ".lora_B")):
            got_g[f"{name}.{part}"] = g1[path + suf]
            got_d[f"{name}.{part}"] = d3[path + suf]
    out["checks"], out["readings"] = ck.training_checks(
        losses, got_g, got_d, ref, p["limits"])
    if ctx.trace:
        from benchmark.counts import sd as sd_counts

        out["work"]["flops"] = n * sd_counts.lora_step_flops(c)
        out["work"]["k7_calls"] = sd_counts.long_self_attention(c, B)
    return out


def follow(c: dict, seed: int, a0: dict, images, inst_masks, captions,
           p: dict, dev, steps: int = 3, precision: str = "f32") -> dict:
    """The reference's first ``steps`` steps from the run's inputs →
    {losses, grad_norms (a dict a step, by leaf), change_norms}."""
    import torch

    from benchmark.harness.common import no_tf32
    from benchmark.reference import sd as ref

    uc, vc, tc, L = c["unet"], c["vae"], c["text_encoder"], c["lora"]
    dtype = getattr(torch, c["sd_dtype"])
    B, res, rank = L["train_batch_size"], L["resolution"], L["rank"]
    ref.PRECISION["products"] = precision
    try:
        with no_tf32():
            unet = _ref_module(lambda: ref.UNet(uc), sub_seed(seed, 0),
                               dtype, dev)
            vae = _ref_module(lambda: ref.VAE(vc), sub_seed(seed, 1), dtype,
                              dev)
            text = _ref_module(lambda: ref.CLIPText(tc), sub_seed(seed, 2),
                               None, dev)
            params, ad = dict(unet.named_parameters()), {}
            for n, a in a0.items():
                ad[n + ".A"] = a.clone().float().requires_grad_(True)
                ad[n + ".B"] = torch.zeros((rank, params[n].shape[0]),
                                           device=dev, requires_grad=True)
            start = {k: v.detach().clone() for k, v in ad.items()}
            m = {k: torch.zeros_like(v) for k, v in ad.items()}
            v2 = {k: torch.zeros_like(v) for k, v in ad.items()}
            ac = torch.as_tensor(ref.alphas_cumprod(), device=dev)
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
                    emb = text(torch.as_tensor(ref.tokenize(
                        [captions[i] for i in idx],
                        tc["max_position_embeddings"], tc["vocab_size"]),
                        device=dev))
                for v in ad.values():
                    v.grad = None
                total = 0.0
                for b in range(B):
                    sample = {"image": torch.as_tensor(images[idx[b]],
                                                       device=dev),
                              "mask": torch.as_tensor(masks[b], device=dev),
                              "instance_mask": torch.as_tensor(
                                  inst_masks[idx[b]], device=dev),
                              "embeds": emb[b], "t": t[b],
                              "noise": noise[b], "enc_eps": e1[b],
                              "enc_masked_eps": e2[b]}
                    loss = ref.lora_loss(unet, vae, ad, L["lora_alpha"] / rank,
                                         sample, ac) / B
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

    from benchmark.reference import sd as ref

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
