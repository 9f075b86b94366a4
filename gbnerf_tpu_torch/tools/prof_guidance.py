"""Profile of the full-size SD guidance step's components on one card.

The twin of tools/prof_guidance.py: the SD1.5-inpainting stack (UNet,
VAE, CLIP text) built on the card in bf16 from seeded random weights (no
weights are needed: the shapes are the real ones), then one JSON line per
component, each naming the device, in ms (CUDA-event means over ``--reps``
calls after one warm-up call):

  full_guidance_step_fwd+bwd  ``sd_train_step`` in CSD mode (the JAX
                              script's) on a 512² render and a random mask,
                              with the gradient to the render
  unet_fwd_B3                 the UNet alone, 3 CFG copies at 64² latents
  vae_encode_fwd_B1           the VAE encode of one 512² image
  vae_encode_fwd+bwd_B1       the same with its gradient to the image

Self-attention runs K7 (csrc/attention.cu) in the UNet at 64² and 32²
latents and in the VAE's mid block. ``--tiny`` builds the tiny f32 stack
at ``--size`` (for CPU runs; ``--device cpu`` times with the host clock).

    python -m gbnerf_tpu_torch.tools.prof_guidance [--device cuda|cpu] \\
        [--reps 8] [--tiny --size 64]
"""
from __future__ import annotations

import argparse
import json
import time

import torch


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; an error without a card) or cpu")
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--tiny", action="store_true",
                    help="the tiny f32 SD stack (tests, CPU runs)")
    ap.add_argument("--size", type=int, default=512,
                    help="render/latent-input size (latents size/8)")
    args = ap.parse_args(argv)

    from ..config import GuidanceConfig
    from ..guidance import build_sd_modules
    from ..guidance.stable import sd_train_step
    from ..guidance.text import CLIPTextConfig
    from ..guidance.unet import UNetConfig
    from ..guidance.vae import VAEConfig
    from ..train.loop import device_from_flag
    from ..utils.profiling import time_ms
    from .prof_field import device_name

    dev = device_from_flag(args.device)
    name, reps, S = device_name(dev), args.reps, args.size
    lines = []

    def emit(**kw):
        line = {**kw, "device": name}
        print(json.dumps(line), flush=True)
        lines.append(line)

    gcfg = GuidanceConfig()
    gen = torch.Generator(device=dev).manual_seed(0)
    kw = dict(latent_size=S, device=dev, dtype=torch.bfloat16)
    if args.tiny:
        kw.update(unet_config=UNetConfig.tiny(), vae_config=VAEConfig.tiny(),
                  text_config=CLIPTextConfig(vocab_size=49408, width=32,
                                             layers=2, heads=2),
                  dtype=torch.float32)
    t0 = time.perf_counter()
    mods = build_sd_modules(gcfg, gen, **kw)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    emit(stage="built", s=time.perf_counter() - t0,
         stack="tiny" if args.tiny else "SD1.5-inpaint")

    rgb = torch.rand((S, S, 3), generator=gen, device=dev)
    mask = (torch.rand((S, S), generator=gen, device=dev) > 0.7).float()

    # full step: loss and its gradient to the render (training cost)
    def full():
        r = rgb.detach().requires_grad_(True)
        loss = sd_train_step(mods, gcfg, 1000, r, mask, gen,
                             embeds=mods.embeds_rgb, guidance_scale=7.5,
                             mode="csd")
        torch.autograd.grad(loss, r)

    emit(comp="full_guidance_step_fwd+bwd", ms=time_ms(full, dev, reps))

    # the UNet alone: 3 CFG copies, 9 input channels
    lr = mods.latent_res
    lat = torch.randn((3, lr, lr, 9), generator=gen, device=dev)
    with torch.no_grad():
        emit(comp="unet_fwd_B3", ms=time_ms(
            lambda: mods.unet(lat, 500.0, mods.embeds_rgb), dev, reps))

    img = torch.rand((1, S, S, 3), generator=gen, device=dev)
    eps = torch.randn((1, lr, lr, mods.vae.config.latent_channels),
                      generator=gen, device=dev)
    with torch.no_grad():
        emit(comp="vae_encode_fwd_B1", ms=time_ms(
            lambda: mods.vae.encode(img * 2 - 1, eps), dev, reps))

    def vae_fb():
        x = img.detach().requires_grad_(True)
        z = mods.vae.encode(x * 2 - 1, eps)
        torch.autograd.grad(z.float().sum(), x)

    emit(comp="vae_encode_fwd+bwd_B1", ms=time_ms(vae_fb, dev, reps))
    return lines


if __name__ == "__main__":
    main()
