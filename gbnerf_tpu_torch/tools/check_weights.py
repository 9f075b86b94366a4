"""Real-weights first-contact check of the port's SD stack.

The twin of tools/check_weights.py, on the port's modules: the one
command to run the day real checkpoints arrive.

    python -m gbnerf_tpu_torch.tools.check_weights SD_DIR \\
        [--lora LORA_DIR] [--vgg VGG16.npz] [--tiny] [--latent_size 512] \\
        [--allow_hash_tokenizer] [--device cuda|cpu]

What it proves, in order (any failure prints CHECK FAILED and exits 1):
  1. every tensor of SD_DIR's unet/, vae/ and text_encoder/ matches a
     parameter of the port's UNet, VAE and CLIP text tower
     (load_sd_weights strict: no unmatched key, no missing parameter),
     and every parameter of each tower was overwritten (none left at its
     random init);
  2. tokenizer/ loads as a real CLIP BPE vocab (no hash fallback);
  3. an optional PEFT LoRA dir merges into the UNet as it loads;
  4. a 2-step DDIM inpaint runs through the loaded weights (text tower,
     UNet, VAE) and gives finite pixels;
  5. an optional VGG16 npz (python -m gbnerf_tpu_torch.tools.convert_vgg)
     loads and one LPIPS forward is finite.

--tiny takes the tiny topology of the port's fake checkpoint (python -m
gbnerf_tpu_torch.tools.make_fake_sd_ckpt D --tiny; f32, latent 64);
otherwise the SD1.5-inpainting widths in bf16 (that tool without --tiny
writes them). Runs on the first CUDA device unless --device cpu. main()
returns the seconds of the strict load (``load_s``, the towers' random
init excluded) and of the 2-step inpaint (``ddim_s``).
"""
from __future__ import annotations

import argparse
import os
import time


def fail(msg: str):
    print(f"CHECK FAILED: {msg}")
    raise SystemExit(1)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("sd_dir", help="diffusers-layout SD-inpaint ckpt dir")
    ap.add_argument("--lora", default=None, help="PEFT LoRA checkpoint dir")
    ap.add_argument("--lora_rank", type=int, default=32)
    ap.add_argument("--vgg", default=None, help="VGG16 npz (LPIPS)")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny topology (the fake checkpoint's)")
    ap.add_argument("--latent_size", type=int, default=512)
    ap.add_argument("--prompt", default="a stone park bench")
    ap.add_argument("--allow_hash_tokenizer", action="store_true",
                    help="accept a missing tokenizer/ dir (fake ckpts)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; an error without a card) or cpu")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from ..guidance.pipeline import inpaint
    from ..guidance.schedule import DiffusionSchedule
    from ..guidance.stable import SDModules, _build
    from ..guidance.text import CLIPTextConfig, CLIPTextEncoder, Tokenizer
    from ..guidance.unet import UNet2DCondition, UNetConfig
    from ..guidance.vae import AutoencoderKL, VAEConfig
    from ..guidance.weights import load_sd_weights
    from ..train.loop import device_from_flag

    device = device_from_flag(args.device)
    if args.tiny:
        ucfg, vcfg = UNetConfig.tiny(), VAEConfig.tiny()
        tcfg = CLIPTextConfig(vocab_size=49408, width=32, layers=2, heads=2)
        latent_size, dtype = 64, torch.float32
    else:
        ucfg, vcfg, tcfg = (UNetConfig.sd15_inpaint(), VAEConfig(),
                            CLIPTextConfig())
        latent_size, dtype = args.latent_size, torch.bfloat16

    for sub in ("unet", "vae", "text_encoder"):
        if not os.path.isdir(os.path.join(args.sd_dir, sub)):
            fail(f"{args.sd_dir} has no {sub}/ subdir — not a diffusers-"
                 "layout checkpoint")

    # ---- 1. random towers, a strict load, every parameter overwritten
    gen = torch.Generator(device=device).manual_seed(0)
    towers = {"unet": _build(lambda: UNet2DCondition(ucfg), gen, device,
                             dtype),
              "vae": _build(lambda: AutoencoderKL(vcfg), gen, device, dtype),
              "text": _build(lambda: CLIPTextEncoder(tcfg), gen, device,
                             torch.float32)}
    init = {name: {k: p.detach().clone() for k, p in m.named_parameters()}
            for name, m in towers.items()}
    t0 = time.perf_counter()
    try:
        load_sd_weights(args.sd_dir, towers["unet"], towers["vae"],
                        towers["text"], lora_dir=args.lora,
                        lora_rank=args.lora_rank, strict=True)
    except ValueError as e:
        fail(f"unmatched checkpoint keys: {e}")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    times = {"load_s": time.perf_counter() - t0}
    for name, m in towers.items():
        total = len(init[name])
        changed = sum(not torch.equal(init[name][k], p.detach())
                      for k, p in m.named_parameters())
        if changed != total:
            fail(f"{name}: only {changed}/{total} parameters overwritten by "
                 "the checkpoint — coverage hole")
        print(f"[check] {name}: {total}/{total} parameters loaded")
    del init

    # ---- 2. the tokenizer must be the real BPE
    tok_dir = os.path.join(args.sd_dir, "tokenizer")
    if os.path.isdir(tok_dir):
        tok = Tokenizer(tok_dir, max_length=tcfg.max_length,
                        vocab_size=tcfg.vocab_size)   # raises on a bad dir
        ids = tok([args.prompt])
        print(f"[check] tokenizer: real CLIP BPE, '{args.prompt}' → "
              f"{int((ids[0] != tok.eos).sum())} tokens")
    elif args.allow_hash_tokenizer:
        tok = Tokenizer(None, max_length=tcfg.max_length,
                        vocab_size=tcfg.vocab_size)
        print("[check] tokenizer: hash fallback ACCEPTED (--allow_hash_"
              "tokenizer; never use for a real distillation run)")
    else:
        fail(f"{args.sd_dir} has no tokenizer/ dir; a real checkpoint "
             "ships one (pass --allow_hash_tokenizer only for fake ckpts)")

    # ---- 3 + 4. a 2-step inpaint through the loaded weights
    with torch.no_grad():
        embeds = towers["text"](tok(["", "", args.prompt]))
    if not bool(torch.isfinite(embeds).all()):
        fail("text embeddings contain non-finite values")
    mods = SDModules(unet=towers["unet"], vae=towers["vae"],
                     schedule=DiffusionSchedule.sd_v1(), embeds_rgb=embeds,
                     embeds_normal=embeds, latent_size=latent_size)
    S = latent_size
    img = torch.full((S, S, 3), 0.5, device=device)
    mask = torch.zeros((S, S), device=device)
    mask[S // 4: 3 * S // 4, S // 4: 3 * S // 4] = 1.0
    t0 = time.perf_counter()
    out = inpaint(mods, embeds, img, mask,
                  torch.Generator(device=device).manual_seed(1),
                  num_inference_steps=2).cpu().numpy()
    times["ddim_s"] = time.perf_counter() - t0
    if not np.isfinite(out).all():
        fail("denoise step produced non-finite pixels")
    print(f"[check] denoise: 2-step inpaint OK, output {out.shape}, "
          f"range [{out.min():.3f}, {out.max():.3f}], "
          f"{times['ddim_s']:.3f} s (strict load {times['load_s']:.3f} s)")

    # ---- 5. an optional LPIPS forward
    if args.vgg:
        from ..utils.lpips import LPIPS, load_vgg16_npz

        lp = LPIPS(weights=load_vgg16_npz(args.vgg), device=device)
        with torch.no_grad():
            d = float(lp(torch.zeros((1, 64, 64, 3), device=device),
                         torch.full((1, 64, 64, 3), 0.5, device=device))[0])
        if not np.isfinite(d):
            fail("LPIPS forward is non-finite")
        print(f"[check] LPIPS: vgg weights loaded, d(gray, black)={d:.4f}")

    print("PASS: checkpoint is fully mapped and runnable "
          f"({args.sd_dir}{' + ' + args.lora if args.lora else ''})")
    return times


if __name__ == "__main__":
    main()
