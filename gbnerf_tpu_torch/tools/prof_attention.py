"""Times of K7 (csrc/attention.cu) under each launch plan, on one card.

For each self-attention shape of the stage-2 path (the UNet at 64² and 32²
latents, two CFG copies × 8 heads; the VAE's mid block, one 512-wide head),
of colla (the UNet at batch 8) and of the tiny prior (D 16 and 32), and
each plan (wm: 16-row groups a block, up to D 128 four × the consumer
warpgroups of 64 rows of the TMA/wgmma design, two warps a group at D
512; split: key ranges across blocks), one JSON line with the
kernel's attributes (registers, spills, shared memory, stages, keys a
tile) and time
(``ms``: CUDA-event mean over ``--reps`` back-to-back calls after one
warm-up call; ``graph_ms``: the same calls replayed from one CUDA graph,
the host out of the loop), its largest error against ``attention_plain``
and the line's tolerance,
whether ``kernel_plan`` takes the plan, and the time of one
``scaled_dot_product_attention`` call on the same inputs, both ways (the
yardstick; the port never calls it). bf16 inputs, q scaled ×3 for a
peaked softmax, as chip_smoke.py's check.

A last line, ``"shape": "host"``, gives the host's time per call in µs
(the wall clock over ``--host-reps`` calls at [1, 256, 40], where the
kernel takes a few µs): ``flash_fwd``'s and SDPA's.

    python -m gbnerf_tpu_torch.tools.prof_attention [--reps 50]
"""
from __future__ import annotations

import argparse
import json
import time

import torch

# (wm, split) plans: at D ≤ 128 the plan's own (wm 0), two, three and four
# consumer warpgroups of 64 rows where the head dim takes them (wm 8, 12,
# 16; the others are skipped), one to four key ranges; two warps a 16-row
# group at D 512
SMALL_PLANS = ((0, 1), (8, 1), (12, 1), (16, 1), (0, 2), (0, 4))
WIDE_PLANS = ((4, 1), (4, 2), (2, 1), (2, 2), (4, 4))
# (label, BH, N, D, the plans tried)
SHAPES = (("unet 64x64", 16, 4096, 40, SMALL_PLANS),
          ("unet 32x32", 16, 1024, 80, SMALL_PLANS),
          ("colla unet 64x64", 64, 4096, 40, SMALL_PLANS),
          ("colla unet 32x32", 64, 1024, 80, SMALL_PLANS),
          ("prior unet", 32, 1024, 16, SMALL_PLANS),
          ("prior vae", 16, 1024, 32, SMALL_PLANS),
          ("vae mid", 1, 4096, 512, WIDE_PLANS))
ATOL_FRAC = RTOL = 1e-2          # chip_smoke.py's ATTN tolerance
HOST_SHAPE = (1, 256, 40)


def host_us(fn, reps: int) -> float:
    """Wall-clock µs per call of fn() over reps calls ending in a sync."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e6 / reps


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--host-reps", type=int, default=2000)
    args = ap.parse_args(argv)

    from ..ops import attention as at
    from ..utils.profiling import graph_ms, time_ms
    from .prof_field import device_name

    if not torch.cuda.is_available():
        raise SystemExit("prof_attention: K7 runs only on a card and "
                         "torch.cuda.is_available() is False")
    dev = torch.device("cuda:0")
    name = device_name(dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    lines = []
    for label, bh, n, d, plans in SHAPES:
        q, k, v = (torch.randn((bh, n, d), generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        q = q * 3
        scale = d ** -0.5
        ref = at.attention_plain(q, k, v, scale).float()
        atol = ATOL_FRAC * float(ref.abs().max())
        q4, k4, v4 = q[None], k[None], v[None]

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                q4, k4, v4, scale=scale)

        sdpa_ms = time_ms(sdpa, dev, args.reps)
        sdpa_graph_ms = graph_ms(sdpa, dev, args.reps)
        seen = set()
        for plan in map(at.Plan._make, plans):
            try:
                ran = at.kernel_plan(bh, n, d, dev, plan=plan)
            except ValueError:          # a block shape this D does not take
                continue
            if ran in seen:             # wm 0 is one of the others
                continue
            seen.add(ran)
            got = at.flash_fwd(q, k, v, scale, plan=plan).float()
            diff = (got - ref).abs()

            def kernel():
                return at.flash_fwd(q, k, v, scale, plan=plan)

            line = {"shape": label, "bh": bh, "n": n, "d": d,
                    "wm": ran.wm, "split": ran.split,
                    "kernel": at.kernel_info(d, ran.wm if d <= 128 else 0),
                    "ms": time_ms(kernel, dev, args.reps),
                    "graph_ms": graph_ms(kernel, dev, args.reps),
                    "max_abs_err": float(diff.max()), "atol": atol,
                    "in_tolerance": bool((diff <= atol + RTOL * ref.abs())
                                         .all()),
                    "chosen": ran == at.kernel_plan(bh, n, d, dev),
                    "sdpa_ms": sdpa_ms, "sdpa_graph_ms": sdpa_graph_ms,
                    "device": name}
            print(json.dumps(line), flush=True)
            lines.append(line)
    q, k, v = (torch.randn(HOST_SHAPE, generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    q4, k4, v4 = q[None], k[None], v[None]
    line = {"shape": "host", "bh": HOST_SHAPE[0], "n": HOST_SHAPE[1],
            "d": HOST_SHAPE[2],
            "us_per_call": host_us(lambda: at.flash_fwd(q, k, v, 0.125),
                                   args.host_reps),
            "sdpa_us_per_call": host_us(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q4, k4, v4, scale=0.125), args.host_reps),
            "device": name}
    print(json.dumps(line), flush=True)
    lines.append(line)
    return lines


if __name__ == "__main__":
    main()
