"""Trace the stage-1 train step on one card; summarise its device time.

The twin of tools/prof_train.py: ``make_train_step_stage1`` at its shapes
(CP field, ``cp_bound`` 8, 1024 rays a stream, 64 + 64 samples, lindisp,
white background, ``raw_noise_std`` 1; seeded random banks of 65,536 rays
for the colour and inpainted-depth streams, no COLMAP depth stream;
``--proposal`` gives the coarse field (17, 33, 65) at rank 8), one warm-up
step, then ``--reps`` steps traced with ``utils/profiling.trace`` into
``--out`` and summarised by ``tools/trace_summary`` per step.

    python -m gbnerf_tpu_torch.tools.prof_train [--device cuda|cpu] \\
        [--reps 64] [--proposal] [--out DIR] [--rays 1024] [--bank 65536]
"""
from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np
import torch


def make_bank(rng: np.random.Generator, channels: int, n: int, device):
    o = rng.standard_normal((n, 3)).astype(np.float32) * 0.1
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = rng.random((n, channels)).astype(np.float32)
    return {k: torch.from_numpy(v).to(device)
            for k, v in (("o", o), ("d", d), ("target", t))}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; an error without a card) or cpu")
    ap.add_argument("--out", default=None,
                    help="trace directory (default: a temporary one)")
    ap.add_argument("--reps", type=int, default=64)
    ap.add_argument("--proposal", action="store_true",
                    help="the proposal-style coarse field (bench flagship)")
    ap.add_argument("--rays", type=int, default=1024, help="N_rand")
    ap.add_argument("--bank", type=int, default=65536,
                    help="rays in each random bank")
    args = ap.parse_args(argv)

    from ..config import Config, FieldConfig, RenderConfig, TrainConfig
    from ..train.loop import device_from_flag
    from ..train.state import create_train_state
    from ..train.step import make_train_step_stage1
    from ..utils.profiling import trace
    from .prof_field import device_name
    from .trace_summary import print_summary, summarize

    dev = device_from_flag(args.device)
    field = FieldConfig(no_tcnn=False, field_type="cp", cp_bound=8.0)
    if args.proposal:
        field = FieldConfig(no_tcnn=False, field_type="cp", cp_bound=8.0,
                            cp_resolutions_coarse=(17, 33, 65),
                            cp_rank_coarse=8)
    cfg = Config(field=field,
                 render=RenderConfig(N_samples=64, N_importance=64,
                                     lindisp=True, white_bkgd=True,
                                     raw_noise_std=1.0),
                 train=TrainConfig(N_rand=args.rays))
    state, coarse, fine = create_train_state(
        cfg, torch.Generator().manual_seed(0), dev)
    step = make_train_step_stage1(cfg, coarse, fine, 1.2, 5.3)
    rng = np.random.default_rng(1)
    banks = {"rgb_clf": make_bank(rng, 3, args.bank, dev),
             "inp": make_bank(rng, 1, args.bank, dev), "depth": None}
    gen = torch.Generator(device=dev).manual_seed(3)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    state, m = step(state, banks, gen)                    # warm-up
    print(f"warm, loss: {float(m['loss']):.6g} ({device_name(dev)})")
    t0 = time.perf_counter()
    for _ in range(args.reps):
        state, m = step(state, banks, gen)
    sync()
    untraced_ms = (time.perf_counter() - t0) * 1e3 / args.reps
    with tempfile.TemporaryDirectory() as tmp:
        out = args.out or tmp
        with trace(out):
            for _ in range(args.reps):
                state, m = step(state, banks, gen)
            sync()
        print(f"traced, loss: {float(m['loss']):.6g}; {untraced_ms:.3f} ms "
              f"per step untraced ({args.rays} rays a stream, "
              f"{args.reps} steps)")
        summary = summarize(out, n_calls=args.reps, untraced_ms=untraced_ms)
    print_summary(summary)
    summary["step_ms"] = untraced_ms
    return summary


if __name__ == "__main__":
    main()
