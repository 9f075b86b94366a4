"""CLI entry of the port: train or render a scene with gbnerf_tpu_torch.

The twin of the repository's run.py (same config files, same overrides):

    python -m gbnerf_tpu_torch.run --config configs/scene1.txt \\
        --set train.first_stage=True
    python -m gbnerf_tpu_torch.run --config configs/scene1.txt \\
        --set train.N_iters=2000 --set render.N_samples=64
    python -m gbnerf_tpu_torch.run --config configs/scene1.txt --render_only
    python -m gbnerf_tpu_torch.run --config configs/scene1.txt --device cpu

It runs on the first CUDA device (``--device cuda``, the default) and
exits with an error when there is none: it never falls back to the CPU by
itself. ``--device cpu`` runs on the CPU, where every kernel runs its plain
PyTorch version. Scenes (``dataset_type`` llff, nerd, blender or dtu)
are read from PNGs without imageio; other image formats need it. Stage 2
(``first_stage = False``) guides with the SD1.5-inpainting stack from
``guidance.sd_weights_dir`` (a local diffusers-layout checkpoint), or with
random weights under ``guidance.sd_tiny`` / ``guidance.sd_allow_random``.

Under torchrun it trains data-parallel, one rank a device (with
``guidance.tp`` > 1 in stage 2, the SD towers tensor-parallel too);
``--dist_backend`` picks the process group's backend (nccl by default on
the card, gloo on the CPU; gloo on the card lets several ranks share one):

    python -m torch.distributed.run --nproc_per_node 4 \
        -m gbnerf_tpu_torch.run --config configs/scene1.txt
    python -m torch.distributed.run --nproc_per_node 2 \
        -m gbnerf_tpu_torch.run --config configs/scene1.txt \
        --dist_backend gloo                    # two ranks on one card
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys


def parse_overrides(cfg, pairs):
    """``--set section.field=value`` pairs → a new Config (run.py's rules:
    the value takes the type of the field it replaces)."""
    sections = {}
    for pair in pairs or []:
        key, _, value = pair.partition("=")
        if "." not in key or not value:
            raise SystemExit(f"--set expects section.field=value, got: {pair!r}")
        section, fname = key.split(".", 1)
        try:
            sub = getattr(cfg, section)
            cur = getattr(sub, fname)
        except AttributeError:
            raise SystemExit(f"unknown config key: {key}")
        if isinstance(cur, bool):
            val = value in ("True", "true", "1")
        elif isinstance(cur, int):
            val = int(value)
        elif isinstance(cur, float):
            val = float(value)
        else:
            val = value
        sections.setdefault(section, {})[fname] = val
    return dataclasses.replace(cfg, **{
        s: dataclasses.replace(getattr(cfg, s), **kv)
        for s, kv in sections.items()
    })


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", required=True, help="config txt (reference format)")
    p.add_argument("--set", action="append", metavar="section.field=value",
                   help="override a config field (repeatable)")
    p.add_argument("--render_only", action="store_true",
                   help="skip training; render the test poses (PNGs) and "
                        "the path (maps and a GIF) from the latest "
                        "checkpoint")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; an error without a card) or cpu "
                        "(the kernels' plain versions)")
    p.add_argument("--dist_backend", default=None,
                   help="under torchrun: nccl (the default on the card) or "
                        "gloo (the default on the CPU; on the card it lets "
                        "ranks share a card)")
    args = p.parse_args(argv)

    from gbnerf_tpu_torch.config import load_reference_config
    cfg = load_reference_config(args.config)
    cfg = parse_overrides(cfg, args.set)
    if args.render_only:
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, render_only=True))
    if not cfg.data.datadir or not os.path.isdir(cfg.data.datadir):
        raise SystemExit(f"datadir does not exist: {cfg.data.datadir!r}")

    import torch

    from gbnerf_tpu_torch.parallel.mesh import (init_distributed, rank,
                                                world_size)
    from gbnerf_tpu_torch.train.loop import (device_from_flag, render_only,
                                             train)
    device = init_distributed(device_from_flag(args.device),
                              args.dist_backend)
    print(f"[device] {device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else "")
          + (f" rank {rank()} of {world_size()} "
             f"({torch.distributed.get_backend()})"
             if torch.distributed.is_initialized() else ""))
    if cfg.train.render_only:
        if rank() == 0:          # one rank renders: nothing to split
            render_only(cfg, device=device)
    else:
        train(cfg, device=device)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
