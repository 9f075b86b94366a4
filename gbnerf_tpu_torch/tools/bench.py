"""Render-throughput benchmark of the port: rays/s on one card.

The twin of bench.py, at its workload (bench.py:42-65): the ``Config()``
defaults with the CP field, its coarse field proposal-style ((17, 33, 65)
at rank 8; the fine field the default 17…257 at rank 16), 64 + 64
samples a ray, lindisp, a white background, near 1.2 and far 5.3; the
fields from ``create_params`` with a torch generator seeded 0; 16384
rays, origins seeded Gaussians × 0.1 and directions normalised Gaussians
from a torch generator seeded 1 (JAX's key-1 draws are not replayed).

    python -m gbnerf_tpu_torch.tools.bench [--device cuda|cpu]

Timing: a loop is 128 eval renders (``train=False``) of the loop-variant
origins ro + i·1e-6, each adding sum(rgb)·1e-9 into one device scalar,
so no render can be skipped. One loop warms up; then the best of 3 timed
loops, each between CUDA events and ended by fetching that scalar
(``.item()``). bench.py keeps its loop inside one ``jit``; here the 128
renders are issued eagerly from Python, so the host's launches are part
of the figure (the render leaves the card idle most of its time).

Output: a line with the ms per render, the three loop times and the
K1/K2/K3 launches of one render; then, as the last line, one JSON object
with bench.py's keys: ``metric`` (render_throughput), ``value`` (rays/s),
``unit`` (rays/sec/chip) and ``vs_baseline``, null: bench.py divides by a
TPU chip's target, and no baseline for the card exists yet. On ``--device
cpu`` the loops are timed by the host's clock (the kernels' plain
versions; not a figure of the card). Without a card the default exits 1
with a message naming ``--device cpu``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

N_RAYS, REPS, LOOPS = 16384, 128, 3
NEAR, FAR = 1.2, 5.3
KERNELS = ("field_fused", "field_fused_sigma", "merge128")   # K1, K2, K3


def bench_config():
    """bench.py's Config: the defaults, the CP field with the
    proposal-style coarse field, 64 + 64 samples, lindisp, white
    background."""
    from ..config import Config, FieldConfig, RenderConfig

    return Config(
        field=FieldConfig(no_tcnn=False, field_type="cp",
                          cp_resolutions_coarse=(17, 33, 65),
                          cp_rank_coarse=8),
        render=RenderConfig(N_samples=64, N_importance=64, lindisp=True,
                            white_bkgd=True))


def build(cfg_overrides=None, device=None):
    """→ (cfg, render, coarse, fine): bench_config() with
    ``cfg_overrides`` ({section: {field: value}}) replaced into it, its
    fields made by ``create_params`` from a generator seeded 0 on
    ``device``, and the eval render between NEAR and FAR."""
    from ..train.state import create_params
    from ..train.step import make_render_fn

    cfg = bench_config()
    for section, kv in (cfg_overrides or {}).items():
        cfg = dataclasses.replace(cfg, **{section: dataclasses.replace(
            getattr(cfg, section), **kv)})
    coarse, fine = create_params(cfg, torch.Generator().manual_seed(0),
                                 device)
    return cfg, make_render_fn(cfg, coarse, fine, near=NEAR, far=FAR), \
        coarse, fine


def rays(n: int, generator: torch.Generator, device=None):
    """n rays → (origins [n, 3], unit directions [n, 3]) on ``device``,
    drawn on the CPU from ``generator`` (the same rays on any device)."""
    ro = torch.randn(n, 3, generator=generator) * 0.1
    rd = torch.randn(n, 3, generator=generator)
    rd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    return ro.to(device), rd.to(device)


def launch_counts() -> dict:
    """The K1, K2 and K3 launch counters of the ops (cumulative)."""
    from ..ops import field_fused as ff
    from ..ops import resample as rs

    counts = {**ff.LAUNCHES, **rs.LAUNCHES}
    return {k: counts[k] for k in KERNELS}


def one_render_launches(render, ro, rd) -> dict:
    """K1/K2/K3 launches of one eval render of (ro, rd)."""
    before = launch_counts()
    with torch.no_grad():
        render(ro, rd, train=False)
    return {k: v - before[k] for k, v in launch_counts().items()}


def run(render, ro, rd, reps: int = REPS, loops: int = LOOPS) -> dict:
    """One warm-up loop, then ``loops`` timed loops of ``reps`` renders →
    {"loop_s": [...], "best_s", "ms_per_render", "rays_per_s",
    "checksum"}. On the card each loop is timed by CUDA events and ended
    by the scalar's ``.item()``; on the CPU by the host's clock."""
    cuda = ro.device.type == "cuda"

    def loop():
        acc = torch.zeros((), device=ro.device)
        for i in range(reps):
            out = render(ro + i * 1e-6, rd, train=False)
            acc = acc + out.rgb.sum() * 1e-9
        return acc

    loop_s, checksum = [], None
    with torch.no_grad():
        loop().item()
        for _ in range(loops):
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                acc = loop()
                end.record()
                checksum = acc.item()
                loop_s.append(start.elapsed_time(end) / 1e3)
            else:
                t0 = time.perf_counter()
                checksum = loop().item()
                loop_s.append(time.perf_counter() - t0)
    best = min(loop_s)
    return {"loop_s": loop_s, "best_s": best,
            "ms_per_render": best / reps * 1e3,
            "rays_per_s": ro.shape[0] * reps / best, "checksum": checksum}


def result_line(res: dict) -> dict:
    """bench.py's JSON keys for a ``run`` result."""
    return {"metric": "render_throughput",
            "value": round(res["rays_per_s"], 1),
            "unit": "rays/sec/chip", "vs_baseline": None}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; an error without a card) or cpu")
    args = ap.parse_args(argv)

    from ..train.loop import device_from_flag

    dev = device_from_flag(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    _, render, _, _ = build(None, dev)
    ro, rd = rays(N_RAYS, torch.Generator().manual_seed(1), dev)
    one = one_render_launches(render, ro, rd)
    res = run(render, ro, rd)
    print(f"bench: {N_RAYS} rays x {REPS} renders on {name}: "
          f"{res['ms_per_render']:.4f} ms per render (best of "
          f"{LOOPS} loops: {', '.join(f'{s:.4f}' for s in res['loop_s'])} "
          f"s); launches of one render {json.dumps(one)}", flush=True)
    line = result_line(res)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
