#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gbnerf_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                  # from the root of a checkout
    python3 chip_smoke.py --profile DIR    # also trace one render (torch.profiler)

1. Requires CUDA (exits nonzero without it) and prints the card's name and
   power limit.
2. Builds the CUDA kernels from gbnerf_tpu_torch/csrc (ops/_build.py).
3. Holds each kernel against its plain PyTorch version on the card, at the
   shapes the render path gives it (and once at a ragged size), and times
   both with CUDA events.
4. Drives the eval render path at the full width of configs/spinnerf_scene.txt
   (CP fields 17…257 at rank 16, 64 + 64 samples, lindisp, white background)
   with seeded random weights: (a) bench.py's workload, 16384 rays, for
   rays/s; (b) three full 189 × 252 views through render_pose_path. It
   checks that every map is finite with acc in [0, 1], that every kernel was
   launched by that run, and that the path agrees with the plain path
   (the same fields on the CPU) on a subset of rays.

Every failure raises, so the script exits nonzero. The last line is
{"ok": true, "device": {...}}; the line before it holds one JSON object
with each kernel's launches, error and times.
"""
from __future__ import annotations

import argparse
import copy
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# Kernel checks: |kernel − plain| ≤ atol + rtol·|plain| elementwise with
# atol = ATOL_FRAC·max|plain| — the field's bf16 tolerance of the JAX
# package's own kernel tests (tests/test_field_bwd.py::_close): both sides
# round every matmul operand to bf16 and accumulate in f32, but sum in
# another order, which can flip one bf16 rounding of a hidden activation.
# The merge is a permutation and must be exact.
FIELD_RTOL, FIELD_ATOL_FRAC = 3e-2, 5e-3
# Slice vs the plain path (the same fields on the CPU), absolute, on maps
# of O(1) values: as tests/test_torch_render.py, for the same reason, and
# because the flip moves σ and, through the resampling, the fine samples.
MAP_ATOL = {"rgb": 5e-3, "acc": 5e-3, "depth": 2e-2, "disp": 2e-2}
ACC_SLACK = 1e-5        # Σ weights may pass 1 by f32 rounding

BENCH_RAYS, NEAR, FAR = 16384, 1.2, 5.3      # bench.py's workload
VIEW_H, VIEW_W, N_VIEWS = 189, 252, 3         # factor-4 SPIn-NeRF views
SUBSET_RAYS = 256
DEVICE = "cuda:0"


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def compare_field(got, ref) -> dict:
    diff = (got - ref).abs()
    atol = FIELD_ATOL_FRAC * float(ref.abs().max())
    bad = diff > atol + FIELD_RTOL * ref.abs()
    return {"max_abs_err": float(diff.max()),
            "max_rel_err": float((diff / ref.abs().clamp_min(atol)).max()),
            "n_out_of_tol": int(bad.sum()), "atol": atol}


def check_fields(dev, fine, coarse, proposal, np_rng):
    """K1 at fine shapes, K2 at coarse and at proposal-coarse shapes."""
    from gbnerf_tpu_torch.core.encoding import sh_encode
    from gbnerf_tpu_torch.ops import field_fused as ff
    from gbnerf_tpu_torch.ops.cp_pallas import upsample_lines

    def operands(field, n):
        ul = upsample_lines([l.detach() for l in field.lines()],
                            max(field.resolutions))
        Ws = {k: getattr(field, k).detach() for k in ff.W_KEYS}
        x = torch.from_numpy(np_rng.random((n, 3), dtype=np.float32)).to(dev)
        d = np_rng.standard_normal((n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        sh = sh_encode(torch.from_numpy(d).to(dev)).contiguous()
        return x, sh, ul, Ws

    results = {}
    cases = [("field_fused", "fine", fine, BENCH_RAYS * 128, False),
             ("field_fused_sigma", "coarse", coarse, BENCH_RAYS * 64, True),
             ("field_fused_sigma", "proposal", proposal, BENCH_RAYS * 64,
              True)]
    for name, label, field, n, sigma_only in cases:
        for ragged in (False, True):
            m = n - 29 if ragged else n
            x, sh, ul, Ws = operands(field, m)
            sh = None if sigma_only else sh
            got = ff.cp_field_fused(x, sh, ul, Ws, sigma_only=sigma_only)
            ref = ff.field_plain(x, sh, ul, Ws, sigma_only=sigma_only)
            torch.cuda.synchronize()
            r = compare_field(got, ref)
            r.update(points=m, F=ul.shape[2], R_max=ul.shape[1])
            if sigma_only:
                assert bool((got[:, :3] == 0).all()), f"{name}: rgb not zero"
            if not ragged:
                r["ms"] = cuda_ms(lambda: ff.cp_field_fused(
                    x, sh, ul, Ws, sigma_only=sigma_only), reps=10)
                r["plain_ms"] = cuda_ms(lambda: ff.field_plain(
                    x, sh, ul, Ws, sigma_only=sigma_only), reps=3)
            print(f"check {name} [{label}{' ragged' if ragged else ''}] "
                  f"{json.dumps(r)}")
            if r["n_out_of_tol"]:
                raise AssertionError(
                    f"{name} [{label}]: {r['n_out_of_tol']} values outside "
                    f"rtol {FIELD_RTOL}, atol {FIELD_ATOL_FRAC}·max|plain|")
            results.setdefault(name, []).append(r)
    return results


def check_merge(dev, np_rng):
    """K3 at [16384, 128] (and ragged), exact, with ties across halves."""
    from gbnerf_tpu_torch.ops import resample as rs

    results = []
    for rows in (BENCH_RAYS, BENCH_RAYS - 5):
        a = np.broadcast_to(np.sort(NEAR + (FAR - NEAR) * np_rng.random(64)),
                            (rows, 64))
        b = np.sort(NEAR + (FAR - NEAR) * np_rng.random((rows, 64)), -1)
        b[::7, 10] = a[::7, 11]                   # ties across the halves
        b[::7] = np.sort(b[::7], -1)
        x = torch.from_numpy(np.concatenate([a, b], -1).astype(np.float32))
        x = x.to(dev).contiguous()
        got = rs.merge128(x, 64)
        ref = rs.merge128_plain(x, 64)
        torch.cuda.synchronize()
        r = {"rows": rows, "max_abs_err": float((got - ref).abs().max()),
             "exact": bool(torch.equal(got, ref))}
        if rows == BENCH_RAYS:
            r["ms"] = cuda_ms(lambda: rs.merge128(x, 64), reps=20)
            r["plain_ms"] = cuda_ms(lambda: rs.merge128_plain(x, 64), reps=20)
        print(f"check merge128 {json.dumps(r)}")
        if not r["exact"]:
            raise AssertionError("merge128 differs from the stable sort")
        results.append(r)
    return results


def camera_arc(n: int, radius: float = 4.0) -> np.ndarray:
    """n camera-to-world poses [n, 3, 4] on an arc, looking at the origin
    (OpenGL: x right, y up, the camera looks down −z)."""
    poses = []
    for th in np.linspace(-0.4, 0.4, n):
        eye = np.array([radius * np.sin(th), 0.5, radius * np.cos(th)])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(fwd, [0.0, 1.0, 0.0])
        right /= np.linalg.norm(right)
        up = np.cross(right, fwd)
        poses.append(np.stack([right, up, -fwd, eye], 1))
    return np.stack(poses).astype(np.float32)


def profile_render(render, ro, rd, outdir: Path, untraced_ms: float) -> None:
    """Trace one bench render; print device time by kernel, and the device's
    idle share of the untraced render time (ms per render from "bench")."""
    from torch.profiler import ProfilerActivity, profile

    outdir.mkdir(parents=True, exist_ok=True)
    with torch.no_grad():
        render(ro, rd, train=False)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            render(ro, rd, train=False)
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(str(outdir / "render_trace.json"))
    # device-side events only (kernels, copies): the aten ops above them
    # carry the same time again
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    print(f"profile: device busy {busy_ms:.3f} ms in {len(rows)} kernel "
          f"kinds, {sum(e.count for e in rows)} launches; render "
          f"{untraced_ms:.3f} ms untraced ({traced_ms:.3f} traced): idle "
          f"share {1 - busy_ms / untraced_ms:.3f}")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"profile:   {e.self_device_time_total / 1e3:9.3f} ms "
              f"x{e.count:<4d} {e.key[:100]}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", type=Path, default=None,
                    help="trace one bench render into this directory")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this check needs an NVIDIA GPU")
    if not (ROOT / "gbnerf_tpu_torch" / "csrc").is_dir():
        raise SystemExit(f"chip_smoke: no gbnerf_tpu_torch/ beside {ROOT}; "
                         "run it from the root of a checkout")
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from gbnerf_tpu_torch.config import load_reference_config
    from gbnerf_tpu_torch.core.cp_field import CPGridField
    from gbnerf_tpu_torch.ops import _build
    from gbnerf_tpu_torch.ops import field_fused as ff
    from gbnerf_tpu_torch.ops import resample as rs
    from gbnerf_tpu_torch.train.eval import render_pose_path, save_maps
    from gbnerf_tpu_torch.train.state import create_params
    from gbnerf_tpu_torch.train.step import make_render_fn

    smi = nvidia_smi_line()
    dev = torch.device(DEVICE)
    print(f"card: {smi} | torch {torch.__version__} cuda {torch.version.cuda}")

    # ---- 1. build
    t0 = time.perf_counter()
    lib = _build.build_library()
    _build.load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc "
          f"{_build.build_seconds if _build.build_seconds is not None else 0.0:.2f} s) "
          f"-> {lib.relative_to(ROOT)}")
    for line in _build.ptxas_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas: {line.strip()}")

    # ---- 2. fields of the shipped config, seeded
    cfg = load_reference_config(str(ROOT / "configs" / "spinnerf_scene.txt"))
    coarse, fine = create_params(cfg, torch.Generator().manual_seed(0), dev)
    proposal = CPGridField(bound=cfg.field.cp_bound, resolutions=(17, 33, 65),
                           rank=8, device=dev,
                           generator=torch.Generator().manual_seed(1))
    np_rng = np.random.default_rng(0)

    # ---- 3. each kernel vs its plain version, at main-path shapes
    with torch.no_grad():
        field_res = check_fields(dev, fine, coarse, proposal, np_rng)
        merge_res = check_merge(dev, np_rng)

    # ---- 4. the main path: launches counted from here ...
    render = make_render_fn(cfg, coarse, fine, near=NEAR, far=FAR)
    rng = np.random.default_rng(1)
    ro_np = (rng.standard_normal((BENCH_RAYS, 3)) * 0.1).astype(np.float32)
    rd_np = rng.standard_normal((BENCH_RAYS, 3)).astype(np.float32)
    rd_np /= np.linalg.norm(rd_np, axis=-1, keepdims=True)
    ro, rd = torch.from_numpy(ro_np).to(dev), torch.from_numpy(rd_np).to(dev)
    for counts in (ff.LAUNCHES, rs.LAUNCHES):
        for k in counts:
            counts[k] = 0
    with torch.no_grad():
        # (a) bench.py's workload
        out = render(ro, rd, train=False)                  # warm
        torch.cuda.synchronize()
        group_ms = []                 # host time shares its cores: 5 groups
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(5):
                out = render(ro, rd, train=False)
            torch.cuda.synchronize()
            group_ms.append((time.perf_counter() - t0) * 1e3 / 5)
    ms = float(np.median(group_ms))
    rays_per_s = BENCH_RAYS / (ms / 1e3)
    print(f"bench: {BENCH_RAYS} rays, 64+64 samples, fields "
          f"{cfg.field.cp_resolutions} r{cfg.field.cp_rank}: {ms:.3f} ms "
          f"per render (median of 5 groups of 5: "
          f"{', '.join(f'{g:.3f}' for g in group_ms)}), {rays_per_s:.1f} "
          f"rays/s")
    for k in ("rgb", "acc", "depth", "disp"):
        t = getattr(out, k)
        assert bool(torch.isfinite(t).all()), f"bench {k} not finite"

    # (b) full views through render_pose_path at the config's render_block
    focal = 0.5 * VIEW_W / np.tan(0.5 * np.deg2rad(60.0))
    poses = camera_arc(N_VIEWS)
    render_pose_path(render, poses[:1], (VIEW_H, VIEW_W, focal),
                     block=cfg.render.render_block, device=dev)   # warm
    t0 = time.perf_counter()
    maps = render_pose_path(render, poses, (VIEW_H, VIEW_W, focal),
                            block=cfg.render.render_block, device=dev)
    view_ms = (time.perf_counter() - t0) * 1e3 / N_VIEWS
    launches = {**ff.LAUNCHES, **rs.LAUNCHES}
    # ... to here
    print(f"views: {N_VIEWS} x {VIEW_H}x{VIEW_W} at render_block "
          f"{cfg.render.render_block}: {view_ms:.3f} ms per image "
          f"(maps to host included)")
    print(f"launches on the main path: {json.dumps(launches)}")
    for k, v in maps.items():
        assert np.isfinite(v).all(), f"view {k} not finite"
    assert maps["rgb"].shape == (N_VIEWS, VIEW_H, VIEW_W, 3)
    acc_lo, acc_hi = float(maps["acc"].min()), float(maps["acc"].max())
    print(f"views: acc in [{acc_lo:.6f}, {acc_hi:.6f}], rgb in "
          f"[{maps['rgb'].min():.4f}, {maps['rgb'].max():.4f}], depth mean "
          f"{maps['depth'].mean():.4f}")
    assert acc_lo >= 0.0 and acc_hi <= 1.0 + ACC_SLACK, "acc outside [0, 1]"
    with tempfile.TemporaryDirectory() as tmp:
        for k, p in save_maps(maps, tmp).items():
            assert np.array_equal(np.load(p), maps[k]), f"{k}.npy round trip"
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"kernel {k} was not launched by the path")

    # (c) the path vs the plain path (same fields on the CPU), ray subset
    sub = slice(0, SUBSET_RAYS)
    with torch.no_grad():
        got = render(ro[sub], rd[sub], train=False)
        cpu_render = make_render_fn(cfg, copy.deepcopy(coarse).cpu(),
                                    copy.deepcopy(fine).cpu(), NEAR, FAR)
        ref = cpu_render(torch.from_numpy(ro_np[sub]),
                         torch.from_numpy(rd_np[sub]), train=False)
    slice_err = {}
    for k, atol in MAP_ATOL.items():
        d = (getattr(got, k).cpu() - getattr(ref, k)).abs()
        slice_err[k] = {"max_abs_err": float(d.max()),
                        "mean_abs_err": float(d.mean()), "atol": atol}
    print(f"slice vs plain ({SUBSET_RAYS} rays): {json.dumps(slice_err)}")
    for k, e in slice_err.items():
        if e["max_abs_err"] > e["atol"]:
            raise AssertionError(f"slice {k} differs from the plain path by "
                                 f"{e['max_abs_err']} > {e['atol']}")

    if args.profile is not None:
        profile_render(render, ro, rd, args.profile, ms)

    kernels = [
        {"name": "field_fused", "route": "cuda",
         "source": "gbnerf_tpu_torch/csrc/field_fused.cu",
         "replaces": "gbnerf_tpu/ops/field_fused.py:131"},
        {"name": "field_fused_sigma", "route": "cuda",
         "source": "gbnerf_tpu_torch/csrc/field_fused.cu",
         "replaces": "gbnerf_tpu/ops/field_fused.py:247"},
        {"name": "merge128", "route": "cuda",
         "source": "gbnerf_tpu_torch/csrc/resample.cu",
         "replaces": "gbnerf_tpu/ops/resample.py:154"},
    ]
    for k in kernels:
        checks = merge_res if k["name"] == "merge128" else field_res[k["name"]]
        main = checks[0]                          # the main-path shape
        k.update(launches=launches[k["name"]],
                 max_abs_err=max(c["max_abs_err"] for c in checks),
                 ms=main["ms"], plain_ms=main["plain_ms"])
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
