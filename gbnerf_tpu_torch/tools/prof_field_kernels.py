"""Times and checks of the field kernels K1/K2 (forward) and K4/K5
(backward), csrc/field_fused.cu and field_fused_bwd.cu, on one card.

At the main paths' shapes with the shipped config's fields (seeded
random weights, F 80, R_max 257): K1 at a render's fine pass (2,097,152
points) and at a stage-1 step's (131,072, the shape of most of its
launches), K2 at a render's coarse pass (1,048,576) and at a step's
(65,536), K4 at a stage-1 step's fine pass (131,072), K5 at its coarse
pass (65,536). Each under two point
layouts: ``uniform`` (independent points in [0.03, 0.97]³, as
chip_smoke.py's checks) and ``rays`` (consecutive samples along rays, as
the render and training paths lay them out: 128 a ray at the fine pass,
64 at the coarse). One JSON line each: the kernel's time (``ms``: CUDA
events over ``--reps`` back-to-back calls after one warm-up; ``graph_ms``:
the same calls replayed from one CUDA graph), its largest error against
the plain version and the count outside chip_smoke.py's tolerances,
whether two backward calls are bit-equal, a digest of the outputs'
bytes (run in two trees, equal digests mean bit-equal outputs), and the
kernel's registers, spill bytes, shared memory a block and blocks an SM.
The points are not kept off the grid nodes (chip_smoke.py's checks are),
so a few dx entries next to a node, where the kernel's and autograd's
subgradient conventions differ, may count outside the tolerance.

    python -m gbnerf_tpu_torch.tools.prof_field_kernels [--reps 20]
"""
from __future__ import annotations

import argparse
import hashlib
import json
from pathlib import Path

import numpy as np
import torch

FIELD_RTOL, FIELD_ATOL_FRAC = 3e-2, 5e-3     # chip_smoke.py's tolerances
DX_RTOL, DX_ATOL_FRAC = 5e-2, 8e-3
# (kernel, field, points, samples a ray, backward, sigma_only)
CASES = (("field_fused", "fine", 16384 * 128, 128, False, False),
         ("field_fused", "fine", 1024 * 128, 128, False, False),
         ("field_fused_sigma", "coarse", 16384 * 64, 64, False, True),
         ("field_fused_sigma", "coarse", 1024 * 64, 64, False, True),
         ("field_fused_bwd", "fine", 1024 * 128, 128, True, False),
         ("field_fused_bwd_sigma", "coarse", 1024 * 64, 64, True, True))


def points(layout: str, n: int, samples: int, rng) -> np.ndarray:
    """[n, 3] points in [0.03, 0.97]³: independent, or rays of samples."""
    if layout == "uniform":
        return (0.03 + 0.94 * rng.random((n, 3))).astype(np.float32)
    o = 0.3 + 0.4 * rng.random((n // samples, 1, 3))
    d = rng.standard_normal((n // samples, 1, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = np.linspace(0.0, 0.25, samples)[None, :, None]
    return (o + d * t).reshape(n, 3).astype(np.float32)


def compare(got, ref, rtol, atol_frac) -> dict:
    diff = (got - ref).abs()
    atol = atol_frac * max(float(ref.abs().max()), 1e-3)
    return {"max_abs_err": float(diff.max()),
            "n_out_of_tol": int((diff > atol + rtol * ref.abs()).sum())}


def digest(tensors) -> str:
    """A hash of the tensors' bytes: equal digests across two trees on the
    same inputs (this tool's seeded draws) mean bit-equal outputs."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)

    from ..config import load_reference_config
    from ..core.encoding import sh_encode
    from ..ops import field_fused as ff
    from ..ops.cp_pallas import upsample_lines
    from ..train.state import create_params
    from ..utils.profiling import graph_ms, time_ms
    from .prof_field import device_name

    if not torch.cuda.is_available():
        raise SystemExit("prof_field_kernels: K1/K2/K4/K5 run only on a "
                         "card and torch.cuda.is_available() is False")
    dev = torch.device("cuda:0")
    name = device_name(dev)
    root = Path(__file__).resolve().parents[2]
    cfg = load_reference_config(str(root / "configs" / "spinnerf_scene.txt"))
    fields = dict(zip(("coarse", "fine"), create_params(
        cfg, torch.Generator().manual_seed(0), dev)))
    rng = np.random.default_rng(0)
    out = []
    for kernel, field, n, samples, backward, sigma_only in CASES:
        f = fields[field]
        ul = upsample_lines([l.detach() for l in f.lines()],
                            max(f.resolutions))
        Ws = {k: getattr(f, k).detach()
              for k in ff.W_KEYS[:2 if sigma_only else 5]}
        info = ff.kernel_info(backward=backward, sigma_only=sigma_only,
                              r_max=ul.shape[1], feat=ul.shape[2])
        for layout in ("uniform", "rays"):
            x = torch.from_numpy(points(layout, n, samples, rng)).to(dev)
            d = torch.from_numpy(rng.standard_normal((n, 3)).astype(
                np.float32)).to(dev)
            sh = None if sigma_only else sh_encode(
                d / d.norm(dim=-1, keepdim=True)).contiguous()
            r = {"kernel": kernel, "layout": layout, "points": n,
                 "F": ul.shape[2], "R_max": ul.shape[1], "device": name}
            if backward:
                g = torch.from_numpy(rng.standard_normal((n, 4)).astype(
                    np.float32)).to(dev)
                call = lambda: ff.field_fused_bwd(         # noqa: E731
                    x, sh, ul, Ws, g, sigma_only=sigma_only)
                got, again = call(), call()
                ref = ff.field_bwd_plain(x, sh, ul, Ws, g,
                                         sigma_only=sigma_only)
                flat = lambda t: [v for v in t[:3] if v is not None] + [
                    t[3][k] for k in Ws]                   # noqa: E731
                r["deterministic"] = all(torch.equal(a, b) for a, b in
                                         zip(flat(got), flat(again)))
                r["digest"] = digest(flat(got))
                names = ["dx"] + ([] if sigma_only else ["dsh"]) + [
                    "dulines"] + ["d" + k for k in Ws]
                for nm, a, b in zip(names, flat(got), flat(ref)):
                    r[nm] = (compare(a, b, DX_RTOL, DX_ATOL_FRAC)
                             if nm == "dx" else
                             compare(a, b, FIELD_RTOL, FIELD_ATOL_FRAC))
                del got, again, ref
            else:
                call = lambda: ff.cp_field_fused(          # noqa: E731
                    x, sh, ul, Ws, sigma_only=sigma_only)
                with torch.no_grad():
                    raw = call()
                    r["raw"] = compare(raw, ff.field_plain(
                        x, sh, ul, Ws, sigma_only=sigma_only), FIELD_RTOL,
                        FIELD_ATOL_FRAC)
                    r["digest"] = digest([raw])
            with torch.no_grad():
                r["ms"] = time_ms(call, dev, args.reps)
                r["graph_ms"] = graph_ms(call, dev, args.reps)
            r.update(info)
            print(json.dumps(r), flush=True)
            out.append(r)
    return out


if __name__ == "__main__":
    main()
