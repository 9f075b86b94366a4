"""Component profile of the render path and the encode variants on one card.

The twin of tools/prof_field.py, at its workload: the full eval render of
16384 rays (CP fields 17…257 at rank 16, 64 + 64 samples, lindisp, white
background, near 1.2, far 5.3) and its parts at the fine pass's 128 points
a ray, with seeded random fields and inputs. One JSON line per component,
each naming the device, under the JAX script's names where the meaning
carries over:

  full_render          the render (K1, K2, K3), M rays/s
  encode_dense_plain   ``encode_plain`` (the JAX script's encode_dense_xla)
  encode_dense_kernel  K6 through ``cp_encode_unified`` (encode_dense_pallas)
  encode_kr            the KR-factorised encode (one-hot segment ⊗ 17-tap
                       triangle → [N, 272] @ [272, F]), plain, bf16 products
  mlp_heads            the σ and colour heads alone, ``torch.matmul`` in
                       bf16 (plain products, outside any kernel, as in the
                       JAX script)
  resample+merge       ``sample_pdf_fast`` + ``merge_sorted_fast`` (K3)
  raw2outputs_128      compositing of 128 samples a ray

Times are CUDA-event means over ``--reps`` calls after one warm-up call (on
``--device cpu``, the host clock; CPU numbers are not the card's).

    python -m gbnerf_tpu_torch.tools.prof_field [--device cuda|cpu] \\
        [--rays 16384] [--reps 10]
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..utils.profiling import time_ms

R_MAX = 257
F = 80  # 5 levels × rank 16
NEAR, FAR = 1.2, 5.3


def device_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def encode_kr(x01: torch.Tensor, ulines: torch.Tensor,
              seg: int = 16) -> torch.Tensor:
    """The KR-factorised encode of the JAX script: per axis a one-hot over
    the R_max − 1 = nseg·seg cells' segments times a (seg + 1)-tap triangle
    within the segment, contracted with the lines gathered per segment."""
    r_max = ulines.shape[1]
    nseg = (r_max - 1) // seg
    idx = (torch.arange(nseg)[:, None] * seg
           + torch.arange(seg + 1)[None]).reshape(-1).to(x01.device)
    lt = ulines[:, idx, :].to(torch.bfloat16)             # [3, nseg·(seg+1), F]
    st = torch.arange(nseg, dtype=torch.float32, device=x01.device)
    tt = torch.arange(seg + 1, dtype=torch.float32, device=x01.device)
    x = torch.clamp(x01, 0.0, 1.0)
    prod = None
    for a in range(3):
        u = x[:, a] * (r_max - 1)
        s = torch.clamp(torch.floor(u / seg), max=nseg - 1)
        v = u - s * seg
        oh = (st[None] == s[:, None]).to(torch.bfloat16)
        tri = torch.clamp(1.0 - torch.abs(tt[None] - v[:, None]),
                          min=0.0).to(torch.bfloat16)
        kr = (oh[:, :, None] * tri[:, None, :]).reshape(-1, nseg * (seg + 1))
        fa = (kr @ lt[a]).float()
        prod = fa if prod is None else prod * fa
    return prod


def mlp_heads(enc: torch.Tensor, sh: torch.Tensor, W: dict) -> torch.Tensor:
    """σ-net F → 64 → 16, colour net SH ⊕ geo(15) → 64 → 64 → 3, bf16."""
    h = torch.relu(enc @ W["ws0"])
    h = h @ W["ws1"]
    sigma, geo = h[:, :1], h[:, 1:]
    h = torch.relu(torch.cat([sh, geo], dim=-1) @ W["wc0"])
    h = torch.relu(h @ W["wc1"])
    return torch.cat([h @ W["wc2"], sigma], dim=-1)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; an error without a card) or cpu")
    ap.add_argument("--rays", type=int, default=16384)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)

    from ..config import Config, FieldConfig, RenderConfig
    from ..core.render import raw2outputs
    from ..ops.cp_pallas import cp_encode_unified, encode_plain
    from ..ops.resample import merge_sorted_fast, sample_pdf_fast
    from ..train.loop import device_from_flag
    from ..train.state import create_params
    from ..train.step import make_render_fn

    dev = device_from_flag(args.device)
    name, n_rays, reps = device_name(dev), args.rays, args.reps
    lines = []

    def emit(component, **kw):
        line = {"component": component, **kw, "device": name}
        print(json.dumps(line), flush=True)
        lines.append(line)

    rng = np.random.default_rng(0)

    def rand(*shape, normal=False):
        a = rng.standard_normal(shape) if normal else rng.random(shape)
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    # ---------- full render (reference for attribution) ----------
    cfg = Config(field=FieldConfig(no_tcnn=False, field_type="cp"),
                 render=RenderConfig(N_samples=64, N_importance=64,
                                     lindisp=True, white_bkgd=True))
    coarse, fine = create_params(cfg, torch.Generator().manual_seed(0), dev)
    render = make_render_fn(cfg, coarse, fine, near=NEAR, far=FAR)
    ro = rand(n_rays, 3, normal=True) * 0.1
    rd = rand(n_rays, 3, normal=True)
    rd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    with torch.no_grad():
        ms = time_ms(lambda: render(ro, rd, train=False), dev, reps)
        emit("full_render", M_rays_s=n_rays / ms / 1e3, ms=ms)

        # ---------- encode variants on the fine pass's points ----------
        m = n_rays * 128
        pts = rand(m, 3)
        ulines = rand(3, R_MAX, F, normal=True) * 0.1
        for comp, fn in (
                ("encode_dense_plain", lambda: encode_plain(pts, ulines, R_MAX)),
                ("encode_dense_kernel",
                 lambda: cp_encode_unified(pts, ulines, R_MAX)),
                ("encode_kr", lambda: encode_kr(pts, ulines))):
            ms = time_ms(fn, dev, reps)
            emit(comp, M_pts_s=m / ms / 1e3, ms=ms, points=m)

        # ---------- MLP heads only (σ + colour topology) ----------
        bf = torch.bfloat16
        enc, sh = rand(m, F, normal=True).to(bf), rand(m, 16, normal=True).to(bf)
        W = {k: (rand(*s, normal=True) * 0.1).to(bf) for k, s in (
            ("ws0", (F, 64)), ("ws1", (64, 16)), ("wc0", (31, 64)),
            ("wc1", (64, 64)), ("wc2", (64, 3)))}
        ms = time_ms(lambda: mlp_heads(enc, sh, W), dev, reps)
        emit("mlp_heads", M_pts_s=m / ms / 1e3, ms=ms, points=m)

        # ---------- resample ops at render shapes ----------
        z = torch.sort(NEAR + (FAR - NEAR) * rand(n_rays, 64), dim=-1).values
        mids = 0.5 * (z[:, 1:] + z[:, :-1])
        w = rand(n_rays, 62)

        def resample():
            samples = sample_pdf_fast(mids, w, 64, det=True)
            return merge_sorted_fast(z, samples)

        ms = time_ms(resample, dev, reps)
        emit("resample+merge", M_rays_s=n_rays / ms / 1e3, ms=ms)

        # ---------- raw2outputs at render shapes ----------
        raw = rand(n_rays, 128, 4, normal=True)
        zc = torch.cumsum(rand(n_rays, 128), dim=-1)
        ms = time_ms(lambda: raw2outputs(raw, zc, rd, white_bkgd=True), dev,
                     reps)
        emit("raw2outputs_128", M_rays_s=n_rays / ms / 1e3, ms=ms)
    return lines


if __name__ == "__main__":
    main()
