"""What holds K4/K5 (the fused CP-field backward): its time with one part
taken out.

Builds copies of csrc/field_fused_bwd.cu (with csrc/field_tile.cuh beside
it), each with one part of the kernel removed at compile time, into their
own libraries under ``build/prof_field_bwd_parts/<copy>/`` (nvcc, one
process per copy, all started together), and times each by CUDA-graph
replay on one card: K4 at a stage-1 step's fine pass (131,072 points) and
K5 at its coarse pass (65,536), with the shipped config's fields (seeded
random weights, F 80, R_max 257), under both point layouts of
``prof_field_kernels`` (``uniform``, ``rays``). The copies:

- ``kernel``: the kernel as it is (bit-equal to the wrapper's call: printed);
- ``no_heads``: no forward recompute or head backward (the tile buffers
  hold whatever shared memory holds);
- ``no_fixup``: no ``seq_fixup`` and no Σ|a·w| products that feed it;
- ``no_dw_products``: the dW products (the dW sums stay zero);
- ``no_dw_sums``: the dW partial sums' writes (to the scratch row, or
  where the kernel keeps them) and their flush;
- ``no_encode_bwd``: dprod, dfa and du (the taps and dx stores stay);
- ``no_dlines_products``: the dlines contraction maskᵀ·dfa;
- ``no_dlines_sums``: the dlines partial sums' writes and their flush;
- ``no_reduce``: the block-order reduce launch;
- ``no_sums``: neither partial sums' writes nor the reduce.

The outputs of every copy but ``kernel`` are wrong by construction; only
their times mean something. One JSON line a (kernel, layout): each copy's
graph ms, the kernel's registers, spills, shared memory and blocks an SM.
A copy whose anchor text the sources no longer hold raises: update the
anchors with the kernel.

    python -m gbnerf_tpu_torch.tools.prof_field_bwd_parts [--reps 20]
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from ..ops._build import CSRC_DIR, NVCC_FLAGS, find_nvcc

OUT_DIR = Path(__file__).resolve().parents[2] / "build" / "prof_field_bwd_parts"
BWD, TILE = "field_fused_bwd.cu", "field_tile.cuh"
# (kernel, field, points, samples a ray, sigma_only): prof_field_kernels's
CASES = (("field_fused_bwd", "fine", 1024 * 128, 128, False),
         ("field_fused_bwd_sigma", "coarse", 1024 * 64, 64, True))

# each part: (file, anchor, replacement, occurrences)
PARTS = {
    "no_heads": [(BWD, "    // ---- 1. forward recompute and head backward "
                  "(registers → buffers)\n    {",
                  "    if (false) {", 1)],
    "no_fixup": [(TILE, f"{f}<", f"if (false) {f}<", 4)
                 for f in ("mm_w_abs", "seq_fixup")],
    "no_dw_products": [(BWD, "for (int ks = 0; ks < kTile / 16; ++ks) {",
                        "for (int ks = 0; ks < 0; ++ks) {", 1)],
    "no_dw_sums": [(BWD, "      const float4 o = f4[j];\n      f4[j] =",
                    "      const float4 o = make_float4(0.f, 0.f, 0.f, 0.f);"
                    "\n      if (false) f4[j] =", 1),
                   (BWD, "old[j][h][e] = at[j][h][e] >= 0 ? dw[at[j][h][e]] "
                    ": 0.f;", "old[j][h][e] = 0.f;", 1),
                   (BWD, "if (at[j][h][e] >= 0) dw[at[j][h][e]] =",
                    "if (false) dw[at[j][h][e]] =", 1),
                   (BWD, "    if (so < 0) continue;\n    const DwMat M",
                    "    continue;\n    const DwMat M", 1)],
    "no_encode_bwd": [(BWD, "for (int kc = 0; kc < kcs; ++kc) {\n"
                       "        LaneRows rows;",
                       "for (int kc = 0; kc < 0; ++kc) {\n"
                       "        LaneRows rows;", 1)],
    "no_dlines_products": [(BWD, "for (int ks = 0; ks < kWarps; ++ks) {\n"
                            "          if (!((ks_mask",
                            "for (int ks = 0; ks < 0; ++ks) {\n"
                            "          if (!((ks_mask", 1)],
    "no_dlines_sums": [(BWD, "= ok && ra < r_max", "= false && ra < r_max",
                        1),
                       (BWD, "= ok && rb < r_max", "= false && rb < r_max",
                        1),
                       (BWD, "if (ra < r_max)\n              *reinterpret_cast",
                        "if (false)\n              *reinterpret_cast", 1),
                       (BWD, "if (rb < r_max)\n              *reinterpret_cast",
                        "if (false)\n              *reinterpret_cast", 1)],
    "no_reduce": [(BWD, "  field_bwd_reduce<<<",
                   "  if (false) field_bwd_reduce<<<", 1)],
}
PARTS["no_sums"] = (PARTS["no_dw_sums"] + PARTS["no_dlines_sums"]
                    + PARTS["no_reduce"])

_BWD_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def variants(sources: dict, parts: dict = PARTS,
             tool: str = "prof_field_bwd_parts") -> dict:
    """{copy: {file: text}} of the sources, by copy name: "kernel" as they
    are, and each of ``parts`` with its anchors replaced."""
    out = {"kernel": dict(sources)}
    for name, subs in parts.items():
        texts = dict(sources)
        for fname, old, new, count in subs:
            if texts[fname].count(old) != count:
                raise ValueError(
                    f"{tool}: csrc/{fname} no longer has {count} of "
                    f"{old!r}; update the {name} copy")
            texts[fname] = texts[fname].replace(old, new)
        out[name] = texts
    return out


def build(copies: dict, main: str = BWD, out_dir: Path = OUT_DIR,
          csrc: Path = CSRC_DIR) -> tuple:
    """Each copy into out_dir/<name>/lib.so (its files beside ``main``,
    the other headers from ``csrc``), all nvcc processes together →
    ({name: ctypes.CDLL}, {name: nvcc's -Xptxas -v report})."""
    nvcc = find_nvcc()
    procs = {}
    for name, texts in copies.items():
        d = out_dir / name
        d.mkdir(parents=True, exist_ok=True)
        for fname, text in texts.items():
            (d / fname).write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(csrc), "-o", str(d / "lib.so"),
             str(d / main)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
    libs, logs = {}, {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the {name} copy:\n{err}")
        libs[name] = ctypes.CDLL(str(out_dir / name / "lib.so"))
        logs[name] = err
    return libs, logs


def entry(lib, name, argtypes):
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


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
    from ..utils.profiling import graph_ms
    from .prof_field import device_name
    from .prof_field_kernels import points

    if not torch.cuda.is_available():
        raise SystemExit("prof_field_bwd_parts: K4/K5 run only on a card "
                         "and torch.cuda.is_available() is False")
    t0 = time.perf_counter()
    libs, _ = build(variants({f: (CSRC_DIR / f).read_text()
                              for f in (BWD, TILE)}))
    build_s = time.perf_counter() - t0
    dev = torch.device("cuda:0")
    name = device_name(dev)
    root = Path(__file__).resolve().parents[2]
    cfg = load_reference_config(str(root / "configs" / "spinnerf_scene.txt"))
    fields = dict(zip(("coarse", "fine"), create_params(
        cfg, torch.Generator().manual_seed(0), dev)))
    rng = np.random.default_rng(0)
    out = []
    for kernel, field, n, samples, sigma_only in CASES:
        f = fields[field]
        ul = upsample_lines([l.detach() for l in f.lines()],
                            max(f.resolutions))
        r_max, feat = ul.shape[1], ul.shape[2]
        Ws = {k: getattr(f, k).detach()
              for k in ff.W_KEYS[:2 if sigma_only else 5]}
        lines = ul.to(torch.bfloat16).contiguous()
        wpack = ff.pack_weights(Ws, sigma_only=sigma_only)
        out_len = 3 * r_max * feat + sum(
            a * b for a, b in ff.weight_shapes(
                feat, sigma_only=sigma_only).values())
        info = ff.kernel_info(backward=True, sigma_only=sigma_only,
                              r_max=r_max, feat=feat)
        for layout in ("uniform", "rays"):
            x = torch.from_numpy(points(layout, n, samples, rng)).to(dev)
            d = torch.from_numpy(rng.standard_normal((n, 3)).astype(
                np.float32)).to(dev)
            sh = None if sigma_only else sh_encode(
                d / d.norm(dim=-1, keepdim=True)).contiguous()
            g = torch.from_numpy(rng.standard_normal((n, 4)).astype(
                np.float32)).to(dev)
            ref = ff.field_fused_bwd(x, sh, ul, Ws, g, sigma_only=sigma_only)
            dx = torch.empty((n, 3), dtype=torch.float32, device=dev)
            dsh = None if sigma_only else torch.empty(
                (n, 16), dtype=torch.float32, device=dev)
            res = torch.empty(out_len, dtype=torch.float32, device=dev)
            line = {"kernel": kernel, "layout": layout, "points": n, "F": feat,
                    "R_max": r_max}
            for copy, lib in libs.items():
                grid = entry(lib, "gbnerf_field_fused_bwd_grid",
                              [ctypes.c_int] * 4)(n, r_max, feat,
                                                  int(sigma_only))
                if grid <= 0:
                    raise RuntimeError(f"{copy}: grid query: CUDA error "
                                       f"{-grid}")
                row = entry(lib, "gbnerf_field_fused_bwd_row",
                             [ctypes.c_int] * 3)(r_max, feat, int(sigma_only))
                scratch = torch.empty((grid, row), dtype=torch.float32,
                                      device=dev)
                fn = entry(lib, "gbnerf_field_fused_bwd", _BWD_ARGTYPES)

                def call(fn=fn, scratch=scratch, grid=grid, copy=copy):
                    err = fn(x.data_ptr(), None if sh is None else
                             sh.data_ptr(), g.data_ptr(), lines.data_ptr(),
                             wpack.data_ptr(), dx.data_ptr(),
                             None if dsh is None else dsh.data_ptr(),
                             scratch.data_ptr(), res.data_ptr(), n, r_max,
                             feat, int(sigma_only), grid,
                             torch.cuda.current_stream(dev).cuda_stream)
                    if err:
                        raise RuntimeError(f"{copy}: CUDA error {err}")

                call()
                torch.cuda.synchronize(dev)
                if copy == "kernel":
                    got = torch.cat([res, dx.flatten()] + (
                        [] if dsh is None else [dsh.flatten()]))
                    want = torch.cat([ref[2].flatten()]
                                     + [ref[3][k].flatten() for k in Ws]
                                     + [ref[0].flatten()]
                                     + ([] if dsh is None
                                        else [ref[1].flatten()]))
                    line["kernel_bit_equal"] = bool(torch.equal(got, want))
                line[f"{copy}_graph_ms"] = graph_ms(call, dev, args.reps)
                del scratch
            line.update(info)
            line.update(build_s=build_s, device=name)
            print(json.dumps(line), flush=True)
            out.append(line)
    return out


if __name__ == "__main__":
    main()
