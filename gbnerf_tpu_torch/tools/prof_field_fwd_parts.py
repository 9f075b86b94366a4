"""What holds K1/K2 (the fused CP-field forward): its time with one part
taken out.

Builds copies of csrc/field_fused.cu (the headers it includes are read
from the csrc/ directory), each with one part of the kernel removed at
compile time, into their own libraries under
``build/prof_field_fwd_parts/<copy>/`` (``prof_field_bwd_parts.build``:
one nvcc process a copy, all started together), and times each by
CUDA-graph replay on one card: K1 at a render's fine pass (2,097,152
points) and at a stage-1 step's (131,072), K2 at a render's coarse pass
(1,048,576) and at a step's (65,536), with the shipped config's fields
(seeded random weights, F 80, R_max 257), under both point layouts of
``prof_field_kernels`` (``uniform``, ``rays``). The copies (``PARTS``):

- ``kernel``: the kernel as it is (bit-equal to the wrapper's call, printed,
  when the sources are the package's own);
- ``no_gathers``: every point's tap rows at the axis's first row (the
  reads broadcast): the gathers' traffic and bank conflicts out;
- ``conflict_free``: the tap rows chosen so that an instruction's 8 rows
  take two wavefronts (the fewest 8 × 32 bytes can): the conflicts out;
- ``no_encode``: the encode's A fragments a constant (the taps stay);
- ``no_color`` (K1): stop after h1 and store K2's output;
- ``no_products``: the warpgroup products removed (a cheap op that
  keeps their operands live in their place);
- ``no_io``: x and SH read from the first 1024 points (L1-resident) and
  no output stores: the device-memory traffic out;
- ``no_overlap``: the encode of a k-chunk waits for the
  product of the one before;
- ``wg3``, ``lines_l1`` (other designs, not parts): 3
  warpgroups a block instead of 4; the lines read through L1 instead of
  staged in shared memory;
- ``timeline`` (not a part): each warpgroup's clock cycles a tile in four
  phases, printed as ``timeline_cycles_a_tile``.

The outputs of every copy but ``kernel`` are wrong by construction; only
their times mean something. One JSON line a (kernel, points, layout):
each copy's graph ms, and the kernel copy's registers, spills, shared
memory a block and blocks an SM. A copy whose anchor text the sources no
longer hold raises: update the anchors with the kernel.

    python -m gbnerf_tpu_torch.tools.prof_field_fwd_parts [--reps 20]
        [--csrc DIR]  (another tree's csrc/ of this design, e.g. a git
                       archive's)
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import time
from pathlib import Path

import numpy as np
import torch

from ..ops._build import CSRC_DIR
from .prof_field_bwd_parts import build, entry, variants

OUT_DIR = Path(__file__).resolve().parents[2] / "build" / "prof_field_fwd_parts"
FWD = "field_fused.cu"
# (kernel, field, points, samples a ray, sigma_only): the render's passes
# and a stage-1 step's
CASES = (("field_fused", "fine", 16384 * 128, 128, False),
         ("field_fused", "fine", 1024 * 128, 128, False),
         ("field_fused_sigma", "coarse", 16384 * 64, 64, True),
         ("field_fused_sigma", "coarse", 1024 * 64, 64, True))
K1_ONLY = ("no_color",)

# each part: (file, anchor, replacement, occurrences). lane_taps_of holds
# the tap rows' offsets; enc_frag_s is the encode from staged lines.
_TAP = "      t.off[h][a] = obase + (a * r_max + c.i0) * ostride;"
# conflict_free's rows ≡ 0, 6, 4, 2 (mod 8) for g mod 4 = 0 … 3: at 44
# words a row (F 80) a half-warp's 4 rows start at banks 0, 8, 16, 24
_CONFLICT_FREE = (" + (min(c.i0, r_max - 9) & ~7) + 2 * ((4 - "
                  "((lane_id() >> 2) & 3)) & 3)")
_ENC = ("void enc_frag_s(uint32_t a[4], const LaneTaps& t,\n"
        "                                           int ls2, int fo, bool "
        "valid) {\n")
# the A fragments a constant that keeps the taps live
_CONST_A = ("  float s = 0.f;\n"
            "  for (int h = 0; h < 2; ++h)\n"
            "    for (int ax = 0; ax < 3; ++ax) s += t.w0[h][ax] + "
            "t.w1[h][ax] + (float)t.off[h][ax];\n"
            "  a[0] = a[1] = a[2] = a[3] = __float_as_uint(s) ^ (uint32_t)%s;"
            "\n  if (%s >= 0) return;\n")


# the timeline copy: each warpgroup's clock cycles a tile in four phases
# (the taps and the x / SH loads' issue; the encode and ws0; ws1; K1's
# colour net or K2's store, each up to the stores), summed over tiles
_TL_DEVICE = """__device__ unsigned long long g_tl[5];
__device__ __forceinline__ void tl_add(const long long (&q)[5]) {
  if ((threadIdx.x & 127) == 0) {
    for (int i = 0; i < 4; ++i)
      atomicAdd(&g_tl[i], (unsigned long long)(q[i + 1] - q[i]));
    atomicAdd(&g_tl[4], 1ull);
  }
}

"""
_TL_HOST = """
}  // namespace

// the timeline's sums → host[5] (cycles of the 4 phases, tiles), then 0
extern "C" int gbnerf_fwd_timeline(unsigned long long* host) {
  cudaError_t err = cudaMemcpyFromSymbol(host, g_tl, sizeof(g_tl));
  const unsigned long long zero[5] = {0, 0, 0, 0, 0};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_tl, zero, sizeof(g_tl));
  return (int)err;
}

namespace {
"""
TL_PHASES = ("taps", "encode_ws0", "ws1", "tail")

_STORES = [(FWD, f"if ({p} < n)\n", f"if ({p} < n && out == nullptr)\n", 2)
           for p in ("pa", "pb")]

PARTS = {
    "no_gathers": [(FWD, _TAP, _TAP.replace(" + c.i0", ""), 1)],
    "conflict_free": [(FWD, _TAP, _TAP.replace(" + c.i0", _CONFLICT_FREE), 1)],
    "no_encode": [(FWD, _ENC, _ENC + _CONST_A % ("fo", "fo"), 1)],
    "no_color": [(FWD, "    if (kSigmaOnly) {\n", "    if (true) {\n", 1)],
    "no_products": [(FWD, "  wgmma_rs<N, 0>(d, a, b_desc(w, N, kc), acc);",
                     "  d[0] += __uint_as_float(a[0] ^ a[1] ^ a[2] ^ a[3] ^ w"
                     " ^ (uint32_t)(kc + acc));", 1)],
    "no_io": [(FWD, "xr[h][a] = p < n ? x[3 * p + a] : 0.5f;",
               "xr[h][a] = p < n ? x[3 * (p & 1023) + a] : 0.5f;", 1),
              (FWD, "sh + (size_t)p * kSh", "sh + (size_t)(p & 1023) * kSh",
               2)] + _STORES,
    "no_overlap": [(FWD, "wg_wait<1>();", "wg_wait<0>();", 2)],
    # other designs, not parts: 3 warpgroups a block; the lines read
    # through L1 instead of staged in shared memory
    "wg3": [(FWD, "constexpr int kFwdWG = 4;", "constexpr int kFwdWG = 3;",
             1)],
    # not a part: clock64() stamps at a tile's phases (below)
    "timeline": [
        (FWD, "// kStaged: the lines in shared memory", _TL_DEVICE
         + "// kStaged: the lines in shared memory", 1),
        (FWD, "    const int p0 = tile * kFwdTile + row0;\n",
         "    const int p0 = tile * kFwdTile + row0;\n"
         "    long long q[5];\n    q[0] = clock64();\n", 1),
        (FWD, "    // h0 = bf16(enc) @ ws0: the encode", "    q[1] = clock64();\n"
         "    // h0 = bf16(enc) @ ws0: the encode", 1),
        (FWD, "    // h1 = bf16(h0) @ ws1\n", "    q[2] = clock64();\n"
         "    // h1 = bf16(h0) @ ws1\n", 1),
        (FWD, "    // σ = h1[:, 0]: entries 0", "    q[3] = clock64();\n"
         "    // σ = h1[:, 0]: entries 0", 1),
        (FWD, "      continue;\n    }\n", "      q[4] = clock64();\n"
         "      tl_add(q);\n      continue;\n    }\n", 1),
        (FWD, "            make_float2(rgb[2], tig ? sb2 : rgb[3]);\n    }\n"
         "  }\n}\n", "            make_float2(rgb[2], tig ? sb2 : rgb[3]);\n"
         "    }\n    q[4] = clock64();\n    tl_add(q);\n  }\n}\n" + _TL_HOST,
         1)],
    "lines_l1": [(FWD, "  const bool stage = fwd_smem(r_max, feat, kSigmaOnly, "
                  "true) <= (size_t)optin;", "  const bool stage = false;",
                  1)],
}


_FWD_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _ptxas(log: str) -> list:
    """The -Xptxas -v lines of the field_fused kernels, and any warning."""
    keep, on = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            on = "field_fused" in line
        if on and ("registers" in line or "spill" in line
                   or "Compiling" in line) or "arning" in line \
                or "Performance" in line:
            keep.append(re.sub(r"\s+", " ", line.strip()))
    return keep


def _timeline(lib, call) -> dict:
    """One call of the timeline copy → its warpgroups' mean clock cycles a
    tile in each phase (``TL_PHASES``)."""
    host = (ctypes.c_ulonglong * 5)()
    read = entry(lib, "gbnerf_fwd_timeline", [ctypes.c_void_p])
    for _ in range(2):            # the first read clears the sums
        torch.cuda.synchronize()
        if read(ctypes.addressof(host)):
            raise RuntimeError("timeline: CUDA error")
        call()
    torch.cuda.synchronize()
    if read(ctypes.addressof(host)):
        raise RuntimeError("timeline: CUDA error")
    tiles = max(int(host[4]), 1)
    return {k: int(host[i]) / tiles for i, k in enumerate(TL_PHASES)}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--csrc", default=str(CSRC_DIR),
                    help="the csrc/ directory whose kernel to take apart")
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
        raise SystemExit("prof_field_fwd_parts: K1/K2 run only on a card "
                         "and torch.cuda.is_available() is False")
    csrc = Path(args.csrc).resolve()
    own = csrc == CSRC_DIR.resolve()
    t0 = time.perf_counter()
    sources = {FWD: (csrc / FWD).read_text()}
    libs, logs = build(variants(sources, PARTS, "prof_field_fwd_parts"),
                       main=FWD, out_dir=OUT_DIR, csrc=csrc)
    build_s = time.perf_counter() - t0
    print(json.dumps({"csrc": str(csrc),
                      "ptxas": _ptxas(logs["kernel"]), "build_s": build_s}),
          flush=True)
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
        keys = ff.FWD_INFO_KEYS
        info_c = (ctypes.c_int * len(keys))()
        err = entry(libs["kernel"], "gbnerf_field_fused_info",
                    [ctypes.c_int] * 3 + [ctypes.c_void_p])(
            r_max, feat, int(sigma_only), ctypes.addressof(info_c))
        if err:
            raise RuntimeError(f"kernel info: CUDA error {err}")
        info = dict(zip(keys, list(info_c)))
        for layout in ("uniform", "rays"):
            x = torch.from_numpy(points(layout, n, samples, rng)).to(dev)
            d = torch.from_numpy(rng.standard_normal((n, 3)).astype(
                np.float32)).to(dev)
            sh = None if sigma_only else sh_encode(
                d / d.norm(dim=-1, keepdim=True)).contiguous()
            res = torch.empty((n, 4), dtype=torch.float32, device=dev)
            line = {"kernel": kernel, "layout": layout, "points": n,
                    "F": feat, "R_max": r_max}
            for copy, lib in libs.items():
                if sigma_only and copy in K1_ONLY:
                    continue
                fn = entry(lib, "gbnerf_field_fused", _FWD_ARGTYPES)

                def call(fn=fn, copy=copy):
                    err = fn(x.data_ptr(), None if sh is None else
                             sh.data_ptr(), lines.data_ptr(),
                             wpack.data_ptr(), res.data_ptr(), n, r_max,
                             feat, int(sigma_only),
                             torch.cuda.current_stream(dev).cuda_stream)
                    if err:
                        raise RuntimeError(f"{copy}: CUDA error {err}")

                if copy == "timeline":
                    line["timeline_cycles_a_tile"] = _timeline(lib, call)
                call()
                torch.cuda.synchronize(dev)
                if copy == "kernel" and own:
                    with torch.no_grad():
                        want = ff.cp_field_fused(x, sh, ul, Ws,
                                                 sigma_only=sigma_only)
                    line["kernel_bit_equal"] = bool(torch.equal(res, want))
                line[f"{copy}_graph_ms"] = graph_ms(call, dev, args.reps)
            line.update(info)
            line.update(build_s=build_s, device=name)
            print(json.dumps(line), flush=True)
            out.append(line)
    return out


if __name__ == "__main__":
    main()
