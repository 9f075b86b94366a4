"""What bounds K7 at head dims up to 128: its time with one part taken out.

Builds copies of csrc/attention.cu, each with one part of the D ≤ 128
kernel removed, into their own libraries under
``build/prof_attention_parts/`` (nvcc, one process per copy, all started
together; only the head dims asked for are instantiated), and times each
at the given shapes by CUDA-graph replay beside SDPA, on one card:

- ``kernel``: the kernel as it is (its largest error against
  ``attention_plain`` relative to max|plain| is printed too);
- ``no_loads``: the producer loads Q only; the consumers neither wait for
  K/V tiles nor release them, and compute on whatever shared memory
  holds: the products, the softmax and the turns without TMA;
- ``no_products``: no wgmma (the scores are the last tile's registers):
  the loads, the softmax and the turns;
- ``no_exps``: p = s·log2e − m·log2e without ex2: the SFU out of the
  loop;
- ``no_loads_products``: the softmax and the turns alone;
- ``two_consumers``: the kernel itself at wm 8 (two consumer warpgroups,
  128-row blocks), where the plan has three or four up to D 48;
- ``bk64``: keys in tiles of 64 at every head dim (the kernel: 128 above
  D 16), the ring as deep as the kernel's;
- ``bk64_nst4``: tiles of 64 and a 4-stage ring above D 64 too;
- ``nst6``: a 6-stage ring up to D 64 (the kernel: 4).

The outputs of the first five copies are wrong by construction; only
their times mean something. The last three compute the kernel's function
with other tiles or rings (their largest error is printed as the
kernel's). One JSON line a shape. A copy whose text the source no longer
holds raises: update its anchors with the kernel.

    python -m gbnerf_tpu_torch.tools.prof_attention_parts \
        [--shapes 16x4096x40,16x1024x80] [--reps 20]
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import time
from pathlib import Path

import torch

from ..ops._build import CSRC_DIR, NVCC_FLAGS, find_nvcc

OUT_DIR = Path(__file__).resolve().parents[2] / "build" / "prof_attention_parts"
SHAPES = "16x4096x40,32x4096x40,16x1024x80,64x1024x80,32x1024x16,16x1024x32"

_CASES = '''#define GBNERF_ATTN_SMALL_CASES(X)                                          \\
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13)     \\
  X(14) X(15) X(16)'''
_LOAD_LOOP = "      for (int j = 0; j < ntiles; ++j) {\n        const int s = j % NST"
_RELEASE = "    if (lane == 0) mbar_arrive(empty);"
_QK = ("      wgmma_rs<BK, 0>(sacc, qf[kk], k_desc<BK>(tile, kk), "
       "kk > 0 ? 1 : 0);")
_PV = "      wgmma_rs<D, 1>(o, pf[kk], v_desc<BK>(tile, kk), 1);"
_EXP = "= ex2(fmaf(sacc["
_TILE = "d <= kSmallD ? 128 : 32; }"
_RING = "static constexpr int NST = D <= 64 ? 4 : 2;"


# the copies that compute the kernel's function
_SAME_FUNCTION = ("kernel", "bk64", "bk64_nst4", "nst6")


def _sub(text: str, old: str, new: str, count: int = 1) -> str:
    if text.count(old) != count:
        raise ValueError(f"prof_attention_parts: csrc/attention.cu no longer "
                         f"has {count} of {old!r}; update the variant")
    return text.replace(old, new)


def variants(src: str, head_dims) -> dict:
    """The copies of attention.cu's source, by name."""
    cases = " ".join(f"X({d // 8})" for d in sorted(set(head_dims)))
    base = _sub(src, _CASES, f"#define GBNERF_ATTN_SMALL_CASES(X) {cases}")

    def no_loads(t):
        t = _sub(t, _LOAD_LOOP, _LOAD_LOOP.replace("j < ntiles", "j < 0"))
        t = _sub(t, "mbar_wait(&full_k[", "if (0) mbar_wait(&full_k[", 2)
        t = _sub(t, "mbar_wait(&full_v[", "if (0) mbar_wait(&full_v[")
        return _sub(t, _RELEASE, "    (void)empty;")

    def no_products(t):
        return _sub(_sub(t, _QK, "      ;"), _PV, "      ;")

    bk64 = _sub(base, _TILE, "d <= kSmallD ? 64 : 32; }")
    return {"kernel": base, "no_loads": no_loads(base),
            "no_products": no_products(base),
            "no_exps": _sub(base, _EXP, "= (fmaf(sacc[", 4),
            "no_loads_products": no_products(no_loads(base)),
            "bk64": bk64,
            "bk64_nst4": _sub(bk64, _RING, _RING.replace(": 2;", ": 4;")),
            "nst6": _sub(base, _RING, _RING.replace("? 4 :", "? 6 :"))}


def build(sources: dict) -> dict:
    """Each source into OUT_DIR/<name>.so, all nvcc processes together."""
    from ..ops.attention import _ATTN_ARGTYPES

    nvcc = find_nvcc()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu = OUT_DIR / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o",
             str(OUT_DIR / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the {name} copy:\n{err}")
        lib = ctypes.CDLL(str(OUT_DIR / f"{name}.so"))
        fn = lib.gbnerf_attention_fwd
        fn.argtypes = _ATTN_ARGTYPES
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--shapes", default=SHAPES,
                    help="BHxNxD,... with D ≤ 128 a multiple of 8")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    shapes = [tuple(map(int, s.split("x"))) for s in args.shapes.split(",")]

    from ..ops import attention as at
    from ..utils.profiling import graph_ms
    from .prof_field import device_name

    if not torch.cuda.is_available():
        raise SystemExit("prof_attention_parts: K7 runs only on a card and "
                         "torch.cuda.is_available() is False")
    if any(d % 8 or not 8 <= d <= at.SMALL_HEAD_DIM for _, _, d in shapes):
        raise SystemExit("prof_attention_parts: head dims 8 … 128, multiples "
                         "of 8")
    t0 = time.perf_counter()
    fns = build(variants((CSRC_DIR / "attention.cu").read_text(),
                         [d for _, _, d in shapes]))
    build_s = time.perf_counter() - t0
    dev = torch.device("cuda:0")
    name = device_name(dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    lines = []
    for bh, n, d in shapes:
        q, k, v = (torch.randn((bh, n, d), generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        q = q * 3
        scale = d ** -0.5
        qscale = float(torch.tensor(scale, dtype=torch.bfloat16))
        plan_wm = at.kernel_plan(bh, n, d, dev).wm
        ref = at.attention_plain(q, k, v, scale).float()
        out = torch.empty_like(q)
        q4, k4, v4 = q[None], k[None], v[None]
        line = {"bh": bh, "n": n, "d": d, "wm": plan_wm, "split": 1,
                "sdpa_graph_ms": graph_ms(
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        q4, k4, v4, scale=scale), dev, args.reps)}
        runs = [(v, fn, plan_wm) for v, fn in fns.items()]
        runs.append(("two_consumers", fns["kernel"], 8))
        for variant, fn, wm in runs:
            def call(fn=fn, wm=wm):
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), None, None, bh, n, d, 0, qscale, wm,
                         1, torch.cuda.current_stream(dev).cuda_stream)
                if err:
                    raise RuntimeError(f"{variant}: CUDA error {err}")

            call()
            torch.cuda.synchronize(dev)
            if variant in _SAME_FUNCTION:
                line[f"{variant}_rel_err"] = float(
                    (out.float() - ref).abs().max() / ref.abs().max())
            line[f"{variant}_graph_ms"] = graph_ms(call, dev, args.reps)
        line.update(build_s=build_s, device=name)
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


if __name__ == "__main__":
    main()
