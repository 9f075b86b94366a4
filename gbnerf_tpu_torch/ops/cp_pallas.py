"""The standalone CP encode on unified lines (K6), and the nested-resolution
helpers that build those lines.

Port of gbnerf_tpu/ops/cp_pallas.py. With R_l − 1 all dividing R_max − 1
(e.g. 17, 33, 65, 129, 257), every level's piecewise-linear interpolant is
exactly representable on the finest grid, so each axis's per-level lines
upsample to one [R_max, L·rank] matrix and a single encode serves all
levels (``upsample_lines``; the fused field of ops/field_fused.py uses the
same lines).

- ``encode_plain``: the plain version (the JAX package's ``_xla_impl``):
  for each axis the triangle row max(1 − |pos − u|, 0) at
  u = clip(x, 0, 1)·(R_max − 1), rounded to bf16, times the bf16-rounded
  lines in f32, the three axes multiplied. It is built from
  ``torch.maximum``/``torch.minimum`` against tensors and a ``where`` for
  |·|, so that its gradient splits ties as JAX's does (0.5/0.5 at a clip
  bound or a zero of the triangle, +1 for |d| at d = 0): points on 0, 1
  and the grid nodes then get JAX's gradient, where ``torch.clamp``,
  ``torch.relu`` and ``torch.abs`` would not.
- ``cp_encode_unified``: an autograd Function. On a CUDA tensor the
  forward launches csrc/cp_encode.cu (K6); on a CPU tensor it runs
  ``encode_plain``. The backward re-linearises ``encode_plain``, as the
  JAX custom VJP does; there is no backward kernel, as on the TPU.
- ``cp_encode_fused``: per-level lines → features; ``use_pallas=True``
  goes through ``cp_encode_unified``, the default through
  ``encode_plain`` (what the JAX default runs).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import numpy as np
import torch

from ._build import kernel_function

NESTED_RESOLUTIONS = (17, 33, 65, 129, 257)
# the largest dynamic shared memory one block may use on Hopper: K6 stages
# the lines there as bf16 (csrc/cp_encode.cu; beyond it the CUDA runtime
# refuses the launch, and this limit refuses it first, with a message)
MAX_SMEM_BYTES = 232448

# Launches since the last reset: chip_smoke.py zeroes them before a path
# and reads them after, to show that the path ran the kernel.
LAUNCHES = {"cp_encode": 0}


def check_nested(resolutions: Sequence[int]) -> int:
    r_max = max(resolutions)
    for r in resolutions:
        if (r_max - 1) % (r - 1) != 0:
            raise ValueError(
                f"resolutions must nest: ({r_max}-1) % ({r}-1) != 0; "
                f"use e.g. {NESTED_RESOLUTIONS}")
    return r_max


@functools.lru_cache(maxsize=32)
def _upsample_matrix(R: int, r_max: int, dtype: torch.dtype,
                     device: torch.device) -> torch.Tensor:
    """The static [R_max, R] map from a level's nodes to the finest grid.

    Built once per (R, R_max, dtype, device) and shared read-only: copying a
    fresh numpy matrix to the card on every call is a pageable host → device
    copy, which waits for the stream to drain and so stalls the host's
    launches twice per render.
    """
    # fine node p sits at coarse coordinate p·(R−1)/(R_max−1)
    u = np.arange(r_max) * (R - 1) / (r_max - 1)
    i0 = np.floor(u).astype(np.int32)
    f = (u - i0).astype(np.float32)
    pos = np.arange(R)
    W = ((pos[None] == i0[:, None]) * (1 - f[:, None])
         + (pos[None] == np.minimum(i0[:, None] + 1, R - 1)) * f[:, None])
    return torch.as_tensor(W.astype(np.float32), dtype=dtype, device=device)


def upsample_lines(lines: Sequence[torch.Tensor], r_max: int) -> torch.Tensor:
    """Per-level [3, R_l, rank] → unified [3, R_max, L·rank] (exact PWL).

    Differentiable; the per-level → fine-grid map is a static sparse matmul.
    """
    outs = []
    for line3 in lines:
        R = line3.shape[1]
        if R == r_max:
            outs.append(line3)
            continue
        W = _upsample_matrix(R, r_max, line3.dtype, line3.device)
        outs.append(torch.einsum("mr,ark->amk", W, line3))
    return torch.cat(outs, dim=-1)                              # [3, R_max, L·rank]


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and return f32 (its gradient is rounded to bf16 too,
    as JAX's is through ``astype``)."""
    return t.to(torch.bfloat16).float()


def encode_plain(x01: torch.Tensor, ulines: torch.Tensor,
                 r_max: int) -> torch.Tensor:
    """Fused CP encoding, plain version: [..., 3] × [3, R_max, F] → [..., F].

    Materialises one [N, R_max] weight matrix per axis (≈ 2 GB at N = 2 M
    and R_max = 257), as the XLA formulation does.
    """
    dev = x01.device
    pos = torch.arange(r_max, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    one = torch.ones((), dtype=torch.float32, device=dev)
    prod = None
    for axis in range(3):
        u = torch.minimum(torch.maximum(x01[..., axis], zero), one) * (r_max - 1)
        d = pos - u[..., None]
        w = torch.maximum(1.0 - torch.where(d >= 0, d, -d), zero)
        fa = _bf16(w) @ _bf16(ulines[axis])
        prod = fa if prod is None else prod * fa
    return prod


def check_points_and_lines(who: str, x01: torch.Tensor,
                           ulines: torch.Tensor) -> None:
    """Raise on points or lines that the CP kernels (K1/K2/K4/K5 and K6) do
    not take: x01 [N, 3] f32 contiguous with N < 2^29, ulines [3, R_max, F]
    with R_max ≥ 2 and F a multiple of 4, both on one device."""
    if x01.device != ulines.device:
        raise ValueError(f"{who}: x01 and ulines lie on different devices")
    if x01.dtype != torch.float32 or x01.dim() != 2 or x01.shape[1] != 3:
        raise ValueError(f"{who}: x01 must be [N, 3] float32, got "
                         f"{tuple(x01.shape)} {x01.dtype}")
    if not x01.is_contiguous():
        raise ValueError(f"{who}: x01 must be contiguous")
    if x01.shape[0] >= 1 << 29:
        raise ValueError(f"{who}: {x01.shape[0]} points exceed the kernel's "
                         "32-bit indexing; split the call")
    if ulines.dim() != 3 or ulines.shape[0] != 3 or ulines.shape[1] < 2:
        raise ValueError(f"{who}: ulines must be [3, R_max, F] (R_max ≥ 2), "
                         f"got {tuple(ulines.shape)}")
    feat = ulines.shape[2]
    if feat % 4 or feat == 0:
        raise ValueError(f"{who}: the kernel reads features in fours; "
                         f"F = {feat} is not a multiple of 4")


def check_encode_args(x01: torch.Tensor, ulines: torch.Tensor,
                      r_max: int) -> None:
    """Raise on anything csrc/cp_encode.cu does not take."""
    check_points_and_lines("cp_encode", x01, ulines)
    if ulines.dtype != torch.float32 or ulines.shape[1] != r_max:
        raise ValueError(f"cp_encode: ulines must be [3, {r_max}, F] float32, "
                         f"got {tuple(ulines.shape)} {ulines.dtype}")
    feat = ulines.shape[2]
    if not ulines.is_contiguous():
        raise ValueError("cp_encode: ulines must be contiguous")
    if ulines.data_ptr() % 16:
        raise ValueError("cp_encode: ulines must be 16-byte aligned (the "
                         "kernel reads float4s)")
    if 3 * r_max * feat * 2 > MAX_SMEM_BYTES:
        raise ValueError(f"cp_encode: lines [3, {r_max}, {feat}] do not fit "
                         "in a block's shared memory as bf16")


def encode_kernel(x01: torch.Tensor, ulines: torch.Tensor,
                  r_max: int) -> torch.Tensor:
    """K6 on CUDA tensors → [N, F] f32, or an error."""
    if x01.device.type != "cuda":
        raise ValueError(f"cp_encode: the kernel needs CUDA tensors, got "
                         f"{x01.device}")
    check_encode_args(x01, ulines, r_max)
    n, feat = x01.shape[0], ulines.shape[2]
    out = torch.empty((n, feat), dtype=torch.float32, device=x01.device)
    fn = kernel_function("gbnerf_cp_encode", [ctypes.c_void_p] * 3
                         + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    with torch.cuda.device(x01.device):
        err = fn(x01.data_ptr(), ulines.data_ptr(), out.data_ptr(), n, r_max,
                 feat, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"cp_encode kernel launch failed: CUDA error {err}")
    LAUNCHES["cp_encode"] += 1
    return out


class _Encode(torch.autograd.Function):
    """K6 forward on CUDA tensors (the plain version on the CPU); the
    backward re-linearises the plain version, as the JAX ``_bwd`` does."""

    @staticmethod
    def forward(ctx, x01, ulines, r_max):
        ctx.save_for_backward(x01, ulines)
        ctx.r_max = r_max
        if x01.device.type == "cpu":
            return encode_plain(x01, ulines, r_max)
        return encode_kernel(x01.detach(), ulines.detach(), r_max)

    @staticmethod
    def backward(ctx, g):
        x01, ulines = ctx.saved_tensors
        with torch.enable_grad():
            x = x01.detach().requires_grad_(True)
            ul = ulines.detach().requires_grad_(True)
            dx, dul = torch.autograd.grad(encode_plain(x, ul, ctx.r_max),
                                          (x, ul), g)
        need = ctx.needs_input_grad
        return (dx if need[0] else None), (dul if need[1] else None), None


def cp_encode_unified(x01: torch.Tensor, ulines: torch.Tensor,
                      r_max: int) -> torch.Tensor:
    """Fused CP encoding on unified lines: [N, 3] × [3, R_max, F] → [N, F].

    CPU tensors: ``encode_plain``. CUDA tensors: K6, or an error.
    Differentiable in x01 and ulines.
    """
    if x01.device.type not in ("cpu", "cuda"):
        raise ValueError(f"cp_encode_unified: no kernel for device "
                         f"{x01.device}; tensors must lie on the CPU or a "
                         "CUDA device")
    return _Encode.apply(x01, ulines, r_max)


def cp_encode_fused(x01: torch.Tensor, lines: Sequence[torch.Tensor], *,
                    use_pallas: bool = False) -> torch.Tensor:
    """Per-level lines [3, R_l, rank] → features [N, L·rank] (nested
    resolutions). use_pallas: through ``cp_encode_unified`` (K6 on the
    card); the default runs the plain formulation, as the JAX default runs
    its XLA one."""
    r_max = check_nested([l.shape[1] for l in lines])
    ulines = upsample_lines(lines, r_max)
    if use_pallas:
        return cp_encode_unified(x01, ulines, r_max)
    return encode_plain(x01, ulines, r_max)
