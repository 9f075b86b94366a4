"""Nested CP resolutions: the check and the exact upsampling to one grid.

Port of the live helpers of gbnerf_tpu/ops/cp_pallas.py. With R_l − 1 all
dividing R_max − 1 (e.g. 17, 33, 65, 129, 257), every level's piecewise-
linear interpolant is exactly representable on the finest grid, so each
axis's per-level lines upsample to one [R_max, L·rank] matrix and a single
encode serves all levels (ops/field_fused.py). The standalone encode kernel
of that module (K6 ``_kernel``) is not on the render path and is not ported
here.
"""
from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

NESTED_RESOLUTIONS = (17, 33, 65, 129, 257)


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
