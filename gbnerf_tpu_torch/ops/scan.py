"""Cumulative ops along the sample axis.

Port of the semantics of gbnerf_tpu/ops/scan.py, on its non-TPU branch:
``torch.cumsum``/``torch.cumprod``, and a transmittance of Π (x + ε). The
JAX package's triangular-matmul form and its max(x, ε) floor exist only
because of XLA's lowering on the TPU.
"""
from __future__ import annotations

import torch


def cumsum_last(x: torch.Tensor, *, exclusive: bool = False) -> torch.Tensor:
    """Cumulative sum along the last axis; exclusive → [0, x0, x0+x1, ...]."""
    cs = torch.cumsum(x, dim=-1)
    if exclusive:
        cs = torch.cat([torch.zeros_like(cs[..., :1]), cs[..., :-1]], dim=-1)
    return cs


def cumprod_last_exclusive(x: torch.Tensor, *, eps: float = 0.0
                           ) -> torch.Tensor:
    """T_i = Π_{j<i} (x_j + ε), T_0 = 1, along the last axis."""
    return torch.cumprod(
        torch.cat([torch.ones_like(x[..., :1]), x[..., :-1] + eps], dim=-1),
        dim=-1)
