"""Gather-free hierarchical resampling, and the bitonic z-merge kernel.

Port of gbnerf_tpu/ops/resample.py.

- ``sample_pdf_fast``: inverse-CDF sampling by the clamp-sum identity
  z(u) = bins_0 + Σ_b Δbins_b · clamp((u − cdf_b) / pdf_b, 0, 1), plain
  PyTorch. At u = 1.0 it returns the true inverse bins[-1] where the
  reference's oracle returns bins[-2] (gbnerf_tpu/ops/resample.py:30-35).
- ``sorted_uniform``: per-row sorted uniforms from normalised cumulative
  sums of exponential gaps, so no sort is needed.
- ``merge_sorted_fast``: the sorted union of two per-row sorted arrays.
  For the render's 64 + 64, 2-D case it goes through ``merge128``, which
  launches csrc/resample.cu (K3) on a CUDA tensor and runs the plain
  stable sort on a CPU tensor; other shapes take the stable sort, as in
  the JAX package. On a CUDA tensor ``merge128`` is differentiable as the
  JAX ``_merge128`` is: its backward routes the cotangent through the
  permutation of the stable sort (``_merge128_vbwd``).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..parallel.mesh import draw
from ._build import kernel_function
from .scan import cumsum_last

LAUNCHES = {"merge128": 0}


def sample_pdf_fast(bins: torch.Tensor, weights: torch.Tensor,
                    N_samples: int, *, det: bool = False,
                    generator: Optional[torch.Generator] = None,
                    eps: float = 1e-5, sorted_u: bool = False,
                    u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverse-CDF importance sampling, gather-free.

    bins: [N, B] sorted; weights: [N, B-1] unnormalised → [N, N_samples].
    u: optional injected uniforms; otherwise linspace (det), sorted draws
    (sorted_u) or iid draws, from ``generator``.
    """
    w = weights + eps
    pdf = w / torch.sum(w, dim=-1, keepdim=True)                 # [N, B-1]
    cdf = cumsum_last(pdf)
    cdf_lo = torch.cat([torch.zeros_like(cdf[..., :1]), cdf[..., :-1]],
                       dim=-1)                                   # [N, B-1]

    shape = bins.shape[:-1] + (N_samples,)
    if u is not None:
        u = torch.as_tensor(u, dtype=bins.dtype, device=bins.device)
        u = u.expand(shape)
    elif det:
        u = torch.linspace(0.0, 1.0, N_samples, dtype=bins.dtype,
                           device=bins.device).expand(shape)
    elif sorted_u:
        u = sorted_uniform(shape, generator=generator, dtype=bins.dtype,
                           device=bins.device)
    else:
        u = draw("rand", shape, generator, bins.dtype, bins.device)

    dbins = bins[..., 1:] - bins[..., :-1]                       # [N, B-1]
    inv_pdf = 1.0 / torch.clamp(pdf, min=1e-12)
    frac = torch.clamp(
        (u[..., :, None] - cdf_lo[..., None, :]) * inv_pdf[..., None, :],
        0.0, 1.0)                                                # [N, S, B-1]
    return bins[..., :1] + torch.sum(frac * dbins[..., None, :], dim=-1)


def sorted_uniform(shape, *, generator: Optional[torch.Generator] = None,
                   dtype=torch.float32, device=None) -> torch.Tensor:
    """Per-row sorted uniforms: u_(i) = S_i / S_{n+1}, S_k = Σ_{j≤k} E_j,
    E_j ~ Exp(1) — distributed as sorted iid U(0, 1) draws. A sequential
    cumsum of non-negative terms is monotone, which the bitonic merge
    downstream needs."""
    n = shape[-1]
    e = draw("exponential", tuple(shape[:-1]) + (n + 1,), generator, dtype,
             device)
    s = torch.cumsum(e, dim=-1)
    return s[..., :-1] / s[..., -1:]


def merge_sorted_fast(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Merge per-row sorted a [N, A] and b [N, B] → sorted [N, A+B]."""
    if a.shape[-1] + b.shape[-1] == 128 and a.dim() == 2:
        # the kernel reads one contiguous [N, 128] buffer; a may be a
        # stride-0 expand of one row of z_vals, and cat copies it
        x = torch.cat([a, b], dim=-1).float()
        return merge128(x, a.shape[-1]).to(a.dtype)
    merged = torch.sort(torch.cat([a, b], dim=-1), dim=-1, stable=True)
    return merged.values.to(a.dtype)


def merge128_plain(x: torch.Tensor, split: int) -> torch.Tensor:
    """The plain version of K3: a stable sort of each row (both parts of
    the row are sorted already, so this is their merge)."""
    del split
    return torch.sort(x, dim=-1, stable=True).values


def merge128(x: torch.Tensor, split: int) -> torch.Tensor:
    """Merge x[:, :split] and x[:, split:], each sorted, along each row.

    x: [N, 128] f32. On a CPU tensor: the stable sort (differentiated by
    autograd); on a CUDA tensor: the bitonic-merge kernel, whose backward
    is the stable sort's (``_Merge128``), or an error.
    """
    if x.device.type == "cpu":
        return merge128_plain(x, split)
    if x.device.type != "cuda":
        raise ValueError(f"merge128: no kernel for device {x.device}; "
                         "tensors must lie on the CPU or a CUDA device")
    if torch.is_grad_enabled() and x.requires_grad:
        return _Merge128.apply(x, split)
    return _launch_merge(x, split)


def _launch_merge(x: torch.Tensor, split: int) -> torch.Tensor:
    check_merge_args(x, split)
    out = torch.empty_like(x)
    fn = kernel_function("gbnerf_merge128", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p])
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), out.data_ptr(), x.shape[0], split,
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"merge128 kernel launch failed: CUDA error {err}")
    LAUNCHES["merge128"] += 1
    return out


class _Merge128(torch.autograd.Function):
    """K3 forward; the backward is the JAX ``_merge128_vbwd``: the cotangent
    goes back through the permutation of ``torch.sort(x, stable=True)``
    (a library sort is right here: this is the JAX package's XLA backward,
    not a kernel body). Where x holds equal values the kernel's order of
    them may differ from the stable sort's; the two are the same value, so
    the gradient is still a valid subgradient, as in JAX."""

    @staticmethod
    def forward(ctx, x, split):
        ctx.save_for_backward(x)
        return _launch_merge(x.detach(), split)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        perm = torch.sort(x, dim=-1, stable=True).indices
        dx = torch.zeros_like(x).scatter_(-1, perm, g.to(x.dtype))
        return dx, None


def check_merge_args(x: torch.Tensor, split: int) -> None:
    """Raise on anything csrc/resample.cu does not take."""
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != 128:
        raise ValueError(f"merge128: x must be [N, 128] float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("merge128: x must be contiguous (concatenate the "
                         "two halves into one buffer first)")
    if not 0 < split < 128:
        raise ValueError(f"merge128: split must lie in (0, 128), got {split}")
    if x.shape[0] >= 1 << 31:
        raise ValueError("merge128: too many rows for 32-bit indexing")
