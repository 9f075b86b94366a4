"""Ray sampling: stratified coarse samples and the inverse-CDF oracle.

Port of gbnerf_tpu/core/sampling.py. Randomness is injected: every random
draw is an optional tensor argument (``t_rand``, ``u``), drawn from an
explicit ``torch.Generator`` only when it is not given. JAX's threefry
streams cannot be replayed in torch, so tests hand both packages the same
numpy draws.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..parallel.mesh import draw


def stratified_z_vals(near, far, N_samples: int, *, lindisp: bool = False,
                      perturb: bool = False,
                      generator: Optional[torch.Generator] = None,
                      t_rand: Optional[torch.Tensor] = None,
                      dtype=torch.float32, device=None) -> torch.Tensor:
    """Coarse z values, linear in depth or in disparity, optionally jittered.

    near, far: [..., 1] tensors or scalars. t_rand: optional [..., N_samples]
    jitter in [0, 1); drawn from ``generator`` when perturb and not given.
    """
    if isinstance(near, torch.Tensor):
        device = near.device
    t = torch.linspace(0.0, 1.0, N_samples, dtype=dtype, device=device)
    near = torch.as_tensor(near, dtype=dtype, device=device)
    far = torch.as_tensor(far, dtype=dtype, device=device)
    if lindisp:
        z = 1.0 / (1.0 / near * (1.0 - t) + 1.0 / far * t)
    else:
        z = near * (1.0 - t) + far * t
    if perturb:
        mids = 0.5 * (z[..., 1:] + z[..., :-1])
        upper = torch.cat([mids, z[..., -1:]], -1)
        lower = torch.cat([z[..., :1], mids], -1)
        if t_rand is None:
            t_rand = draw("rand", z.shape, generator, dtype, device)
        z = lower + (upper - lower) * t_rand
    return z


def searchsorted_right(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Row-wise ``searchsorted(right=True)``: i = #{j : a[..., j] <= v}."""
    return torch.sum((a[..., None, :] <= v[..., :, None]).long(), dim=-1)


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, N_samples: int, *,
               det: bool = False, generator: Optional[torch.Generator] = None,
               eps: float = 1e-5, u: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """Inverse-CDF importance sampling — the reference contract, exactly.

    weights + 1e-5, prepend-zero CDF, right-searchsorted, clamped gathers,
    lerp with denom < 1e-5 → 1. The render path uses the clamp-sum form in
    ops/resample.py; this is its oracle.
    """
    weights = weights + eps
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)

    shape = cdf.shape[:-1] + (N_samples,)
    if u is not None:
        u = torch.as_tensor(u, dtype=bins.dtype, device=bins.device)
        u = u.expand(shape)
    elif det:
        u = torch.linspace(0.0, 1.0, N_samples, dtype=bins.dtype,
                           device=bins.device).expand(shape)
    else:
        u = draw("rand", shape, generator, bins.dtype, bins.device)
    u = u.contiguous()

    inds = searchsorted_right(cdf, u)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)

    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    bins_below = torch.gather(bins, -1, below)
    bins_above = torch.gather(bins, -1, above)

    denom = cdf_above - cdf_below
    denom = torch.where(denom < eps, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


def merge_z_vals(z_vals: torch.Tensor, z_samples: torch.Tensor
                 ) -> torch.Tensor:
    """Sorted union of coarse and importance z values."""
    return torch.sort(torch.cat([z_vals, z_samples], dim=-1), dim=-1).values
