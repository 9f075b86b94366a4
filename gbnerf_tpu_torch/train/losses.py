"""Training losses of stage 1: the CP-line regulariser and the DS-NeRF
σ-likelihood (port of the stage-1 half of gbnerf_tpu/train/losses.py).

Random draws (the σ-loss jitter uniforms and σ noise) come from a
``torch.Generator`` or are injected as tensors, so tests can hand both
packages the same numbers.
"""
from __future__ import annotations

from typing import Iterable, Optional

import torch
from torch import nn


def cp_tv_loss(fields: Iterable[nn.Module]) -> torch.Tensor:
    """Total-variation + L1 regulariser on CP-grid factor lines.

    TensoRF-style: over every parameter named ``lines_*`` ([3, R, rank]) of
    the given fields, mean squared neighbour difference along R plus 0.01 ×
    mean |line|. Zero for fields without lines (NeRFMLP).
    """
    tv = l1 = torch.zeros(())
    for field in fields:
        for name, v in field.named_parameters():
            if name.rsplit(".", 1)[-1].startswith("lines_"):
                d = v[:, 1:, :] - v[:, :-1, :]
                tv = tv + torch.mean(d * d)
                l1 = l1 + torch.mean(torch.abs(v))
    return tv + 0.01 * l1


def sigma_loss(field_fn, rays_o, rays_d, viewdirs, near, depths, *,
               N_samples: int, perturb: bool = True,
               raw_noise_std: float = 0.0,
               generator: Optional[torch.Generator] = None,
               u: Optional[torch.Tensor] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DS-NeRF σ-likelihood depth loss along rays with known depth → [N].

    Samples near → depth along each ray (jittered within their intervals
    when perturb) and scores −exp(σ_last) / (Σ exp(σ) + 1), computed so
    that it cannot overflow (see below; a divergence from the JAX package,
    whose form turns NaN for σ ≳ 88).
    u: optional injected jitter uniforms [N, N_samples]; noise: optional
    injected standard-normal σ noise [N, N_samples]; otherwise both are
    drawn from ``generator``.
    """
    dt, dev = rays_o.dtype, rays_o.device
    t = torch.linspace(0.0, 1.0, N_samples, dtype=dt, device=dev)
    near_b = torch.as_tensor(near, dtype=dt, device=dev).expand(
        rays_o.shape[:-1])[..., None]
    z = near_b * (1.0 - t) + depths[:, None] * t
    if perturb:
        mids = 0.5 * (z[..., 1:] + z[..., :-1])
        upper = torch.cat([mids, z[..., -1:]], -1)
        lower = torch.cat([z[..., :1], mids], -1)
        if u is None:
            u = torch.rand(z.shape, generator=generator, dtype=dt, device=dev)
        z = lower + (upper - lower) * u
    pts = rays_o[..., None, :] + rays_d[..., None, :] * z[..., :, None]
    raw = field_fn(pts, viewdirs)
    sig = raw[..., 3]
    if raw_noise_std > 0.0:
        if noise is None:
            noise = torch.randn(sig.shape, generator=generator,
                                dtype=sig.dtype, device=sig.device)
        sig = sig + noise * raw_noise_std
    sig = torch.relu(sig)
    # −exp(σ_N) / (Σ exp(σ) + 1), evaluated shifted by the row max m:
    # −exp(σ_N − m) / (Σ exp(σ − m) + exp(−m)) is the same number, but
    # stays finite once σ passes ≈ 88, where exp(σ) overflows f32 and the
    # unshifted form (the JAX package's) gives inf / inf = NaN. The value
    # does not depend on m, so m carries no gradient.
    m = torch.amax(sig, dim=1, keepdim=True).detach()
    e = torch.exp(sig - m)
    return -e[:, -1] / (torch.sum(e, dim=1) + torch.exp(-m[:, 0]))
