"""Training losses (port of gbnerf_tpu/train/losses.py): the CP-line
regulariser, the DS-NeRF σ-likelihood, the per-pixel gradient clip
(``pwclip``), the least-squares depth alignment, the masked image-gradient
loss, and the masked patch sampling of the LPIPS patch loss.

Random draws (the σ-loss jitter uniforms and σ noise, the patch centres)
come from a ``torch.Generator`` or are injected as tensors, so tests can
hand both packages the same numbers.
"""
from __future__ import annotations

from typing import Iterable, Optional

import torch
from torch import nn

from ..parallel.mesh import draw
from ..utils import jax_random as jr


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
    drawn from ``generator`` (a JaxKey splits as the JAX package's: the
    jitter from the first half, the noise from the second).
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
        k_u, generator = jr.split(generator)
        if u is None:
            u = draw("rand", z.shape, k_u, dt, dev)
        z = lower + (upper - lower) * u
    pts = rays_o[..., None, :] + rays_d[..., None, :] * z[..., :, None]
    raw = field_fn(pts, viewdirs)
    sig = raw[..., 3]
    if raw_noise_std > 0.0:
        if noise is None:
            noise = draw("randn", sig.shape, generator, sig.dtype,
                         sig.device)
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


class _PWClip(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, clip_value):
        ctx.clip_value = clip_value
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ratio = torch.clamp(ctx.clip_value / g.abs().clamp_min(1e-12),
                            max=1.0)
        return g * torch.amin(ratio, dim=-1, keepdim=True), None


def pwclip(x: torch.Tensor, clip_value: float = 1.0) -> torch.Tensor:
    """Identity forward; the backward clips the incoming gradient per pixel
    (the reference's _hook, suppress_type 0): each row of the last axis is
    scaled by the smallest of its channels' min(1, clip / |g|), so no
    channel passes ±clip and the direction is kept."""
    return _PWClip.apply(x, clip_value)


def compute_scale_and_shift(prediction, target, mask):
    """Per-image least-squares (s, t) minimising ‖s·pred + t − target‖² over
    the mask (sums over the last two axes); (0, 0) where singular."""
    a00 = torch.sum(mask * prediction * prediction, dim=(-2, -1))
    a01 = torch.sum(mask * prediction, dim=(-2, -1))
    a11 = torch.sum(mask, dim=(-2, -1))
    b0 = torch.sum(mask * prediction * target, dim=(-2, -1))
    b1 = torch.sum(mask * target, dim=(-2, -1))
    det = a00 * a11 - a01 * a01
    valid = det > 0
    safe = torch.where(valid, det, torch.ones_like(det))
    zero = torch.zeros_like(det)
    scale = torch.where(valid, (a11 * b0 - a01 * b1) / safe, zero)
    shift = torch.where(valid, (-a01 * b0 + a00 * b1) / safe, zero)
    return scale, shift


def gradient_loss(prediction, target, mask):
    """Masked image-gradient consistency: the absolute x and y differences
    of the masked residual, where both pixels are masked, over the mask's
    size."""
    diff = (prediction - target) * mask
    gx = torch.abs(diff[..., :, 1:] - diff[..., :, :-1])
    mx = mask[..., :, 1:] * mask[..., :, :-1]
    gy = torch.abs(diff[..., 1:, :] - diff[..., :-1, :])
    my = mask[..., 1:, :] * mask[..., :-1, :]
    denom = torch.sum(mask, dim=(-2, -1)).clamp_min(1.0)
    return (torch.sum(gx * mx, dim=(-2, -1)) / denom
            + torch.sum(gy * my, dim=(-2, -1)) / denom)


def _mask_coords(mask: torch.Tensor):
    """The (y, x) of the nonzero mask pixels in row-major order, first in
    an [H·W] table (the other pixels follow): ``jnp.nonzero(mask,
    size=H*W, fill_value=0)``'s table wherever ``extract_patches`` reads
    it. A stable sort, so that the card need not wait for the count (a
    nonzero() would)."""
    H, W = mask.shape
    flat = (mask != 0).reshape(-1)
    order = torch.sort((~flat).to(torch.uint8), stable=True).indices
    return order // W, order % W


def draw_patch_idx(mask: torch.Tensor, n_patches: int,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """n_patches uniform draws from [0, count of mask pixels > 0) (from
    [0, 1) when the mask is empty): the positions in the mask's pixel table
    of the patch centres. A JaxKey draws the JAX package's ``randint``."""
    count = torch.sum(mask > 0).clamp_min(1)
    if jr.is_jax(generator):
        return jr.randint(generator, (n_patches,), 0, count, mask.device)
    u = torch.rand(n_patches, generator=generator, device=mask.device)
    return torch.minimum((u * count).long(), count - 1)


def extract_patches(img: torch.Tensor, mask: torch.Tensor, patch_len: int,
                    n_patches: int,
                    generator: Optional[torch.Generator] = None,
                    idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Square patches [n, pl, pl, C] of img [H, W, C] centred on mask pixels
    (the LPIPS patch loss's sampling), pl = min(patch_len, H, W): centre k
    is pixel idx[k] of the mask's row-major pixel table, moved inside the
    image. idx: injected draws [n_patches], else ``draw_patch_idx``."""
    H, W = img.shape[:2]
    pl = min(patch_len, H, W)
    ys, xs = _mask_coords(mask)
    if idx is None:
        idx = draw_patch_idx(mask, n_patches, generator)
    idx = torch.as_tensor(idx, device=img.device).long()
    sy = torch.clamp(ys[idx] - pl // 2, 0, H - pl)
    sx = torch.clamp(xs[idx] - pl // 2, 0, W - pl)
    r = torch.arange(pl, device=img.device)
    rows, cols = sy[:, None] + r, sx[:, None] + r
    return img[rows[:, :, None], cols[:, None, :]]
