"""Camera ray generation (pinhole model, NDC reparametrization).

Port of gbnerf_tpu/core/rays.py: OpenGL-style camera (x right, y up,
z backward); pixel (i, j) maps to direction ((i − W/2)/f, −(j − H/2)/f, −1)
rotated by c2w. The 3-wide rotation is a broadcast sum, as in JAX, so both
packages round it the same way.
"""
from __future__ import annotations

import torch


def get_rays(H: int, W: int, focal, c2w: torch.Tensor, *,
             dtype=torch.float32):
    """Full-image ray grid for one camera → rays_o, rays_d, each [H, W, 3]."""
    c2w = c2w.to(dtype)
    j, i = torch.meshgrid(
        torch.arange(H, dtype=dtype, device=c2w.device),
        torch.arange(W, dtype=dtype, device=c2w.device), indexing="ij")
    dirs = torch.stack(
        [(i - W * 0.5) / focal, -(j - H * 0.5) / focal, -torch.ones_like(i)],
        dim=-1)
    rays_d = torch.sum(dirs[..., None, :] * c2w[:3, :3], dim=-1)
    rays_o = c2w[:3, -1].expand(rays_d.shape)
    return rays_o, rays_d


def get_rays_by_coord(H: int, W: int, focal, c2w: torch.Tensor,
                      coords: torch.Tensor):
    """Rays through arbitrary (x, y) pixel coordinates [N, 2] (float), as
    for COLMAP keypoints → rays_o, rays_d, each [N, 3]."""
    x = (coords[:, 0] - W * 0.5) / focal
    y = -(coords[:, 1] - H * 0.5) / focal
    dirs = torch.stack([x, y, -torch.ones_like(x)], dim=-1)
    rays_d = torch.sum(dirs[..., None, :] * c2w[:3, :3].to(dirs.dtype),
                       dim=-1)
    rays_o = c2w[:3, -1].to(dirs.dtype).expand(rays_d.shape)
    return rays_o, rays_d


def ndc_rays(H: int, W: int, focal, near, rays_o: torch.Tensor,
             rays_d: torch.Tensor):
    """Shift rays to the near plane and map them to NDC space."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    ox, oy, oz = rays_o[..., 0], rays_o[..., 1], rays_o[..., 2]
    dx, dy, dz = rays_d[..., 0], rays_d[..., 1], rays_d[..., 2]

    o0 = -1.0 / (W / (2.0 * focal)) * ox / oz
    o1 = -1.0 / (H / (2.0 * focal)) * oy / oz
    o2 = 1.0 + 2.0 * near / oz

    d0 = -1.0 / (W / (2.0 * focal)) * (dx / dz - ox / oz)
    d1 = -1.0 / (H / (2.0 * focal)) * (dy / dz - oy / oz)
    d2 = -2.0 * near / oz

    return torch.stack([o0, o1, o2], -1), torch.stack([d0, d1, d2], -1)
