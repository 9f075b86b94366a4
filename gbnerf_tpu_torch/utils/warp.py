"""Cross-view reprojection: warp view A's pixels into view B through A's
rendered depth.

Port of gbnerf_tpu/utils/warp.py on tensors (any device): back-project
A's pixels with its depth, move them A → world → B, project into B, and
report the coordinates with their validity.
"""
from __future__ import annotations

import torch


def reproject(depth_a: torch.Tensor, K: torch.Tensor, c2w_a: torch.Tensor,
              c2w_b: torch.Tensor):
    """Warp every pixel of view A into view B using A's depth.

    OpenGL cameras (x right, y up, z backward; rays along −z).
    depth_a [H, W] (depth along −z of camera A), K [3, 3] (both views),
    c2w_a, c2w_b [3, 4] → coords_b [H, W, 2] (x, y) in B, depth_b [H, W]
    in B's frame, valid [H, W] bool (in front of B, inside its image).
    """
    H, W = depth_a.shape
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    j = torch.arange(H, dtype=depth_a.dtype, device=depth_a.device)[:, None]
    i = torch.arange(W, dtype=depth_a.dtype, device=depth_a.device)[None, :]
    # A's camera-space points (z backward: the points lie at −depth)
    x = (i - cx) * depth_a / fx
    y = -(j - cy) * depth_a / fy
    pts_a = torch.stack([x, y, -depth_a], dim=-1)
    world = pts_a @ c2w_a[:3, :3].T + c2w_a[:3, 3]
    pts_b = (world - c2w_b[:3, 3]) @ c2w_b[:3, :3]     # R_bᵀ · (p − t_b)

    depth_b = -pts_b[..., 2]
    eps = 1e-8
    u = fx * pts_b[..., 0] / torch.clamp(depth_b, min=eps) + cx
    v = -fy * pts_b[..., 1] / torch.clamp(depth_b, min=eps) + cy
    valid = ((depth_b > eps) & (u >= 0) & (u <= W - 1)
             & (v >= 0) & (v <= H - 1))
    return torch.stack([u, v], dim=-1), depth_b, valid


def bilinear_sample(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Sample img [H, W, C] at float (x, y) coords [..., 2], clamped to the
    border → [..., C]."""
    H, W = img.shape[:2]
    x = torch.clamp(coords[..., 0], 0.0, W - 1.0)
    y = torch.clamp(coords[..., 1], 0.0, H - 1.0)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    v00, v01 = img[y0, x0], img[y0, x1]
    v10, v11 = img[y1, x0], img[y1, x1]
    return ((1 - fy) * ((1 - fx) * v00 + fx * v01)
            + fy * ((1 - fx) * v10 + fx * v11))
