"""Normal maps from rendered depth.

Port of gbnerf_tpu/core/normals.py (``depth2xyz``, ``_box_sum``,
``depth2normal_geo``, ``render_normal_map``). The per-pixel least-squares
plane fit over a k×k window, n = (AᵀA)⁻¹ Aᵀ1 with A the window's points
(the reference's 961-wide unfold at k = 31), is computed as in the JAX
package: AᵀA = Σ ppᵀ and Aᵀ1 = Σ p are 9 windowed-sum channels from an
integral image (two cumsum-difference passes, O(HW) for any k; zero
padding), then a closed-form adjugate solve. Differentiable: it feeds the
normal-map SDS term. Also ``pointcloud_normals`` (numpy and scipy's
cKDTree, on the host), ``field_normals`` (−∇σ by autograd) and
``estimate_normals_grad`` (finite differences of a depth map).
"""
from __future__ import annotations

import torch


def depth2xyz(depth: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Back-project a depth map [H, W] (z depth) through the intrinsics
    K [3, 3] to camera-space points [H, W, 3]."""
    H, W = depth.shape
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    h = torch.arange(H, dtype=depth.dtype, device=depth.device)[:, None]
    w = torch.arange(W, dtype=depth.dtype, device=depth.device)[None, :]
    x = (w - cx) * depth / fx
    y = (h - cy) * depth / fy
    return torch.stack([x, y, depth], dim=-1)


def _box_sum(x: torch.Tensor, k: int) -> torch.Tensor:
    """Windowed sums over k×k neighbourhoods, zero outside: x [H, W, C] →
    [H, W, C] with out[i, j] = Σ_{|di|,|dj| ≤ k//2} x[i+di, j+dj] over
    in-bounds entries. Two cumulative-sum difference passes; the cumsum is
    padded in front with zeros and at the back with its last value (the
    saturated total), so windows past the bottom or right edge sum exactly
    their in-bounds entries, also when k exceeds the map."""
    r = k // 2

    def along(axis: int, v: torch.Tensor) -> torch.Tensor:
        c = torch.cumsum(v, dim=axis)
        n = v.shape[axis]
        zeros_shape = list(v.shape)
        zeros_shape[axis] = r + 1
        reps = [1] * v.dim()
        reps[axis] = r
        c = torch.cat([torch.zeros(zeros_shape, dtype=v.dtype,
                                   device=v.device), c,
                       c.narrow(axis, n - 1, 1).repeat(reps)], dim=axis)
        return c.narrow(axis, 2 * r + 1, n) - c.narrow(axis, 0, n)

    return along(1, along(0, x))


def depth2normal_geo(points: torch.Tensor, k: int = 31,
                     eps: float = 1e-8) -> torch.Tensor:
    """Least-squares plane normals from a camera-space point map [H, W, 3]
    → [H, W, 3], not unit-normalised (callers map (n + 1)/2 to RGB).

    Two guards, as in the JAX package: 1/det goes through a double where,
    so that an exactly singular window gives a zero normal and a finite
    (zero) gradient instead of 0·inf; and the singularity floor is relative
    to the matrix scale ((tr M / 3)³), with an absolute 1e-12 below it.
    """
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    chans = torch.stack([x * x, x * y, x * z, y * y, y * z, z * z, x, y, z],
                        dim=-1)
    s = _box_sum(chans, k)
    mxx, mxy, mxz, myy, myz, mzz = (s[..., i] for i in range(6))
    sx, sy, sz = s[..., 6], s[..., 7], s[..., 8]

    c00 = myy * mzz - myz * myz
    c01 = mxz * myz - mxy * mzz
    c02 = mxy * myz - mxz * myy
    c11 = mxx * mzz - mxz * mxz
    c12 = mxy * mxz - mxx * myz
    c22 = mxx * myy - mxy * mxy
    det = mxx * c00 + mxy * c01 + mxz * c02
    scale3 = ((mxx + myy + mzz) / 3.0) ** 3
    floor = torch.clamp(eps * scale3, min=1e-12)
    bad = torch.abs(det) <= floor
    safe_det = torch.where(bad, torch.ones_like(det), det)
    inv_det = torch.where(bad, torch.zeros_like(det), 1.0 / safe_det)

    nx = (c00 * sx + c01 * sy + c02 * sz) * inv_det
    ny = (c01 * sx + c11 * sy + c12 * sz) * inv_det
    nz = (c02 * sx + c12 * sy + c22 * sz) * inv_det
    return torch.stack([nx, ny, nz], dim=-1)


def render_normal_map(depth: torch.Tensor, K: torch.Tensor,
                      k: int = 31) -> torch.Tensor:
    """depth [H, W] → the [0, 1]-mapped normal image [H, W, 3]."""
    return (depth2normal_geo(depth2xyz(depth, K), k=k) + 1.0) / 2.0


def pointcloud_normals(points, knn: int = 30):
    """kNN + SVD point-cloud normals: numpy [N, 3] → [N, 3] unit normals,
    the smallest-variance direction of each point's ``knn`` neighbours.
    Host-side numpy with scipy's cKDTree (imported here, when called)."""
    import numpy as np
    from scipy.spatial import cKDTree

    tree = cKDTree(points)
    _, idxs = tree.query(points, k=knn)
    nb = points[idxs]                              # [N, k, 3]
    centered = nb - nb.mean(axis=1, keepdims=True)
    cov = np.einsum("nki,nkj->nij", centered, centered)
    # eigh: ascending eigenvalues → the first eigenvector is the normal
    _, vecs = np.linalg.eigh(cov)
    n = vecs[:, :, 0]
    return n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)


def field_normals(sigma_fn, pts: torch.Tensor) -> torch.Tensor:
    """Analytic density-gradient normals n = −∇σ/‖∇σ‖ at pts [..., 3].

    sigma_fn: a batched σ, [N, 3] points → [N], in which each σ depends on
    its own point only (a field's σ head is): then the gradient of Σσ with
    respect to the points is each point's own ∇σ, which is what the JAX
    package's vmap of grad over [3] → scalar computes. One backward pass
    (K5 with its point gradient for a σ-only CP field on the card).
    """
    with torch.enable_grad():
        p = pts.reshape(-1, 3).detach().requires_grad_(True)
        (g,) = torch.autograd.grad(sigma_fn(p).sum(), p)
    n = -g / torch.clamp(torch.linalg.norm(g, dim=-1, keepdim=True),
                         min=1e-8)
    return n.reshape(pts.shape)


def estimate_normals_grad(depth: torch.Tensor) -> torch.Tensor:
    """Cheap gradient normals of a depth map [H, W] → [H, W, 3] in [0, 1]:
    central differences inside, one-sided first-order at the edges (as
    jnp.gradient)."""
    gx = torch.gradient(depth, dim=1, edge_order=1)[0]
    gy = torch.gradient(depth, dim=0, edge_order=1)[0]
    n = torch.stack([-gx, -gy, torch.ones_like(depth)], dim=-1)
    return (n + 1.0) / 2.0
