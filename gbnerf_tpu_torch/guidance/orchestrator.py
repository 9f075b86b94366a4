"""Guidance orchestration: orbit view sampling and progressive ranges.

Port of gbnerf_tpu/guidance/orchestrator.py: ``rand_poses`` (random orbit
cameras and their direction classes), ``progressive_ranges`` (the view
ranges widened with the step) and ``ProgressiveViews``. The azimuth feeds
the directional prompts of Perp-Neg (stable.py).

The three uniform draws of ``rand_poses`` (θ, φ, radius) come from a
``torch.Generator``, from a ``JaxKey`` (the JAX package's three bounded
``uniform``s, utils/jax_random.py), or are injected as ``u`` ([3, size]
in [0, 1)).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ..utils import jax_random as jr


def rand_poses(size: int, generator: Optional[torch.Generator] = None, *,
               u: Optional[torch.Tensor] = None, radius_range=(1.0, 1.5),
               theta_range=(0.0, 120.0), phi_range=(0.0, 360.0),
               angle_overhead: float = 30.0, angle_front: float = 60.0,
               device=None, ranges_f32: bool = False):
    """Random orbit camera poses on a spherical shell around the origin →
    (poses [size, 4, 4], dirs [size] direction classes, thetas, phis,
    radii). Classes: 0 front, 1 side, 2 back, 3 side, 4 top, 5 bottom.

    u: the injected uniforms [3, size] (θ, φ, radius), else drawn from
    ``generator`` on ``device``; a JaxKey splits in three and draws each
    with jax's bounded ``uniform``, the bounds in degrees scaled to
    radians in f32 when ``ranges_f32`` (the JAX package's traced ranges
    under progressive_view), else in f64 then rounded, as its Python
    floats are. The ranges may be numbers or 0-d tensors
    (progressive_ranges).
    """
    to_rad = math.pi / 180.0
    if u is None and jr.is_jax(generator):
        def rad(v):
            return (float(torch.tensor(float(v), dtype=torch.float32)
                          * to_rad) if ranges_f32 else float(v) * to_rad)

        bounds = ((rad(theta_range[0]), rad(theta_range[1])),
                  (rad(phi_range[0]), rad(phi_range[1])),
                  (float(radius_range[0]), float(radius_range[1])))
        thetas, phis, radii = (
            jr.uniform(k, (size,), torch.float32, device, lo, hi)
            for k, (lo, hi) in zip(jr.key_split(generator, 3), bounds))
    else:
        if u is None:
            u = torch.rand((3, size), generator=generator, device=device)

        def uniform(ui, lo, hi):
            # jax.random.uniform's affine map: lo + u·(hi − lo)
            return lo + ui * (hi - lo)

        thetas = uniform(u[0], theta_range[0] * to_rad,
                         theta_range[1] * to_rad)
        phis = uniform(u[1], phi_range[0] * to_rad, phi_range[1] * to_rad)
        radii = uniform(u[2], radius_range[0], radius_range[1])
    dev = thetas.device

    centers = torch.stack([radii * torch.sin(thetas) * torch.sin(phis),
                           radii * torch.cos(thetas),
                           radii * torch.sin(thetas) * torch.cos(phis)],
                          dim=-1)
    forward = centers / torch.linalg.norm(centers, dim=-1, keepdim=True)
    up = torch.tensor([0.0, 1.0, 0.0], device=dev).expand(forward.shape)
    right = torch.linalg.cross(up, forward)
    right = right / torch.clamp(torch.linalg.norm(right, dim=-1,
                                                  keepdim=True), min=1e-8)
    up2 = torch.linalg.cross(forward, right)

    poses = torch.zeros((size, 4, 4), device=dev)
    poses[:, 3, 3] = 1.0
    poses[:, :3, 0] = right
    poses[:, :3, 1] = up2
    poses[:, :3, 2] = forward
    poses[:, :3, 3] = centers

    ao, af = angle_overhead * to_rad, angle_front * to_rad
    phis_w = torch.remainder(phis, 2 * math.pi)
    dirs = torch.where(
        thetas <= ao, 4,
        torch.where(thetas >= math.pi - ao, 5,
                    torch.where((phis_w < af / 2)
                                | (phis_w > 2 * math.pi - af / 2), 0,
                                torch.where(torch.abs(phis_w - math.pi)
                                            < af / 2, 2,
                                            torch.where(phis_w < math.pi,
                                                        1, 3)))))
    return poses, dirs, thetas, phis, radii


def progressive_ranges(step_i: int, gcfg, n_iters: int):
    """The per-step view ranges (the reference's nerf/utils.py:264-273):
    r = min(1, init_ratio + 2·ratio) with ratio the step's place between
    exp_start_iter and exp_end_iter (0 → n_iters); each range moves from
    its default view to the full range. Without progressive_view, the full
    ranges. ``step_i`` is a Python int; the pairs are floats, computed in
    f32 as the JAX package's traced scalars are."""
    if not gcfg.progressive_view:
        return gcfg.theta_range, gcfg.phi_range, gcfg.radius_range
    end = gcfg.exp_end_iter or n_iters
    f32 = torch.float32
    ratio = ((torch.tensor(step_i, dtype=f32) - gcfg.exp_start_iter)
             / max(end - gcfg.exp_start_iter, 1))
    r = torch.clamp(gcfg.progressive_view_init_ratio + 2.0 * ratio, max=1.0)

    def lerp(default, full):
        return (float(default * (1.0 - r) + full[0] * r),
                float(default * (1.0 - r) + full[1] * r))

    return (lerp(gcfg.default_polar, gcfg.theta_range),
            lerp(gcfg.default_azimuth, gcfg.phi_range),
            lerp(gcfg.default_radius, gcfg.radius_range))


@dataclass
class ProgressiveViews:
    """Pose sampling ranges widened with the step (nerf/utils.py:264-273)."""

    full_theta: Tuple[float, float] = (0.0, 120.0)
    full_phi: Tuple[float, float] = (0.0, 360.0)
    full_radius: Tuple[float, float] = (1.0, 1.5)
    init_frac: float = 0.2
    expand_iters: int = 5000

    def ranges(self, step: int):
        f = min(self.init_frac + (1.0 - self.init_frac)
                * step / self.expand_iters, 1.0)

        def widen(lo_hi):
            lo, hi = lo_hi
            mid = 0.5 * (lo + hi)
            half = 0.5 * (hi - lo) * f
            return (mid - half, mid + half)

        return widen(self.full_theta), widen(self.full_phi), self.full_radius
