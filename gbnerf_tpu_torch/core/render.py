"""Volume rendering: alpha compositing and the coarse/fine render pipeline.

Port of gbnerf_tpu/core/render.py:
  - ``raw2outputs``: α = 1 − exp(−relu(σ + noise)·δ·|d|), exclusive-cumprod
    transmittance, weighted rgb/depth/disp/acc, optional white background,
    1e10 terminal interval.
  - ``render_rays``: stratified coarse pass (σ-only at eval) → clamp-sum
    inverse CDF → merge → fine pass → composite.
  - ``render_rays_blocked``: a Python loop over ray blocks, in place of
    JAX's ``lax.map``; the last block may be short, since nothing here needs
    static shapes.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch

from ..ops.resample import merge_sorted_fast, sample_pdf_fast
from ..ops.scan import cumprod_last_exclusive
from ..parallel.mesh import draw
from ..utils import jax_random as jr
from ..utils.profiling import SPAN_RESAMPLE, annotate
from .sampling import merge_z_vals, sample_pdf, stratified_z_vals


class RenderOutputs(NamedTuple):
    """Per-ray composited maps (fine pass unless noted)."""

    rgb: torch.Tensor            # [..., 3]
    disp: torch.Tensor           # [...]
    acc: torch.Tensor            # [...]
    depth: torch.Tensor          # [...]
    weights: torch.Tensor        # [..., S]
    z_vals: torch.Tensor         # [..., S]
    alpha: torch.Tensor          # [..., S]
    rgb0: Optional[torch.Tensor] = None   # coarse maps (when two-pass)
    disp0: Optional[torch.Tensor] = None
    acc0: Optional[torch.Tensor] = None
    depth0: Optional[torch.Tensor] = None
    z_std: Optional[torch.Tensor] = None


def raw2outputs(raw: torch.Tensor, z_vals: torch.Tensor, rays_d: torch.Tensor,
                *, raw_noise_std: float = 0.0,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None,
                white_bkgd: bool = False, detach_weights: bool = False):
    """Composite raw [..., S, 4] into (rgb, disp, acc, weights, depth, alpha).

    noise: optional injected standard-normal σ noise [..., S]; drawn from
    ``generator`` when raw_noise_std > 0 and it is not given.
    """
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], dim=-1)
    dists = dists * torch.linalg.norm(rays_d, dim=-1, keepdim=True)

    rgb = torch.sigmoid(raw[..., :3])
    sigma = raw[..., 3]
    if raw_noise_std > 0.0:
        if noise is None:
            noise = draw("randn", sigma.shape, generator, sigma.dtype,
                         sigma.device)
        sigma = sigma + noise * raw_noise_std

    alpha = 1.0 - torch.exp(-torch.relu(sigma) * dists)
    trans = cumprod_last_exclusive(1.0 - alpha, eps=1e-10)
    weights = alpha * trans
    w = weights.detach() if detach_weights else weights

    rgb_map = torch.sum(w[..., None] * rgb, dim=-2)
    depth_map = torch.sum(weights * z_vals, dim=-1)
    acc_map = torch.sum(weights, dim=-1)
    # expected disparity, clamped to the physical maximum 1/z_near so that
    # empty rays (acc → 0) stay finite (documented divergence of the JAX
    # package from the reference's 1/max(1e-10, depth/acc))
    z_near = z_vals[..., 0]
    disp_map = torch.minimum(
        1.0 / torch.clamp(depth_map / torch.clamp(acc_map, min=1e-10),
                          min=1e-10),
        1.0 / torch.clamp(z_near, min=1e-10))
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])
    return rgb_map, disp_map, acc_map, weights, depth_map, alpha


FieldFn = Callable[..., torch.Tensor]


def render_rays(coarse_fn: FieldFn, fine_fn: Optional[FieldFn],
                rays_o, rays_d, viewdirs, near, far, *,
                N_samples: int, N_importance: int = 0, lindisp: bool = False,
                perturb: bool = False, raw_noise_std: float = 0.0,
                white_bkgd: bool = False, detach_weights: bool = False,
                generator: Optional[torch.Generator] = None,
                fast_resample: bool = True,
                coarse_sigma_only: bool = False) -> RenderOutputs:
    """Hierarchical coarse → fine volume render of a ray batch.

    rays_o, rays_d: [N, 3]; viewdirs: [N, 3] unit; near, far: [N, 1].
    fine_fn None reuses the coarse field for the fine pass. Random draws
    (jitter, σ noise, fine-sample uniforms) come from ``generator``, a
    torch.Generator or a JaxKey, split as the JAX package splits its key:
    (jitter, coarse noise, fine uniforms, fine noise).
    """
    k_strat, k_noise0, k_pdf, k_noise1 = jr.split(generator, 4)
    z_vals = stratified_z_vals(near, far, N_samples, lindisp=lindisp,
                               perturb=perturb, generator=k_strat,
                               dtype=rays_o.dtype)
    z_vals = z_vals.expand(rays_o.shape[:-1] + (N_samples,))

    pts = rays_o[..., None, :] + rays_d[..., None, :] * z_vals[..., :, None]
    # σ-only coarse: at eval the coarse rgb0 maps are unused
    raw = coarse_fn(pts, viewdirs,
                    sigma_only=coarse_sigma_only and N_importance > 0)
    rgb, disp, acc, weights, depth, alpha = raw2outputs(
        raw, z_vals, rays_d, raw_noise_std=raw_noise_std,
        generator=k_noise0, white_bkgd=white_bkgd,
        detach_weights=detach_weights)

    if N_importance <= 0:
        return RenderOutputs(rgb, disp, acc, depth, weights, z_vals, alpha)

    rgb0, disp0, acc0, depth0 = rgb, disp, acc, depth
    z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    with annotate(SPAN_RESAMPLE):
        if fast_resample:
            z_samples = sample_pdf_fast(
                z_mid, weights[..., 1:-1].detach(), N_importance,
                det=not perturb, generator=k_pdf, sorted_u=True).detach()
            z_all = merge_sorted_fast(z_vals, z_samples)
        else:
            z_samples = sample_pdf(
                z_mid, weights[..., 1:-1].detach(), N_importance,
                det=not perturb, generator=k_pdf).detach()
            z_all = merge_z_vals(z_vals, z_samples)

    pts = rays_o[..., None, :] + rays_d[..., None, :] * z_all[..., :, None]
    raw = (fine_fn or coarse_fn)(pts, viewdirs)
    rgb, disp, acc, weights, depth, alpha = raw2outputs(
        raw, z_all, rays_d, raw_noise_std=raw_noise_std,
        generator=k_noise1, white_bkgd=white_bkgd,
        detach_weights=detach_weights)
    z_std = torch.std(z_samples, dim=-1, correction=0)
    return RenderOutputs(rgb, disp, acc, depth, weights, z_all, alpha,
                         rgb0=rgb0, disp0=disp0, acc0=acc0, depth0=depth0,
                         z_std=z_std)


def render_rays_blocked(render_fn: Callable[[Dict[str, torch.Tensor]],
                                            Dict[str, torch.Tensor]],
                        rays: Dict[str, torch.Tensor],
                        block_size: int = 8192) -> Dict[str, torch.Tensor]:
    """Apply a per-block render over a large flat ray set, block by block.

    rays: dict of tensors with the same leading dim N → dict of outputs
    with leading dim N. Bounds the working set to one block.
    """
    n = next(iter(rays.values())).shape[0]
    outs = [render_fn({k: v[s:s + block_size] for k, v in rays.items()})
            for s in range(0, n, block_size)]
    return {k: torch.cat([o[k] for o in outs], dim=0) for k in outs[0]}
