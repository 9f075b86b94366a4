"""Render functions of the eval path.

Port of the render half of gbnerf_tpu/train/step.py: ``make_render_fn``
(with its NDC and non-NDC branches), ``make_image_renderer`` and
``_full_view_rays``. The frozen-σ field (``alpha=``) and the train steps
come with training.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..config import Config
from ..core.fields import make_field_fn
from ..core.rays import ndc_rays
from ..core.render import RenderOutputs, render_rays, render_rays_blocked


def make_render_fn(cfg: Config, coarse_model, fine_model, near: float,
                   far: float, hwf=None):
    """Build render(rays_o, rays_d, generator=None, *, train) → RenderOutputs.

    near/far are scene constants. With no_ndc=False the rays are mapped
    through ndc_rays (near plane 1) and marched over [0, 1], with viewdirs
    from the world-space directions; that needs hwf = (H, W, focal).
    At eval (train=False) the coarse pass is σ-only, with no jitter or noise.
    """
    r = cfg.render
    use_ndc = not r.no_ndc
    if use_ndc:
        if hwf is None:
            raise ValueError("no_ndc=False needs hwf=(H, W, focal) — the "
                             "NDC frustum is shaped by the intrinsics")
        ndc_H, ndc_W, ndc_focal = int(hwf[0]), int(hwf[1]), float(hwf[2])
        near, far = 0.0, 1.0
    coarse_fn = make_field_fn(coarse_model)
    fine_fn = make_field_fn(fine_model) if fine_model is not None else None

    def render(rays_o: torch.Tensor, rays_d: torch.Tensor,
               generator: Optional[torch.Generator] = None, *,
               train: bool) -> RenderOutputs:
        viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        if use_ndc:
            rays_o, rays_d = ndc_rays(ndc_H, ndc_W, ndc_focal, 1.0,
                                      rays_o, rays_d)
        shape = rays_o.shape[:-1] + (1,)
        n = torch.full(shape, near, dtype=rays_o.dtype, device=rays_o.device)
        f = torch.full(shape, far, dtype=rays_o.dtype, device=rays_o.device)
        return render_rays(
            coarse_fn, fine_fn, rays_o, rays_d, viewdirs, n, f,
            N_samples=r.N_samples, N_importance=r.N_importance,
            lindisp=r.lindisp, perturb=train and r.perturb > 0.0,
            raw_noise_std=r.raw_noise_std if train else 0.0,
            white_bkgd=r.white_bkgd, generator=generator,
            coarse_sigma_only=not train)

    return render


def make_image_renderer(render_fn, *, block: int = 8192):
    """Full-image renderer: (rays_o [H,W,3], rays_d) → {rgb, disp, depth,
    acc} maps [H, W, ...], rendered block by block without gradients."""

    @torch.no_grad()
    def render(rays_o: torch.Tensor, rays_d: torch.Tensor):
        H, W = rays_o.shape[:2]

        def block_fn(rays):
            out = render_fn(rays["o"], rays["d"], None, train=False)
            return {"rgb": out.rgb, "disp": out.disp, "depth": out.depth,
                    "acc": out.acc}

        flat = {"o": rays_o.reshape(-1, 3), "d": rays_d.reshape(-1, 3)}
        out = render_rays_blocked(block_fn, flat, block_size=block)
        return {k: v.reshape((H, W) + v.shape[1:]) for k, v in out.items()}

    return render


def _full_view_rays(H: int, W: int, focal: float, pose: torch.Tensor):
    """All H×W rays of one camera pose [3, 4]+ → rays_o, rays_d [H, W, 3]."""
    dev = pose.device
    j = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    i = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    x = (i - W * 0.5) / focal
    y = -(j - H * 0.5) / focal
    dirs = torch.stack([x.expand(H, W), y.expand(H, W),
                        -torch.ones((H, W), device=dev)], dim=-1)
    rays_d = torch.sum(dirs[..., None, :] * pose[:3, :3], dim=-1)
    rays_o = pose[:3, -1].expand(rays_d.shape)
    return rays_o, rays_d
