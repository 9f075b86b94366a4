"""Render functions and the stage-1 train step.

Port of gbnerf_tpu/train/step.py: ``make_render_fn`` (with its NDC and
non-NDC branches), ``make_image_renderer``, ``_full_view_rays``,
``_sigma_depth_loss`` and ``make_train_step_stage1``. Not ported yet: the
frozen-σ field (``alpha=``), the data mesh (``mesh=``) and stage 2.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..config import Config
from ..core.fields import make_field_fn
from ..core.rays import ndc_rays
from ..core.render import RenderOutputs, render_rays, render_rays_blocked
from ..data.rays_bank import sample_batch
from ..utils.metrics import img2mse, mse2psnr, weighted_mse
from .losses import cp_tv_loss, sigma_loss
from .state import TrainState, adam_step, lr_schedule


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


def _sigma_depth_loss(cfg: Config, coarse_model, fine_model, dep, near,
                      generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
    """DS-NeRF σ-likelihood on COLMAP-depth rays, on the fine field (the
    reference's SigmaLoss, built at run.py:2122-2124 on the fine network).

    Divergence kept from the JAX package: the reference computes this term
    but its shipped loop never adds it to the loss; here it is added with
    weight sigma_loss_weight. The loss reads only σ, so the field is called
    σ-only (K2 forward and K5 backward on the card): σ and its gradients
    are those of the full call, bit for bit, without the colour head.
    """
    r = cfg.render
    fn = make_field_fn(fine_model if fine_model is not None else coarse_model)
    viewdirs = dep["d"] / torch.linalg.norm(dep["d"], dim=-1, keepdim=True)
    per_ray = sigma_loss(lambda pts, vd: fn(pts, vd, sigma_only=True),
                         dep["o"], dep["d"], viewdirs, near,
                         dep["target"][:, 0], N_samples=r.N_samples,
                         perturb=r.perturb > 0.0,
                         raw_noise_std=r.raw_noise_std, generator=generator)
    return torch.mean(per_ray)


def make_train_step_stage1(cfg: Config, coarse_model, fine_model,
                           near: float, far: float, alpha=None, mesh=None,
                           hwf=None):
    """DS-NeRF batched training step (the reference's first_stage path).

    step(state, banks, generator=None, idx=None) → (state, metrics):
    samples N_rand rays from each stream (``idx`` may inject the draws, a
    dict keyed like ``batches``), computes the loss, backpropagates (K4 on
    the card), takes one Adam step at lr_schedule(state.step) and updates
    ``state`` in place. ``step.loss_fn(batches, generator=None)`` →
    (loss, metrics) is exposed for the loss tests, as in the JAX package.
    hwf: training intrinsics, required only for the NDC path.
    """
    if alpha is not None:
        raise NotImplementedError("the frozen-σ field (alpha=) is not ported "
                                  "yet")
    if mesh is not None:
        raise NotImplementedError("the data mesh (mesh=) is not ported yet: "
                                  "the port trains on one device")
    render = make_render_fn(cfg, coarse_model, fine_model, near, far, hwf=hwf)
    schedule = lr_schedule(cfg)
    t, d = cfg.train, cfg.data
    fields = [m for m in (coarse_model, fine_model) if m is not None]

    def loss_fn(batches: Dict[str, Optional[Dict[str, torch.Tensor]]],
                generator: Optional[torch.Generator] = None):
        clf = batches["clf"]
        out = render(clf["o"], clf["d"], generator, train=True)
        img_loss = img2mse(out.rgb, clf["target"])
        loss = img_loss
        if out.rgb0 is not None:
            loss = loss + img2mse(out.rgb0, clf["target"])

        # Divergences kept from the JAX package (train/step.py there): the
        # inpainted-depth stream is rendered and scored against its own
        # targets, the coarse rgb0 term is added, and the COLMAP weighted
        # depth and σ terms are wired into the loss.
        zero = torch.zeros((), device=clf["o"].device)
        inp = batches.get("inp")
        depth_loss = zero
        if inp is not None:
            out_i = render(inp["o"], inp["d"], generator, train=True)
            depth_loss = img2mse(out_i.disp, inp["target"][:, 0])
            loss = loss + d.depth_lambda * depth_loss

        dep = batches.get("depth")
        sig_loss = col_loss = zero
        if dep is not None:
            out_d = render(dep["o"], dep["d"], generator, train=True)
            col_loss = weighted_mse(out_d.depth, dep["target"][:, 0],
                                    dep["target"][:, 1])
            loss = loss + d.sdepth_lambda * col_loss
            if t.sigma_loss_weight > 0:
                sig_loss = _sigma_depth_loss(cfg, coarse_model, fine_model,
                                             dep, near, generator)
                loss = loss + t.sigma_loss_weight * sig_loss

        if t.tv_loss_weight > 0:
            loss = loss + t.tv_loss_weight * cp_tv_loss(fields)

        return loss, {"img_loss": img_loss, "depth_loss": depth_loss,
                      "col_loss": col_loss, "sigma_loss": sig_loss,
                      "psnr": mse2psnr(img_loss)}

    def step(state: TrainState, banks, generator=None, idx=None):
        idx = idx or {}
        batches = {
            "clf": sample_batch(banks["rgb_clf"], t.N_rand, generator,
                                idx.get("clf")),
            "inp": sample_batch(banks["inp"], t.N_rand, generator,
                                idx.get("inp")),
            "depth": (sample_batch(banks["depth"], t.N_rand, generator,
                                   idx.get("depth"))
                      if banks.get("depth") is not None else None),
        }
        state.optimizer.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(batches, generator)
        loss.backward()
        adam_step(state, schedule)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        return state, metrics

    step.loss_fn = loss_fn
    return step
