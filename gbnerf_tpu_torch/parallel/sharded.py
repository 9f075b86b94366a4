"""Mesh-sharded train and render steps (data parallelism over the ranks).

Port of gbnerf_tpu/parallel/sharded.py: parameters replicated, the ray
batches split by rows over the mesh's ``data`` axis, the per-ray maps
gathered back (train/step.py::shard_render) and the gradients averaged
over the ranks. The same step runs in one process (mesh None) or N.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..config import Config
from ..train.state import TrainState, adam_step, lr_schedule
from ..train.step import make_render_fn, make_train_step_stage1, shard_render
from .mesh import DeviceMesh, average_grads


def make_sharded_train_step(cfg: Config, coarse_model, fine_model,
                            near: float, far: float,
                            mesh: Optional[DeviceMesh], axis="data",
                            hwf=None):
    """Stage-1 (DS-NeRF) train step over the mesh: step(state, batch,
    generator=None) → (state, metrics), with pre-assembled global batches
    ({"clf": {o, d, target}, "inp": ..., "depth": ...}; inp and depth may
    be None) and the JAX sharded step's loss: the rgb and rgb0 terms, the
    inpainted disparity at depth_lambda and the COLMAP weighted depth at
    sdepth_lambda (its σ and TV terms are off). One Adam step at
    lr_schedule(state.step), in place. The JAX function returns (step,
    jit_step, shardings); the port has nothing to jit or place."""
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, sigma_loss_weight=0.0, tv_loss_weight=0.0))
    loss_fn = make_train_step_stage1(cfg, coarse_model, fine_model, near,
                                     far, mesh=mesh, mesh_axis=axis,
                                     hwf=hwf).loss_fn
    schedule = lr_schedule(cfg)
    fields = [m for m in (coarse_model, fine_model) if m is not None]
    params = [p for f in fields for p in f.parameters()]

    def step(state: TrainState, batch, generator=None):
        state.optimizer.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(batch, generator)
        loss.backward()
        average_grads(params, mesh)
        adam_step(state, schedule)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        return state, metrics

    return step


def make_sharded_renderer(cfg: Config, coarse_model, fine_model,
                          near: float, far: float,
                          mesh: Optional[DeviceMesh], axis="data", hwf=None):
    """Eval renderer with the ray axis split over the mesh: render_flat(
    rays_o [N, 3], rays_d) → {"rgb", "disp", "depth"}, the whole maps on
    every rank (gathered), without gradients."""
    render = shard_render(make_render_fn(cfg, coarse_model, fine_model, near,
                                         far, hwf=hwf), mesh, axis)

    @torch.no_grad()
    def render_flat(rays_o: torch.Tensor, rays_d: torch.Tensor):
        out = render(rays_o, rays_d, None, train=False)
        return {"rgb": out.rgb, "disp": out.disp, "depth": out.depth}

    return render_flat
