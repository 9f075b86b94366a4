#!/usr/bin/env python
"""Multi-rank dry run: one step of each parallel path on N ranks.

The port's counterpart of __graft_entry__.py::dryrun_multichip. It spawns
N ranks (torch.multiprocessing, a process group on localhost) and runs,
at the JAX entry's small shapes:
  1. one sharded stage-1 step (make_sharded_train_step) of the hash-grid
     flagship (2^14 table, 16 + 8 samples, 8 rays a rank, all three
     supervision streams), the ranks' parameters equal after it, and the
     sharded eval render (make_sharded_renderer) equal to the unsharded;
  2. with N ≥ 4 and even, the same with the CP flagship over a 2 × N/2
     (dcn, data) mesh;
  3. one stage-2 step on the data mesh (masked inpainting, composite,
     normal map and colla views through a toy guidance);
  4. the tiny SD stack's score-distillation step with its UNet and VAE
     tensor-parallel over a (data, model) mesh with model 2 (N even);
  5. one data-parallel LoRA step, one sample a rank.
Each prints the JAX entry's ``dryrun_multichip …: ok`` line (rank 0).

    python -m gbnerf_tpu_torch.tools.dryrun_multichip [N] [--device cuda]
        [--dist_backend nccl|gloo]

On one card, the ranks share it through ``--dist_backend gloo``.
"""
from __future__ import annotations

import argparse
import math
import dataclasses
import os
import socket

import torch


def _flagship_cfg(small_table: bool = False, field_type: str = "cp"):
    from ..config import Config, FieldConfig, RenderConfig

    field = FieldConfig(no_tcnn=False, field_type=field_type, cp_bound=8.0,
                        cp_resolutions_coarse=(17, 33, 65),
                        cp_rank_coarse=8,
                        log2_hashmap_size=14 if small_table else 19)
    render = RenderConfig(N_samples=64, N_importance=64, lindisp=True,
                          white_bkgd=True, raw_noise_std=0.0)
    return Config(field=field, render=render)


def _rays(g, n, extra, device):
    o = torch.randn((n, 3), generator=g) * 0.1
    d = torch.randn((n, 3), generator=g)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    t = torch.rand((n, extra), generator=g)
    return {"o": o.to(device), "d": d.to(device), "target": t.to(device)}


def _params_agree(modules) -> bool:
    """Every rank holds the same parameters after the step (the gradient
    all-reduce ran): rank 0's broadcast equals each rank's own."""
    import torch.distributed as dist

    flat = torch.cat([p.detach().reshape(-1).float() for m in modules
                      for p in m.parameters()])
    ref = flat.clone()
    dist.broadcast(ref, src=0)
    ok = torch.tensor([float(torch.equal(ref, flat))], device=flat.device)
    dist.all_reduce(ok, op=dist.ReduceOp.MIN)
    return bool(ok.item())


def _stage1(n, device, lead, mesh=None, axis="data", label=None):
    from ..config import TrainConfig
    from ..parallel.mesh import data_sharding, make_mesh
    from ..parallel.sharded import (make_sharded_renderer,
                                    make_sharded_train_step)
    from ..train.state import create_train_state

    hash_field = mesh is None
    cfg = _flagship_cfg(small_table=True,
                        field_type="hash" if hash_field else "cp")
    cfg = dataclasses.replace(
        cfg, render=dataclasses.replace(cfg.render, N_samples=16,
                                        N_importance=8),
        train=TrainConfig(N_rand=8 * n))
    mesh = mesh if mesh is not None else make_mesh()
    state, coarse, fine = create_train_state(
        cfg, torch.Generator().manual_seed(0), device)
    step = make_sharded_train_step(cfg, coarse, fine, 1.2, 5.3, mesh, axis)
    g = torch.Generator().manual_seed(2)
    N = cfg.train.N_rand
    batch = {"clf": _rays(g, N, 3, device), "inp": _rays(g, N, 1, device),
             "depth": _rays(g, N, 2, device)}
    state, m = step(state, batch)
    loss = float(m["loss"])
    if not torch.isfinite(m["loss"]):
        raise RuntimeError(f"non-finite loss in dryrun: {loss}")
    if not _params_agree([coarse, fine]):
        raise RuntimeError("the ranks' parameters differ after the step")
    # the eval renderer with the rays split over the mesh: every rank gets
    # the whole maps, those of one unsharded render
    rays = batch["clf"]
    maps = make_sharded_renderer(cfg, coarse, fine, 1.2, 5.3, mesh, axis)(
        rays["o"], rays["d"])
    ref = make_sharded_renderer(cfg, coarse, fine, 1.2, 5.3, None)(
        rays["o"], rays["d"])
    for k, v in ref.items():
        if not torch.allclose(maps[k], v, rtol=1e-5, atol=1e-6):
            raise RuntimeError(f"the sharded render's {k} differs")
    shard = data_sharding(mesh, N, axis)
    if lead:
        shape = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
        head = label or f"dryrun_multichip({n})"
        print(f"{head}: ok, loss={loss:.4f}, mesh={shape}, "
              f"shard=({shard.rows}, 3)/({N}, 3), grad all-reduce present",
              flush=True)


def _stage2(n, device, lead):
    from ..config import GuidanceConfig, TrainConfig
    from ..parallel.mesh import make_mesh
    from ..train.state import create_train_state
    from ..train.step import make_train_step_stage2
    from .parallel_check import toy_guidance

    mesh = make_mesh()
    H, W, focal = 16, 24, 20.0
    n_img, K = 3, 2 * n
    cfg = _flagship_cfg(field_type="cp")
    cfg = dataclasses.replace(
        cfg, render=dataclasses.replace(cfg.render, N_samples=8,
                                        N_importance=4),
        train=TrainConfig(N_rand=4 * n),
        guidance=GuidanceConfig(is_rgb_guidance=True, is_normal_guidance=True,
                                is_colla_guidance=True, normal_start_iter=0,
                                normalmap_render_factor=4))
    state, coarse, fine = create_train_state(
        cfg, torch.Generator().manual_seed(0), device)
    step = make_train_step_stage2(cfg, coarse, fine, 1.2, 5.3, (H, W, focal),
                                  guidance_fn=toy_guidance, mesh=mesh)
    g = torch.Generator().manual_seed(6)
    scene_dev = {
        "images": torch.rand((n_img, H, W, 3), generator=g),
        "masks": (torch.rand((n_img, H, W), generator=g) < 0.3).float(),
        "mask_coords": torch.stack(
            [torch.randint(0, W, (n_img, K), generator=g),
             torch.randint(0, H, (n_img, K), generator=g)], -1),
        "mask_valid": torch.ones((n_img, K), dtype=torch.bool),
        "poses": torch.eye(4)[None, :3, :4].repeat(n_img, 1, 1)}
    scene_dev = {k: v.to(device) for k, v in scene_dev.items()}
    N = cfg.train.N_rand
    banks = {"rgb_clf": _rays(g, N, 3, device), "inp": _rays(g, N, 1, device),
             "depth": _rays(g, N, 2, device)}
    gen = torch.Generator(device=device).manual_seed(8)
    state, m = step(state, scene_dev, banks, gen)
    loss, sds = float(m["loss"]), float(m["sds_loss"])
    if not torch.isfinite(m["loss"]):
        raise RuntimeError(f"non-finite loss in stage-2 dryrun: {loss}")
    if not sds > 0.0:
        raise RuntimeError("guidance path did not run")
    if lead:
        print(f"dryrun_multichip stage2: ok, loss={loss:.4f}, sds={sds:.4f}, "
              f"mesh={{'data': {n}}}", flush=True)


def _tiny_sd(device, mesh=None, tp=False):
    from .parallel_check import build_sd

    return build_sd({"sd": "tiny", "seed": 0, "latent_size": 64, "tp": tp},
                    device, mesh)


def _tp_guidance(n, device, lead):
    from ..guidance.stable import sd_train_step
    from ..parallel.mesh import make_mesh_2d
    from ..parallel.tp import sharded_bytes_per_device

    mesh = make_mesh_2d(n // 2, 2, axes=("data", "model"))
    gcfg, mods = _tiny_sd(device, mesh, tp=True)
    g = torch.Generator().manual_seed(1)
    rgb = torch.rand((64, 64, 3), generator=g).to(device)
    m = (torch.rand((64, 64), generator=g) > 0.6).float().to(device)
    gen = torch.Generator(device=device).manual_seed(5)
    val = float(sd_train_step(mods, gcfg, 700, rgb, m, gen,
                              embeds=mods.embeds_rgb, guidance_scale=7.5,
                              mode="csd"))
    if not math.isfinite(val):
        raise RuntimeError(f"non-finite TP guidance loss: {val}")
    per_rank = sharded_bytes_per_device(mods.unet, mesh)
    if lead:
        print(f"dryrun_multichip tp-guidance: ok, loss={val:.4f}, "
              f"mesh={{'data': {n // 2}, 'model': 2}}, unet bytes a rank "
              f"{per_rank}", flush=True)


def _lora_dp(n, device, lead):
    from ..parallel.mesh import make_mesh
    from ..train.lora_trainer import make_lora_train_step

    mesh = make_mesh()
    _, mods = _tiny_sd(device)
    init_fn, step = make_lora_train_step(mods, rank=4, lr=1e-3, mesh=mesh)
    ad, opt = init_fn(torch.Generator(device=device).manual_seed(1))
    B, S = n, 64
    g = torch.Generator().manual_seed(2)
    batch = {"image": (torch.rand((B, S, S, 3), generator=g) * 255).to(
                 torch.uint8).to(device),
             "mask": (torch.rand((B, S, S), generator=g) > 0.6).to(
                 torch.uint8).to(device),
             "embeds": torch.randn((B, 77, 32), generator=g).to(device),
             "instance_mask": None}
    m = step(ad, opt, batch, torch.Generator(device=device).manual_seed(3))
    loss = float(m["loss"])
    if not torch.isfinite(m["loss"]):
        raise RuntimeError(f"non-finite LoRA dryrun loss: {loss}")
    if lead:
        print(f"dryrun_multichip lora-dp: ok, loss={loss:.4f}, "
              f"mesh={{'data': {n}}}, batch shard=(1, {S}, {S}, 3)/"
              f"({B}, {S}, {S}, 3)", flush=True)


def _rank(index: int, n: int, port: int, device: str, backend) -> None:
    import torch.distributed as dist

    from ..parallel.mesh import init_distributed, make_mesh_2d

    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(index), WORLD_SIZE=str(n),
                      LOCAL_RANK=str(index))
    torch.set_num_threads(1)
    dev = init_distributed(device, backend)
    if dev.type == "cuda":
        from ..ops import _build

        _build.load_library()
    lead = index == 0
    try:
        _stage1(n, dev, lead)
        if n >= 4 and n % 2 == 0:
            _stage1(n, dev, lead, make_mesh_2d(2, n // 2),
                    ("dcn", "data"), label="dryrun_multichip 2d")
        _stage2(n, dev, lead)
        if n % 2 == 0:
            _tp_guidance(n, dev, lead)
        _lora_dp(n, dev, lead)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     backend=None) -> None:
    """Spawn n_devices ranks and run the dry run; raises if a rank
    fails."""
    import torch.multiprocessing as mp

    from ..train.loop import device_from_flag

    device_from_flag(device)
    with socket.socket() as s:           # a free port on localhost
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.start_processes(_rank, args=(n_devices, port, device, backend),
                       nprocs=n_devices, start_method="spawn")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=2, help="ranks")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--dist_backend", default=None,
                    help="nccl (default on the card) or gloo (the CPU's; on "
                         "the card it lets the ranks share one)")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n, args.device, args.dist_backend)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
