"""How much of a guided ablation arm's field gradient is the
score-distillation term's.

    python -m gbnerf_tpu_torch.tools.sds_grad_share OUT [--arm rand]
        [--s1_steps 1000] [--views 8] [--device cuda] [--smoke]
        [--step_i 10000,19000] [--latent 256] [--H 189 --W 252]
        [--draws torch|jax]

The ablation's scene and configs (tools/run_ablation.py --production
--colmap --lindisp --combine sds: the same text as its arms; ``--smoke``
drops ``--production``, the small-MLP field and scale for CPU runs),
stage 1 for ``--s1_steps`` steps from the arm's seed, then, for
``--views`` stage-2 batches of the arm (each from its own generator seed,
at each of ``--step_i``'s steps, whose annealed t it draws: stage 2's
first and a late step at the ablation's 10k + 10k): the
field gradient of the whole loss, of the loss without the SDS term (the
nog arm's loss on the same batch: the same image, LPIPS and depth terms),
of the SDS term at its weight, and of its two parts in the reference's
form g = w(t)·ε̂ − ε (the UNet's w(t)·ε̂, and −ε, the noise's: zero-mean
and fresh each step). Each is the norm over every field parameter; with
the cosines between the SDS term's gradient and the rest's, and the
latent-space norms of the two parts. ``--draws jax``: stage 1, the
fields' init, the guidance stack and the random VGG are the JAX package's
for the seed, as in ``run_ablation --draws jax``; the measured batches
and their t and ε stay the per-batch torch generators' under both.
Writes OUT/sds_grad_share.json and prints it as one line.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch


def _flat(grads) -> torch.Tensor:
    return torch.cat([g.reshape(-1).double() for g in grads])


def _grad(y: torch.Tensor, params, retain: bool = False) -> torch.Tensor:
    gs = torch.autograd.grad(y, params, retain_graph=retain,
                             allow_unused=True)
    return _flat([torch.zeros_like(p) if g is None else g
                  for p, g in zip(params, gs)])


def _cos(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.dot(a, b) / (a.norm() * b.norm()).clamp_min(1e-300))


@contextlib.contextmanager
def sds_part(part: str, record: list):
    """Within the block, the SDS gradient g = w(t)·ε̂ − ε of every
    injection is cut to one part ("model": w(t)·ε̂; "noise": −ε; "both":
    g unchanged), and each injection's latent-space norms of the two
    parts are appended to ``record``."""
    from ..guidance import stable

    inner = stable.score_distillation_grad

    def cut(noise_pred, noise, w_t, *, mode, standard_sds=False):
        if mode != "sds" or standard_sds:
            raise ValueError("sds_grad_share splits the reference's SDS form "
                             "alone (use_csd = False)")
        model = inner(noise_pred, torch.zeros_like(noise), w_t, mode=mode)
        record.append({"model": float(model.double().norm()),
                       "noise": float(noise.double().norm())})
        return {"both": model - noise, "model": model,
                "noise": -noise}[part]

    stable.score_distillation_grad = cut
    try:
        yield
    finally:
        stable.score_distillation_grad = inner


def main(argv=None):
    from . import run_ablation as abl

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out")
    ap.add_argument("--arm", default="rand",
                    help="a guided arm without a prior or LoRA file "
                         "to train first (rand)")
    ap.add_argument("--s1_steps", type=int, default=1000)
    ap.add_argument("--views", type=int, default=8)
    ap.add_argument("--step_i", default="10000,19000",
                    help="the stage-2 steps whose annealed t is drawn "
                         "(comma-separated)")
    ap.add_argument("--latent", type=int, default=256)
    ap.add_argument("--H", type=int, default=189)
    ap.add_argument("--W", type=int, default=252)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="the ablation's small-MLP field, for CPU runs")
    ap.add_argument("--draws", default="torch", choices=("torch", "jax"),
                    help="stage 1's run and the init of the fields, the "
                         "guidance stack and the VGG: torch generators, "
                         "or the JAX package's draws")
    args = ap.parse_args(argv)

    from ..config import load_reference_config
    from ..train import loop
    from ..train.state import create_train_state
    from ..train.step import make_train_step_stage2, select_stage2_view

    out = os.path.abspath(args.out)
    os.makedirs(os.path.join(out, "logs"), exist_ok=True)
    ns = abl.parse_args(
        [out, "--colmap", "--lindisp", "--combine", "sds", "--latent",
         str(args.latent), "--iters1", str(args.s1_steps), "--iters2",
         str(args.views), "--H", str(args.H), "--W", str(args.W),
         "--n_train", "16", "--n_test", "3", "--lora_steps", "1"]
        + ([] if args.smoke else ["--production"]))
    paths = abl.write_configs(out, ns, ("s1", args.arm))
    scene_dir = os.path.join(out, "scene")
    if not os.path.isdir(scene_dir):
        subprocess.run(
            [sys.executable, "-m", "gbnerf_tpu_torch.tools."
             "make_synthetic_scene"] + abl.scene_argv(scene_dir, ns),
            check=True, capture_output=True)
    dev = loop.device_from_flag(args.device)
    never = 10 ** 9
    cfg1 = load_reference_config(paths["s1"])
    cfg1 = cfg1.replace(train=dataclasses.replace(
        cfg1.train, i_print=never, i_weights=never, i_video=never,
        i_evaluate=never, i_testset=never, no_reload=True))
    t0 = time.perf_counter()
    s1 = (loop.train(cfg1, device=dev, draws=args.draws)
          if args.s1_steps > 0 else None)
    s1_s = time.perf_counter() - t0

    cfg = load_reference_config(paths[args.arm])
    scene = loop.load_scene(cfg)
    depth_gts = None
    if cfg.data.colmap_depth and cfg.data.dataset_type == "llff":
        depth_gts = loop.load_colmap_depth(
            cfg.data.datadir, cfg.data.factor,
            skip_first=cfg.data.test_split_count)
    banks = loop.build_ray_banks(scene.images, scene.masks,
                                 scene.inpainted_depths, scene.poses,
                                 scene.hwf[2], depth_gts)
    banks_dev = loop.banks_to_device(banks, dev)
    if args.draws == "jax":
        # train()'s key tree: the init's key, then the guidance's and the
        # VGG's from the split chain
        from ..utils import jax_random as jr

        rng, k_init = jr.split(jr.PRNGKey(cfg.train.seed))

        def next_key():
            nonlocal rng
            rng, key = jr.split(rng)
            return key
    else:
        k_init, next_key = torch.Generator().manual_seed(cfg.train.seed), None
    state, coarse, fine = create_train_state(cfg, k_init, dev)
    if s1 is not None:
        coarse.load_state_dict(s1["state"].coarse.state_dict())
        if fine is not None:
            fine.load_state_dict(s1["state"].fine.state_dict())
    scene_dev = loop.scene_to_device(scene, banks, dev)
    guidance_fn, _, _ = loop.build_guidance(cfg, scene_dev, dev,
                                            cfg.train.seed + 1, next_key)
    lpips_fn = loop.build_lpips(cfg, dev, next_key and next_key())
    step = make_train_step_stage2(cfg, coarse, fine, scene.near, scene.far,
                                  scene.hwf, guidance_fn=guidance_fn,
                                  lpips_fn=lpips_fn)
    params = [p for f in state.fields() for p in f.parameters()]
    w_sds = cfg.guidance.sds_loss_weight

    def grads(part, seed, step_i, record):
        gen = torch.Generator(device=dev).manual_seed(seed)
        batch = select_stage2_view(scene_dev, banks_dev, cfg.train.N_rand,
                                   gen)
        with sds_part(part, record):
            loss, m = step.loss_fn(batch, step_i, gen)
        g_sds = _grad(w_sds * m["sds_loss"], params, retain=True)
        g_all = _grad(loss, params)
        return g_all, g_sds, float(m["sds_loss"].detach())

    views = []
    for step_i, v in itertools.product(
            [int(i) for i in args.step_i.split(",")], range(args.views)):
        rec = []
        g_all, g_sds, sds = grads("both", 100 + v, step_i, rec)
        _, g_model, _ = grads("model", 100 + v, step_i, [])
        _, g_noise, _ = grads("noise", 100 + v, step_i, [])
        g_rest = g_all - g_sds
        views.append({
            "step_i": step_i, "seed": 100 + v, "sds_loss": sds,
            "grad_norm_rest": float(g_rest.norm()),
            "grad_norm_sds": float(g_sds.norm()),
            "grad_norm_sds_model": float(g_model.norm()),
            "grad_norm_sds_noise": float(g_noise.norm()),
            "sds_over_rest": float(g_sds.norm() / g_rest.norm()),
            "cos_sds_rest": _cos(g_sds, g_rest),
            "cos_model_rest": _cos(g_model, g_rest),
            "parts_sum_err": float((g_model + g_noise - g_sds).norm()
                                   / g_sds.norm().clamp_min(1e-300)),
            "latent_norm_model": rec[0]["model"],
            "latent_norm_noise": rec[0]["noise"]})

    def med(i, k):
        return float(np.median([v[k] for v in views if v["step_i"] == i]))

    res = {"arm": args.arm, "draws": args.draws,
           "s1_steps": args.s1_steps, "s1_s": s1_s,
           "sds_loss_weight": w_sds, "latent": args.latent,
           "device": str(dev),
           "median": {i: {k: med(i, k) for k in views[0]
                          if k not in ("seed", "step_i")}
                      for i in sorted({v["step_i"] for v in views})},
           "views": views}
    with open(os.path.join(out, "sds_grad_share.json"), "w") as fh:
        json.dump(res, fh, indent=1)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
