#!/usr/bin/env python
"""Drive the port's full run.py orchestration over several ranks.

The port's twin of tools/run_spmd_demo.py: the same two configs and the
same scene (through the port's synthetic-scene twin), each stage run by
``python -m gbnerf_tpu_torch.run`` under torchrun: stage 1 data-parallel
over ``--nproc`` ranks, then the stage-2 continuation from its checkpoint
with the tiny SD stack tensor-parallel over a (data, model) mesh
(guidance_tp = ``--tp``). It asserts the ``[mesh]`` lines and the eval
records, and writes ``spmd_demo.json``.

Usage:
    python -m gbnerf_tpu_torch.tools.run_spmd_demo OUT [--nproc 2] [--tp 2]
        [--iters1 100] [--iters2 20] [--n_rand 512] [--device cuda|cpu]
        [--dist_backend nccl|gloo]

On one card, ranks share it through ``--dist_backend gloo``; the micro run
is ``--iters1 8 --iters2 4 --n_rand 128``.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

CFG_S1 = """
datadir = {scene}
dataset_type = llff
factor = 4
test_split_count = 2
basedir = {logs}
expname = s1
no_tcnn = False
field_type = cp
cp_bound = 8.0
N_samples = 64
N_importance = 64
N_rand = {n_rand}
raw_noise_std = 1e0
first_stage = True
N_iters = {iters1}
i_print = 25
i_weights = {iters1}
i_video = 1000000000
i_testset = 1000000000
i_evaluate = {iters1}
render_factor = 0
"""

CFG_S2 = """
datadir = {scene}
dataset_type = llff
factor = 4
test_split_count = 2
basedir = {logs}
expname = s2
no_tcnn = False
field_type = cp
cp_bound = 8.0
N_samples = 64
N_importance = 64
N_rand = {n_rand}
raw_noise_std = 1e0
first_stage = False
lpips = True
patch_len = 16
n_patches = 2
lpips_weight = 0.01
is_rgb_guidance = True
sd_tiny = True
sd_latent_size = 64
guidance_tp = {tp}
N_iters = {iters2_total}
i_print = 10
i_weights = {iters2_total}
i_video = 1000000000
i_testset = 1000000000
i_evaluate = {iters2_total}
render_factor = 0
"""


def write_configs(out: str, scene: str, logs: str, *, iters1: int,
                  iters2: int, n_rand: int, tp: int):
    """The two stage configs, as the JAX tool writes them → their paths."""
    s1cfg, s2cfg = (os.path.join(out, "cfg_s1.txt"),
                    os.path.join(out, "cfg_s2.txt"))
    with open(s1cfg, "w") as f:
        f.write(CFG_S1.format(scene=scene, logs=logs, iters1=iters1,
                              n_rand=n_rand))
    with open(s2cfg, "w") as f:
        f.write(CFG_S2.format(scene=scene, logs=logs, tp=tp, n_rand=n_rand,
                              iters2_total=iters1 + iters2))
    return s1cfg, s2cfg


def run_cli(cfg_path, log_path, nproc: int, device: str, backend):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={nproc}", "-m", "gbnerf_tpu_torch.run",
           "--config", cfg_path, "--device", device]
    if backend:
        cmd += ["--dist_backend", backend]
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    print(f"[spmd_demo] $ {' '.join(cmd)}  (log: {log_path})", flush=True)
    with open(log_path, "w") as log:
        r = subprocess.run(cmd, stdout=log, stderr=subprocess.STDOUT,
                           cwd=ROOT, env=env)
    with open(log_path) as fh:
        out = fh.read()
    if r.returncode != 0:
        print(out[-3000:])
        raise SystemExit(f"command failed: {' '.join(cmd)}")
    return out


def last_eval(expdir):
    out = {}
    with open(os.path.join(expdir, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if "eval_psnr" in rec:
                out = rec
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("--nproc", type=int, default=2,
                    help="ranks (one a card with nccl)")
    ap.add_argument("--tp", type=int, default=2,
                    help="guidance tensor-parallel degree (model axis)")
    ap.add_argument("--iters1", type=int, default=100)
    ap.add_argument("--iters2", type=int, default=20)
    ap.add_argument("--n_rand", type=int, default=512)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--dist_backend", default=None,
                    help="nccl (default on the card) or gloo (the CPU's; "
                         "on the card it lets the ranks share one)")
    args = ap.parse_args(argv)

    out = os.path.abspath(args.out)
    scene = os.path.join(out, "scene")
    logs = os.path.join(out, "logs")
    os.makedirs(logs, exist_ok=True)

    if not os.path.isdir(scene):
        subprocess.run(
            [sys.executable, "-m", "gbnerf_tpu_torch.tools.make_synthetic_scene",
             scene, "--task", "inpaint", "--H", "96", "--W", "128",
             "--n_train", "8", "--n_test", "2", "--colmap_sparse"],
            check=True, cwd=ROOT)
    s1cfg, s2cfg = write_configs(out, scene, logs, iters1=args.iters1,
                                 iters2=args.iters2, n_rand=args.n_rand,
                                 tp=args.tp)

    # ---- stage 1: data-parallel over every rank ----
    log1 = run_cli(s1cfg, os.path.join(out, "s1.log"), args.nproc,
                   args.device, args.dist_backend)
    want1 = f"[mesh] data-parallel over {args.nproc} devices"
    if args.nproc > 1 and want1 not in log1:
        raise SystemExit(f"stage-1 did not build the data mesh: {want1!r}")
    s1 = last_eval(os.path.join(logs, "s1"))
    if s1.get("iter") != args.iters1:
        raise SystemExit(f"stage-1 eval missing: {s1}")

    # ---- stage 2: (data, model) mesh, guidance tensor-parallel ----
    s2dir = os.path.join(logs, "s2")
    if not os.path.isdir(os.path.join(s2dir, "ckpt")):
        os.makedirs(s2dir, exist_ok=True)
        shutil.copytree(os.path.join(logs, "s1", "ckpt"),
                        os.path.join(s2dir, "ckpt"))
    log2 = run_cli(s2cfg, os.path.join(out, "s2.log"), args.nproc,
                   args.device, args.dist_backend)
    dp = args.nproc // args.tp
    want2 = f"[mesh] data×model = {dp}×{args.tp}"
    if args.nproc > 1 and want2 not in log2:
        raise SystemExit(f"stage-2 did not build the TP mesh: {want2!r}")
    s2 = last_eval(s2dir)
    if s2.get("iter") != args.iters1 + args.iters2:
        raise SystemExit(f"stage-2 eval missing: {s2}")

    report = {
        "devices": args.nproc, "tp": args.tp,
        "s1": {k: v for k, v in s1.items() if k.startswith(("eval", "iter"))},
        "s2": {k: v for k, v in s2.items() if k.startswith(("eval", "iter"))},
    }
    with open(os.path.join(out, "spmd_demo.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    print(f"[spmd_demo] OK — full CLI orchestration ran on a "
          f"{dp}×{args.tp} mesh of {args.nproc} ranks; artifacts in {out}")
    return report


if __name__ == "__main__":
    main()
