"""The stage-1 / no-guidance arms of the guidance ablation, on the port.

    python -m gbnerf_tpu_torch.tools.run_ablation OUT [--arms s1,nog]
        [--iters1 10000] [--iters2 10000] [--device cuda] [--check]

The port's twin of tools/run_ablation.py for its s1 and nog arms, at the
settings of ``tools/run_ablation.py OUT --production --colmap --lindisp
--combine sds --arms s1,nog`` (the round-5 table of PARITY.md):

  Scene  ``gbnerf_tpu_torch.tools.make_synthetic_scene --task inpaint
         --colmap_sparse`` at 252 × 189, 16 train + 3 test views, seed 0:
         an intruder sphere "removed" by per-view inconsistent 2-D
         inpaintings; the held-out views carry clean ground truth and the
         intruder masks, so masked-region PSNR measures the fill.
  Arms   s1   stage 1 only (the DS-NeRF fit of the inconsistent inpaintings)
         nog  stage 2 from s1's checkpoint: the LPIPS patch loss (random
              VGG), no guidance

Each arm is a run of ``python -m gbnerf_tpu_torch.run`` on the config it
writes (the same text as the original's, paths aside); nog starts from a
copy of s1's checkpoints. The other arms (rand, prior, priorN, priorL,
priorNL, priorC) need the tiny-prior trainer, LoRA and Perp-Neg, which are
not ported yet (ROADMAP A4/A5): asking for one exits 1. ``--smoke``
swaps in the original's small-MLP field (its non-production default) for
quick CPU runs. Results: OUT/ablation.json and a table of masked,
unmasked and full held-out PSNR.
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
ARMS = ("s1", "nog")
UNPORTED_ARMS = ("rand", "prior", "priorN", "priorL", "priorNL", "priorC")

COMMON = """
datadir = {scene}
dataset_type = llff
factor = 4
test_split_count = {n_test}
colmap_depth = True
lindisp = True
{field}
basedir = {logs}
expname = {arm}
i_print = 250
i_weights = 1000
i_video = 1000000000
i_testset = 1000000000
render_factor = 0
"""

FIELD_SMOKE = """no_tcnn = True
netdepth = 2
netwidth = 64
netdepth_fine = 2
netwidth_fine = 64
N_samples = 32
N_importance = 16
N_rand = 512"""

# the production CP field and sampling knobs (configs/spinnerf_scene.txt)
FIELD_PROD = """no_tcnn = False
field_type = cp
cp_bound = 8.0
N_samples = 64
N_importance = 64
N_rand = 1024
raw_noise_std = 1e0"""

# stage 2 at the shipped 2-way SDS combine (no guidance runs in nog, but
# the config carries the same text as the original's)
STAGE2 = """
first_stage = False
lpips = True
patch_len = 32
n_patches = 4
lpips_weight = 0.01
is_normal_guidance = False
use_csd = False
normal_guidance_scale = 1.5
sds_loss_weight = 0.0001
anneal_iters = 20000
sd_latent_size = 256
cache_masked_latents = True
"""


def run(cmd, log_path):
    print(f"[ablation] $ {' '.join(cmd)}  (log: {log_path})", flush=True)
    with open(log_path, "w") as log:
        r = subprocess.run(cmd, stdout=log, stderr=subprocess.STDOUT,
                           cwd=ROOT)
    if r.returncode != 0:
        with open(log_path) as fh:
            print(fh.read()[-3000:])
        raise SystemExit(f"command failed: {' '.join(cmd)}")


def last_eval(expdir):
    out = {}
    p = os.path.join(expdir, "metrics.jsonl")
    if not os.path.exists(p):
        return out
    with open(p) as fh:
        for line in fh:
            rec = json.loads(line)
            if "eval_psnr" in rec:
                out = {k: v for k, v in rec.items() if k.startswith("eval")}
                out["iter"] = rec["iter"]
    return out


def write_configs(out, args):
    """OUT/cfg_s1.txt and OUT/cfg_nog.txt → {arm: path}."""
    scene = os.path.join(out, "scene")
    logs = os.path.join(out, "logs")
    field = FIELD_SMOKE if args.smoke else FIELD_PROD
    n2 = args.iters1 + args.iters2
    bodies = {"s1": (f"first_stage = True\nN_iters = {args.iters1}\n"
                     f"i_evaluate = {args.iters1}\n"),
              "nog": (STAGE2 + "is_rgb_guidance = False\n"
                      f"N_iters = {n2}\ni_evaluate = {n2}\n")}
    paths = {}
    for arm, body in bodies.items():
        paths[arm] = os.path.join(out, f"cfg_{arm}.txt")
        with open(paths[arm], "w") as fh:
            fh.write(COMMON.format(scene=scene, logs=logs, arm=arm,
                                   field=field, n_test=args.n_test) + body)
    return paths


def check_configs(paths, args):
    """Load each written config through the port's parser and hold it to
    its arm."""
    from ..config import load_reference_config

    errs = []
    for arm, path in paths.items():
        cfg = load_reference_config(path)
        t, g = cfg.train, cfg.guidance
        want_iters = args.iters1 + (args.iters2 if arm == "nog" else 0)
        if t.first_stage != (arm == "s1") or t.N_iters != want_iters:
            errs.append(f"{arm}: first_stage / N_iters")
        if not (cfg.render.lindisp and cfg.data.colmap_depth):
            errs.append(f"{arm}: lindisp and colmap_depth must be on")
        if arm == "nog" and (g.is_rgb_guidance or g.is_normal_guidance
                             or not t.lpips):
            errs.append("nog: no guidance, LPIPS on")
    if errs:
        raise SystemExit("[check] FAILED:\n  " + "\n  ".join(errs))
    print(f"[check] OK — {', '.join(paths)} configs consistent; no "
          "training was run.")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out")
    ap.add_argument("--arms", default="s1,nog")
    ap.add_argument("--iters1", type=int, default=10000)
    ap.add_argument("--iters2", type=int, default=10000)
    ap.add_argument("--H", type=int, default=189)
    ap.add_argument("--W", type=int, default=252)
    ap.add_argument("--n_train", type=int, default=16)
    ap.add_argument("--n_test", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="passed to gbnerf_tpu_torch.run (cpu without a card)")
    ap.add_argument("--smoke", action="store_true",
                    help="the original's small-MLP field, for CPU runs")
    ap.add_argument("--check", action="store_true",
                    help="write and check the arm configs, train nothing")
    args = ap.parse_args(argv)

    arms = args.arms.split(",")
    bad = [a for a in arms if a not in ARMS]
    if bad:
        known = [a for a in bad if a in UNPORTED_ARMS]
        raise SystemExit(
            f"arms {bad} are not ported: " + (
                "they wait for the tiny-prior trainer, LoRA and Perp-Neg "
                "(ROADMAP A4/A5)" if known == bad else
                f"the ablation's arms are {ARMS + UNPORTED_ARMS}"))
    out = os.path.abspath(args.out)
    logs = os.path.join(out, "logs")
    os.makedirs(logs, exist_ok=True)
    paths = write_configs(out, args)
    if args.check:
        check_configs(paths, args)
        return
    py = sys.executable
    scene = os.path.join(out, "scene")
    if not os.path.isdir(scene):
        run([py, "-m", "gbnerf_tpu_torch.tools.make_synthetic_scene", scene,
             "--task", "inpaint", "--H", str(args.H), "--W", str(args.W),
             "--n_train", str(args.n_train), "--n_test", str(args.n_test),
             "--seed", "0", "--colmap_sparse"],
            os.path.join(out, "scene.log"))

    def train(arm):
        run([py, "-m", "gbnerf_tpu_torch.run", "--config", paths[arm],
             "--device", args.device], os.path.join(out, f"{arm}.log"))

    s1dir = os.path.join(logs, "s1")
    if not os.path.isdir(os.path.join(s1dir, "ckpt")):
        train("s1")
    if "nog" in arms:
        expdir = os.path.join(logs, "nog")
        if os.path.isdir(os.path.join(expdir, "ckpt")):
            print("[ablation] nog: already run, skipping")
        else:
            os.makedirs(expdir, exist_ok=True)
            shutil.copytree(os.path.join(s1dir, "ckpt"),
                            os.path.join(expdir, "ckpt"))
            train("nog")

    results = {a: last_eval(os.path.join(logs, a)) for a in arms}
    jpath = os.path.join(out, "ablation.json")
    if os.path.exists(jpath):
        with open(jpath) as fh:
            merged = json.load(fh)
        merged.update(results)
        results = merged
    with open(jpath, "w") as fh:
        json.dump(results, fh, indent=2)
    cols = ("eval_psnr_masked", "eval_psnr_unmasked", "eval_psnr")
    print("\n| arm | " + " | ".join(c.replace("eval_", "") for c in cols)
          + " |")
    print("|---" * (len(cols) + 1) + "|")
    for arm in arms:
        r = results[arm]
        print(f"| {arm} | " + " | ".join(
            f"{r[c]:.2f}" if c in r else "—" for c in cols) + " |")
    print(f"\nwrote {jpath}")
    return results


if __name__ == "__main__":
    main()
