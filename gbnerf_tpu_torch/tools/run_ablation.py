"""The guidance ablation on the port: the s1, nog and guided arms.

    python -m gbnerf_tpu_torch.tools.run_ablation OUT [--production]
        [--colmap] [--lindisp] [--seed 0] [--family spheres|hard]
        [--arms s1,nog,rand,prior] [--combine csd|sds|csd_ref]
        [--iters1 N] [--iters2 N] [--sds_w W] [--anneal N] [--latent N]
        [--H N] [--W N] [--n_train N] [--n_test N] [--prior_steps N]
        [--lora_steps N] [--skip_prior] [--check]
        [--device cuda] [--draws torch|jax]

The port's twin of tools/run_ablation.py: the same flags, defaults and
configs (paths aside), so that every repro line of PARITY.md runs
unchanged under ``python -m gbnerf_tpu_torch.tools.run_ablation``.
``--production`` picks the production CP field and the scale table
(``SCALE``: 10k + 10k steps, sds_w 1e-4, anneal 20000, 256² latents,
252 × 189 views, 16 + 3 of them; without it the small-MLP field and
3k + 2k, 1e-3, 4000, 128², 128 × 96, 8 + 2); an explicit flag overrides
its entry. ``--colmap``: sparse COLMAP depth (the scene's
``--colmap_sparse``), else the scene's dense disparity. ``--lindisp``:
disparity-linear sampling. ``--seed``: the scene generator's seed alone
(train.seed stays the config's). ``--family``: the scene's and the
prior's world. The round-5 table of PARITY.md is ``--production --colmap
--lindisp --combine sds``; round 3's is ``--production`` (csd).

  Scene  ``gbnerf_tpu_torch.tools.make_synthetic_scene --task inpaint``:
         an intruder "removed" by per-view inconsistent 2-D inpaintings;
         the held-out views carry clean ground truth and the intruder
         masks, so masked-region PSNR measures the fill.
  Prior  ``gbnerf_tpu_torch.tools.train_tiny_prior OUT/prior.msgpack`` at
         the guidance resolution (the tiny stack trained from scratch on
         random worlds of the family; the domain, never the scene: one
         prior serves every seed through ``--skip_prior``).
  LoRA   ``gbnerf_tpu_torch.train_lora --tiny --sd_prior_ckpt`` on the
         scene's inpainted training images, the label masks out of the
         loss (the reference's DreamBooth → guidance workflow).
  Arms   s1      stage 1 only (the DS-NeRF fit of the inconsistent
                 inpaintings)
         nog     stage 2 from s1's checkpoint: the LPIPS patch loss
                 (random VGG), no guidance
         rand    nog + RGB guidance from the random-weight tiny stack
         prior   nog + RGB guidance from the trained prior
         priorN  prior + normal-map guidance from the same prior
         priorL  prior + the scene LoRA
         priorNL priorN + the scene LoRA: the reference's shipped shape
         priorC  prior + collaborative guidance: four random training
                 views rendered each step and guided jointly

Each arm is a run of ``python -m gbnerf_tpu_torch.run`` on the config it
writes; the stage-2 arms start from a copy of s1's checkpoints, and an arm
whose ``ckpt/`` exists counts as run. Where the original runs one command
after another, the twin starts each as soon as what it needs exists (the
prior beside s1; nog and rand once s1 is done; the prior's arms and the
LoRA once the prior is; the LoRA's arms once it is), beside the others on
the one card: a guided arm leaves the card idle most of a step, and each
run is the same computation either way. Guided arms' names carry the
combine's tag (``prior-sds``), as in the original. Port-only flags:
``--device`` and ``--draws jax``, which passes on to the prior's trainer,
the LoRA's and every arm: each then draws what the JAX package draws for
its seed (utils/jax_random.py). Results: OUT/ablation.json and a table of
masked, unmasked and full held-out PSNR.
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
SCENE_TOOL = "gbnerf_tpu_torch.tools.make_synthetic_scene"
PRIOR_TOOL = "gbnerf_tpu_torch.tools.train_tiny_prior"
ARMS = ("s1", "nog", "rand", "prior", "priorN", "priorL", "priorNL",
        "priorC")

COMMON = """
datadir = {scene}
dataset_type = llff
factor = 4
test_split_count = {n_test}
colmap_depth = {colmap}
lindisp = {lindisp}
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

STAGE2 = """
first_stage = False
lpips = True
patch_len = 32
n_patches = 4
lpips_weight = 0.01
is_normal_guidance = False
{combine}
sds_loss_weight = {sds_w}
anneal_iters = {anneal}
sd_latent_size = {latent}
{extra}
"""

# the guidance combines: csd (3-way, the round-3 flat triple), sds (the
# reference's shipped 2-way combine at the per-modality scales, normal
# 1.5 as its config sets), csd_ref (3-way, the reference's own triples)
COMBINE = {
    "csd": ("use_csd = True\n"
            "rgb_w1 = 1.0\nrgb_w2 = 0.5\nrgb_w3 = 0.5\n"
            "normal_w1 = 1.0\nnormal_w2 = 0.5\nnormal_w3 = 0.5"),
    "sds": "use_csd = False\nnormal_guidance_scale = 1.5",
    "csd_ref": "use_csd = True",
}
COMBINE_TAG = {"csd": "", "sds": "-sds", "csd_ref": "-csdref"}
# the original's scale table: (with --production, without)
SCALE = {"iters1": (10000, 3000), "iters2": (10000, 2000),
         "sds_w": (1e-4, 1e-3), "anneal": (20000, 4000),
         "latent": (256, 128), "H": (189, 96), "W": (252, 128),
         "n_train": (16, 8), "n_test": (3, 2), "prior_steps": (6000, 4000),
         "lora_steps": (1000, 300)}


def launch(cmd, log_path) -> subprocess.Popen:
    print(f"[ablation] $ {' '.join(cmd)}  (log: {log_path})", flush=True)
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                cwd=ROOT)
    proc.log_path = log_path
    return proc


def finish(proc: subprocess.Popen) -> None:
    """Wait for a launched command; its failure prints its log's end and
    exits."""
    if proc.wait() != 0:
        with open(proc.log_path) as fh:
            print(fh.read()[-3000:])
        raise SystemExit(f"command failed: {' '.join(proc.args)}")


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


def arm_name(arm: str, combine: str) -> str:
    """s1 and nog never guide: their names carry no combine tag."""
    return arm if arm in ("s1", "nog") else arm + COMBINE_TAG[combine]


def write_configs(out, args, arms=("s1", "nog")):
    """OUT/cfg_<arm>.txt for s1 and each requested arm → {arm: path}."""
    scene = os.path.join(out, "scene")
    logs = os.path.join(out, "logs")
    prod, combine = args.production, args.combine
    field = FIELD_PROD if prod else FIELD_SMOKE
    prior, lora_ckpt = artifact_paths(out, args)
    n2 = args.iters1 + args.iters2
    stage2 = STAGE2.format(combine=COMBINE[combine], sds_w=args.sds_w,
                           anneal=args.anneal, latent=args.latent,
                           extra="cache_masked_latents = True" if prod
                           else "")
    guided = "is_rgb_guidance = True\nsd_tiny = True\n"
    # the production scale keeps the reference's factor 7; the small
    # views need 4 for a usable normal map
    normal = ("is_rgb_guidance = True\nis_normal_guidance = True\n"
              f"normal_start_iter = {args.iters1}\n"
              f"normalmap_render_factor = {7 if prod else 4}\n"
              "sd_tiny = True\n")
    bodies = {"nog": "is_rgb_guidance = False\n",
              "rand": guided,
              "prior": guided + f"sd_prior_ckpt = {prior}\n",
              "priorL": (guided + f"sd_prior_ckpt = {prior}\n"
                         f"sd_lora_ckpt = {lora_ckpt}\n"),
              "priorN": normal + f"sd_prior_ckpt = {prior}\n",
              "priorNL": (normal + f"sd_prior_ckpt = {prior}\n"
                          f"sd_lora_ckpt = {lora_ckpt}\n"),
              "priorC": ("is_rgb_guidance = True\nis_colla_guidance = True\n"
                         "sd_tiny = True\n"
                         f"sd_prior_ckpt = {prior}\n")}
    texts = {"s1": (f"first_stage = True\nN_iters = {args.iters1}\n"
                    f"i_evaluate = {args.iters1}\n")}
    for arm in arms:
        if arm != "s1":
            texts[arm] = (stage2 + bodies[arm]
                          + f"N_iters = {n2}\ni_evaluate = {n2}\n")
    paths = {}
    for arm, body in texts.items():
        name = arm_name(arm, combine)
        paths[arm] = os.path.join(out, f"cfg_{name}.txt")
        with open(paths[arm], "w") as fh:
            fh.write(COMMON.format(scene=scene, logs=logs, arm=name,
                                   field=field, n_test=args.n_test,
                                   colmap=args.colmap, lindisp=args.lindisp)
                     + body)
    return paths


def scene_argv(scene, args):
    """The scene generator's command line (the original's)."""
    return ([scene, "--task", "inpaint", "--H", str(args.H), "--W",
             str(args.W), "--n_train", str(args.n_train), "--n_test",
             str(args.n_test), "--seed", str(args.seed), "--family",
             args.family] + (["--colmap_sparse"] if args.colmap else []))


def prior_argv(prior, args):
    """The prior trainer's command line (the original's, and the port's
    --device and --draws)."""
    return [prior, "--res", str(args.latent), "--family", args.family,
            "--steps_unet", str(args.prior_steps), "--device", args.device,
            "--draws", args.draws]


def artifact_meta(args):
    """The prior's and the LoRA's meta: {"res"} alone for the spheres
    family, so that its priors written before the flag still validate; a
    hard-family prior never stands in for a spheres one."""
    meta = {"res": args.latent}
    if args.family != "spheres":
        meta["family"] = args.family
    return meta


def write_meta(path, meta):
    if os.path.exists(path) and not os.path.exists(path + ".meta.json"):
        with open(path + ".meta.json", "w") as fh:
            json.dump(meta, fh)


def make_scene(out, args):
    scene = os.path.join(out, "scene")
    if not os.path.isdir(scene):
        finish(launch([sys.executable, "-m", SCENE_TOOL]
                      + scene_argv(scene, args),
                      os.path.join(out, "scene.log")))


def artifact_paths(out, args):
    """(the prior's path, the scene LoRA's adapter file)."""
    return (os.path.join(out, "prior.msgpack"),
            os.path.join(out, "lora", f"lora_{args.lora_steps:06d}"
                         ".safetensors"))


def check_configs(paths, args):
    """Load each written config through the port's parser and hold it to
    its arm (the original's --check)."""
    from ..config import load_reference_config

    combine = args.combine
    prior, lora_ckpt = artifact_paths(os.path.abspath(args.out), args)
    legacy, ref = (1.0, 0.5, 0.5), ((8.5, 7.5, 0.5), (2.5, 1.5, 0.5))
    errs = []
    for arm, path in paths.items():
        cfg = load_reference_config(path)
        t, g = cfg.train, cfg.guidance

        def need(cond, what):
            if not cond:
                errs.append(f"{arm_name(arm, combine)}: {what}")

        want_iters = args.iters1 + (0 if arm == "s1" else args.iters2)
        need(t.first_stage == (arm == "s1") and t.N_iters == want_iters,
             "first_stage / N_iters")
        need(cfg.render.lindisp == args.lindisp, "lindisp")
        need(cfg.data.colmap_depth == args.colmap, "colmap_depth")
        if arm == "s1":
            continue
        need(t.lpips, "LPIPS on")
        need(g.sds_loss_weight == args.sds_w, "sds_loss_weight")
        need(g.sd_latent_size == args.latent, "sd_latent_size")
        if arm == "nog":
            need(not (g.is_rgb_guidance or g.is_normal_guidance),
                 "nog must not guide")
            continue
        need(g.is_rgb_guidance and g.sd_tiny, "RGB guidance, tiny stack")
        need(g.use_csd == (combine != "sds"), "use_csd vs combine")
        trip = ((g.rgb_w1, g.rgb_w2, g.rgb_w3),
                (g.normal_w1, g.normal_w2, g.normal_w3))
        if combine == "csd":
            need(trip == (legacy, legacy), "legacy csd triples")
        elif combine == "csd_ref":
            need(trip == ref, "reference csd triples")
        else:
            need(g.normal_guidance_scale == 1.5, "shipped normal scale")
        need((g.sd_prior_ckpt == prior) == arm.startswith("prior"),
             "prior ckpt")
        need((g.sd_lora_ckpt == lora_ckpt) == (arm in ("priorL", "priorNL")),
             "lora ckpt")
        need(g.is_normal_guidance == (arm in ("priorN", "priorNL")),
             "is_normal_guidance vs arm")
        need(g.is_colla_guidance == (arm == "priorC"),
             "is_colla_guidance vs arm")
        if g.is_normal_guidance:
            need(g.normal_start_iter == args.iters1,
                 "normal_start_iter must be stage-2 entry")
    if errs:
        raise SystemExit("[check] FAILED:\n  " + "\n  ".join(errs))
    print(f"[check] OK — {', '.join(arm_name(a, combine) for a in paths)} "
          "configs consistent; no training was run.")


def _check_meta(path, want, what):
    """True when the artifact exists; refuse one built for another
    resolution (the tiny towers load at any resolution without a shape
    error)."""
    mpath = path + ".meta.json"
    if not os.path.exists(path):
        return False
    if os.path.exists(mpath):
        with open(mpath) as fh:
            meta = json.load(fh)
        if meta != want:
            raise SystemExit(f"{what} at {path} was built with {meta}, but "
                             f"this run needs {want} — delete it (or point "
                             "OUT at a fresh dir) to retrain.")
    return True


def parse_args(argv=None) -> argparse.Namespace:
    """The original's command line (its names, defaults and meanings; the
    scale table filled in where no flag was given) and the port's
    --device and --draws."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out")
    ap.add_argument("--production", action="store_true",
                    help="the production CP field and scale (SCALE)")
    for k in SCALE:
        ap.add_argument(f"--{k}", type=type(SCALE[k][0]), default=None)
    ap.add_argument("--family", choices=("spheres", "hard"),
                    default="spheres",
                    help="the scene's world and the prior's domain")
    ap.add_argument("--seed", type=int, default=0,
                    help="the scene generator's seed (the prior is "
                         "scene-independent: reuse it with --skip_prior)")
    ap.add_argument("--skip_prior", action="store_true",
                    help="reuse an existing prior ckpt")
    ap.add_argument("--lindisp", action="store_true",
                    help="disparity-linear sampling")
    ap.add_argument("--colmap", action="store_true",
                    help="sparse COLMAP depth (the scene's sparse/0 model)")
    ap.add_argument("--arms", default="s1,nog,rand,prior")
    ap.add_argument("--combine", default="csd", choices=sorted(COMBINE))
    ap.add_argument("--check", action="store_true",
                    help="write and check the arm configs, train nothing")
    ap.add_argument("--device", default="cuda",
                    help="passed to every command (cpu without a card)")
    ap.add_argument("--draws", default="torch", choices=("torch", "jax"),
                    help="passed to the prior's and the LoRA's trainers "
                         "and every arm: "
                         "torch generators, or the JAX package's draws")
    args = ap.parse_args(argv)
    for k, (prod, small) in SCALE.items():
        if getattr(args, k) is None:
            setattr(args, k, prod if args.production else small)
    return args


def main(argv=None):
    args = parse_args(argv)
    arms = args.arms.split(",")
    bad = [a for a in arms if a not in ARMS]
    if bad:
        raise SystemExit(f"unknown arms {bad}: the ablation's arms are "
                         f"{ARMS}")
    out = os.path.abspath(args.out)
    logs = os.path.join(out, "logs")
    os.makedirs(logs, exist_ok=True)
    paths = write_configs(out, args, arms)
    if args.check:
        check_configs(paths, args)
        return
    if not args.device.startswith("cpu"):
        from ..train.loop import device_from_flag

        device_from_flag(args.device)
    py = sys.executable
    scene = os.path.join(out, "scene")
    make_scene(out, args)
    prior, lora_ckpt = artifact_paths(out, args)
    meta = artifact_meta(args)
    jobs = []

    def start(cmd, log_name):
        """A command, now, beside the others."""
        proc = launch(cmd, os.path.join(out, log_name))
        jobs.append(proc)
        return proc

    def wait(proc):
        if proc is not None:
            finish(proc)

    def train_prior():
        if not any(a.startswith("prior") for a in arms) or _check_meta(
                prior, meta, "prior"):
            return None
        if args.skip_prior:
            raise SystemExit(f"--skip_prior but no prior at {prior}")
        return start([py, "-m", PRIOR_TOOL] + prior_argv(prior, args),
                     "prior_train.log")

    def train_lora():
        if not any(a in ("priorL", "priorNL") for a in arms) or _check_meta(
                lora_ckpt, meta, "scene LoRA"):
            return None
        return start([py, "-m", "gbnerf_tpu_torch.train_lora", "--tiny",
                      "--sd_prior_ckpt", prior, "--latent_size",
                      str(args.latent), "--instance_data_dir",
                      os.path.join(scene, "images_4", "RGB_inpainted"),
                      "--instance_mask_dir",
                      os.path.join(scene, "images_4", "label"),
                      "--output_dir", os.path.join(out, "lora"),
                      "--max_train_steps", str(args.lora_steps),
                      "--train_batch_size", "4", "--checkpointing_steps",
                      str(args.lora_steps), "--device", args.device,
                      "--draws", args.draws], "lora.log")

    def train_arm(arm):
        name = arm_name(arm, args.combine)
        if arm != "s1":
            expdir = os.path.join(logs, name)
            if os.path.isdir(os.path.join(expdir, "ckpt")):
                print(f"[ablation] {name}: already run, skipping")
                return None
            os.makedirs(expdir, exist_ok=True)
            shutil.copytree(os.path.join(logs, "s1", "ckpt"),
                            os.path.join(expdir, "ckpt"))
        elif os.path.isdir(os.path.join(logs, "s1", "ckpt")):
            return None
        return start([py, "-m", "gbnerf_tpu_torch.run", "--config",
                      paths[arm], "--device", args.device, "--draws",
                      args.draws], f"{name}.log")

    try:
        prior_job = train_prior()
        wait(train_arm("s1"))
        for arm in arms:
            if arm != "s1" and not arm.startswith("prior"):
                train_arm(arm)
        wait(prior_job)
        write_meta(prior, meta)
        lora_job = train_lora()
        for arm in arms:
            if arm.startswith("prior") and arm not in ("priorL", "priorNL"):
                train_arm(arm)
        wait(lora_job)
        write_meta(lora_ckpt, meta)
        for arm in ("priorL", "priorNL"):
            if arm in arms:
                train_arm(arm)
        for proc in jobs:
            wait(proc)
    finally:
        for proc in jobs:
            if proc.poll() is None:
                proc.kill()

    names = [arm_name(a, args.combine) for a in arms]
    results = {n: last_eval(os.path.join(logs, n)) for n in names}
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
    for n in names:
        r = results[n]
        print(f"| {n} | " + " | ".join(
            f"{r[c]:.2f}" if c in r else "—" for c in cols) + " |")
    print(f"\nwrote {jpath}")
    return results


def prepare(argv=None):
    """``prepare scene|prior OUT [flags] [-- trainer flags]``: one thing
    that run_ablation OUT [flags] starts its arms from, made alone — the
    scene, or the prior with its meta (kept where it exists). A prior needs
    no scene, so several OUTs share one through --skip_prior. Flags after
    ``--`` go to the prior's trainer as they are (a rehearsal's small
    domain). tools/quality_runs.sh runs it as
    ``python -c 'import sys; from gbnerf_tpu_torch.tools.run_ablation
    import prepare; prepare(sys.argv[1:])' prior OUT --production``."""
    argv = list(sys.argv[1:] if argv is None else argv)
    what, argv = argv[0], argv[1:]
    extra = []
    if "--" in argv:
        i = argv.index("--")
        argv, extra = argv[:i], argv[i + 1:]
    args = parse_args(argv)
    out = os.path.abspath(args.out)
    os.makedirs(out, exist_ok=True)
    if what == "scene":
        make_scene(out, args)
    elif what == "prior":
        prior, meta = artifact_paths(out, args)[0], artifact_meta(args)
        if not _check_meta(prior, meta, "prior"):
            finish(launch([sys.executable, "-m", PRIOR_TOOL]
                          + prior_argv(prior, args) + extra,
                          os.path.join(out, "prior_train.log")))
            write_meta(prior, meta)
    else:
        raise SystemExit(f"prepare: {what!r} is neither scene nor prior")


if __name__ == "__main__":
    main()
