"""SPIn-NeRF / LLFF scene-directory preflight, before any training.

The twin of tools/check_data.py, on the port's loaders: it loads the
scene through the path ``train()`` uses (``load_llff_data``,
``load_colmap_depth``) and checks every asset the shipped GB-NeRF config
reads (the reference's run.py:687-916 and DS_NeRF/load_llff.py:420-520):

  - poses_bounds.npy rows against the images, positive bounds
  - images_{factor}/{RGB_inpainted,label,Depth_inpainted} present, one
    image a pose (or a train pose), the same shape in every view (full-res
    images/ alone is fine: the loader minifies it)
  - the train/test split under the split options
  - each view's inpaint-mask coverage (empty, full or non-binary masks)
  - the inpainted depths finite and not constant
  - pose geometry the loader can average (poses_avg)
  - with --colmap: the sparse/0 model reads, and each train view keeps
    keypoints after the [near, far] filter

It prints a summary and PASS (exit 0) or FAIL (exit 1). Host code only:

    python -m gbnerf_tpu_torch.tools.check_data /data/spinnerf/scene1 \\
        [--factor 4] [--colmap] [--test_split_count 40] [--llffhold 0] \\
        [--no-origin]
"""
from __future__ import annotations

import argparse
import os
from typing import List

import numpy as np


class Report:
    """The findings: blocking failures and warnings, printed as they
    come."""

    def __init__(self):
        self.fails: List[str] = []
        self.warns: List[str] = []

    def check(self, ok: bool, what: str, warn_only: bool = False) -> bool:
        tag = "ok" if ok else ("WARN" if warn_only else "FAIL")
        print(f"  [{tag}] {what}")
        if not ok:
            (self.warns if warn_only else self.fails).append(what)
        return ok

    def finish(self) -> int:
        print()
        if self.fails:
            print(f"FAIL — {len(self.fails)} blocking problem(s):")
            for f in self.fails:
                print(f"  - {f}")
            if self.warns:
                print(f"(+ {len(self.warns)} warning(s))")
            return 1
        print("PASS" + (f" ({len(self.warns)} warning(s) — review above)"
                        if self.warns else " — scene is trainable as-is"))
        return 0


def check_scene(args, rep: Report) -> None:
    from ..data.llff import (load_colmap_depth, load_llff_data,
                             load_poses_bounds)

    d = args.datadir
    print(f"== scene layout ({d}) ==")
    if not rep.check(os.path.exists(os.path.join(d, "poses_bounds.npy")),
                     "poses_bounds.npy present"):
        return
    poses, bds = load_poses_bounds(d)
    n_poses = len(poses)
    print(f"  poses: {n_poses}, raw bounds [{bds.min():.3f}, {bds.max():.3f}]")
    rep.check(np.isfinite(poses).all() and np.isfinite(bds).all(),
              "poses/bounds finite")
    rep.check((bds > 0).all(), "bounds strictly positive")

    sfx = f"_{args.factor}" if args.factor and args.factor != 1 else ""
    base = os.path.join(d, "images" + sfx)
    subdirs = (["RGB_inpainted", "label", "Depth_inpainted"]
               if args.origin else [""])
    if not os.path.isdir(base):
        rep.check(os.path.isdir(os.path.join(d, "images")),
                  f"images{sfx}/ absent but full-res images/ present "
                  "(will auto-minify on first load)")
    else:
        # one image a pose, or a train pose only (prepared SPIn-NeRF scenes
        # ship none for the leading test_split_count poses)
        want = {n_poses}
        if not args.llffhold:
            want.add(n_poses - args.test_split_count)
        for s in subdirs:
            p = os.path.join(base, s) if s else base
            n_img = len([f for f in os.listdir(p) if not f.startswith(".")]) \
                if os.path.isdir(p) else 0
            rep.check(n_img in want,
                      f"images{sfx}/{s or '.'}: {n_img} files vs {n_poses} "
                      f"poses (acceptable: {sorted(want)})",
                      # only dense-depth configs read the depth subdir
                      warn_only=(s == "Depth_inpainted"))

    print("== loader (the path train() takes) ==")
    try:
        scene = load_llff_data(d, args.factor, origin=args.origin,
                               test_split_count=args.test_split_count,
                               llffhold=args.llffhold)
    except Exception as e:    # any loader error is this tool's finding
        rep.check(False, f"load_llff_data raised {type(e).__name__}: {e}")
        return
    H, W, focal = scene.hwf
    n_tr, n_te = len(scene.poses), len(scene.poses_test)
    print(f"  {n_tr} train + {n_te} test views, {W}x{H}, focal {focal:.1f}, "
          f"near/far {scene.near:.3f}/{scene.far:.3f}")
    rep.check(n_tr >= 2, f"train split non-degenerate ({n_tr} views)")
    rep.check(n_te >= 1, f"test split non-empty ({n_te} views)",
              warn_only=True)
    rep.check(np.isfinite(scene.images).all()
              and 0.0 <= scene.images.min() and scene.images.max() <= 1.0,
              "train images finite in [0, 1]")

    m = scene.masks
    frac = m.reshape(n_tr, -1).mean(1)
    print(f"  mask coverage/view: min {frac.min():.4f}  "
          f"median {np.median(frac):.4f}  max {frac.max():.4f}")
    rep.check((frac > 0).all(),
              "every train view has a non-empty inpaint mask "
              f"(empty: {np.where(frac == 0)[0].tolist()})")
    rep.check((frac < 0.9).all(), "no mask covers >90% of its view")
    binary = np.isin(np.unique(np.round(m, 3)), [0.0, 1.0]).all()
    rep.check(bool(binary), "masks are binary after normalization",
              warn_only=True)

    dep = scene.inpainted_depths
    if args.origin and np.isfinite(dep).all() and dep.max() > dep.min():
        print(f"  inpainted depth range [{dep.min():.3f}, {dep.max():.3f}]")
        rep.check(True, "inpainted depths finite + non-constant")
    else:
        rep.check(not args.origin, "inpainted depths missing/degenerate "
                  "(fine when colmap_depth=True — the shipped mode)",
                  warn_only=True)

    if not args.colmap:
        return
    print("== COLMAP sparse depth (shipped colmap_depth=True) ==")
    sp = os.path.join(d, "sparse", "0")
    if not rep.check(all(os.path.exists(os.path.join(sp, f + ".bin"))
                         for f in ("images", "points3D")),
                     "sparse/0/{images,points3D}.bin present"):
        return
    try:
        gts = load_colmap_depth(d, args.factor,
                                skip_first=args.test_split_count)
    except Exception as e:    # any loader error is this tool's finding
        gts = []
        rep.check(False, f"load_colmap_depth raised {type(e).__name__}: {e}")
    counts = [len(g["depth"]) for g in gts]
    if counts:
        print(f"  kept keypoints/view: min {min(counts)}  "
              f"median {int(np.median(counts))}  max {max(counts)}")
    rep.check(len(gts) == n_tr,
              f"{len(gts)} supervised views == {n_tr} train views "
              "(views whose keypoints all fall outside [near,far] "
              "are DROPPED — check test_split_count/image-id offset)")
    rep.check(bool(counts) and min(counts) >= 5,
              "every supervised view keeps >= 5 keypoints", warn_only=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("datadir")
    ap.add_argument("--factor", type=int, default=4,
                    help="downsample factor (aconfig_1.txt ships 4)")
    ap.add_argument("--colmap", action="store_true",
                    help="also check the sparse/0 COLMAP depth supervision "
                         "(colmap_depth=True, the shipped mode)")
    ap.add_argument("--test_split_count", type=int, default=40,
                    help="the first N poses are the test split "
                         "(load_llff.py:449; SPIn-NeRF captures ship 40)")
    ap.add_argument("--llffhold", type=int, default=0)
    ap.add_argument("--no-origin", dest="origin", action="store_false",
                    help="plain images/ layout instead of the SPIn-NeRF "
                         "RGB_inpainted/label/Depth_inpainted subdirs")
    args = ap.parse_args(argv)
    rep = Report()
    check_scene(args, rep)
    return rep.finish()


if __name__ == "__main__":
    raise SystemExit(main())
