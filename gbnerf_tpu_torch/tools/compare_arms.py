"""Two ablation arms' held-out renders against each other, inside the
intruder's masks.

    python -m gbnerf_tpu_torch.tools.compare_arms OUT RGB_A RGB_B
        [run_ablation's flags: --production --seed 1 ...]

RGB_A, RGB_B: the arms' eval maps (``logs/<arm>/eval_images_<i>/rgb.npy``,
or their copies ``<arm>.rgb.npy`` in tools/quality_runs.sh's RESULTS).
The held-out views, their clean ground truth and masks are read from the
ablation's scene under OUT, made first (the generator is seeded) where
OUT has none. Prints one JSON line: each arm's masked, unmasked and full
PSNR (the eval's own formula, train/eval.py::eval_summary), and the
largest and the mean absolute difference between the two renders over
the masked pixels of every held-out view.
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    out, rgb_a, rgb_b, rest = argv[0], argv[1], argv[2], argv[3:]
    from . import make_synthetic_scene, run_ablation
    from ..config import load_reference_config
    from ..train.eval import eval_summary
    from ..train.loop import load_scene

    args = run_ablation.parse_args([out] + rest)
    out = os.path.abspath(out)
    os.makedirs(os.path.join(out, "logs"), exist_ok=True)
    cfg = load_reference_config(
        run_ablation.write_configs(out, args, ("s1",))["s1"])
    if not os.path.isdir(os.path.join(out, "scene")):
        make_synthetic_scene.main(
            run_ablation.scene_argv(os.path.join(out, "scene"), args))
    scene = load_scene(cfg)
    gt, masks = scene.images_test, scene.masks_test
    maps = [np.load(p) for p in (rgb_a, rgb_b)]
    res = {}
    for name, rgb in zip(("a", "b"), maps):
        em = eval_summary({"rgb": rgb}, gt=gt, gt_masks=masks)
        res[name] = {"path": os.path.abspath(rgb_a if name == "a" else rgb_b),
                     **{k: round(v, 4) for k, v in em.items()}}
    m = np.broadcast_to(masks[..., None] > 0.5, maps[0].shape)
    diff = np.abs(maps[0].astype(np.float64) - maps[1])[m]
    res.update(views=int(len(gt)), masked_pixels=int(m[..., 0].sum()),
               masked_max_abs_diff=float(diff.max()),
               masked_mean_abs_diff=float(diff.mean()))
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
