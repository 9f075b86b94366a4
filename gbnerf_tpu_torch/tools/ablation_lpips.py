"""Perceptual distance of an ablation run's held-out renders (LPIPS).

The twin of tools/ablation_lpips.py, on the port's utils/lpips.py and
PNG codec:

    python -m gbnerf_tpu_torch.tools.ablation_lpips OUT [--vgg_npz PATH] \\
        [--device cuda|cpu]

OUT is a run directory of tools/run_ablation.py or its twin: for every arm
under OUT/logs/ with eval renders, the VGG feature distance of its last
eval_images_*/rgb PNGs to the clean held-out views of OUT/scene/images_*/
test_gt, over the full image and over the bounding box of the intruder
masks (widened to 32 pixels for the VGG pyramid); the table goes to
OUT/ablation_lpips.json. Without --vgg_npz (tools/convert_vgg.py's output)
the VGG weights are random: a proxy perceptual distance, labelled so, not
the paper's LPIPS. LPIPS runs on the first CUDA device unless --device
cpu.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np


def _read(path: str) -> np.ndarray:
    from ..utils.png import read_png

    return read_png(path)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("out", help="ablation dir (run_ablation's output)")
    ap.add_argument("--vgg_npz", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; an error without a card) or cpu")
    args = ap.parse_args(argv)

    import torch

    from ..train.loop import device_from_flag
    from ..utils.lpips import LPIPS, load_vgg16_npz

    device = device_from_flag(args.device)
    weights = load_vgg16_npz(args.vgg_npz) if args.vgg_npz else None
    lp = LPIPS(torch.Generator().manual_seed(0), weights=weights,
               device=device)
    tag = "lpips" if args.vgg_npz else "lpips_proxy(random-VGG)"

    def dist(a: np.ndarray, b: np.ndarray) -> float:
        with torch.no_grad():
            d = lp(torch.as_tensor(a, dtype=torch.float32, device=device),
                   torch.as_tensor(b, dtype=torch.float32, device=device))
        return float(d.mean())

    scene = os.path.join(args.out, "scene")
    gtdirs = glob.glob(os.path.join(scene, "images_*", "test_gt"))
    if not gtdirs:
        raise SystemExit(f"no {scene}/images_*/test_gt: not an ablation dir")
    gts = sorted(f for f in glob.glob(os.path.join(gtdirs[0], "*.png"))
                 if "mask" not in os.path.basename(f))
    masks = sorted(glob.glob(os.path.join(gtdirs[0], "mask*.png")))
    gt = np.stack([_read(f)[..., :3] / 255.0 for f in gts])
    mk = np.stack([_read(f) for f in masks]).astype(np.float32)
    if mk.ndim == 4:
        mk = mk[..., 0]
    mk = mk / max(mk.max(), 1.0)

    results = {}
    for armdir in sorted(glob.glob(os.path.join(args.out, "logs", "*"))):
        arm = os.path.basename(armdir)
        evals = sorted(glob.glob(os.path.join(armdir, "eval_images_*")),
                       key=lambda p: int(p.rsplit("_", 1)[1]))
        if not evals:
            continue
        preds = sorted(glob.glob(os.path.join(evals[-1], "rgb",
                                              "[0-9]*.png")))[:len(gt)]
        pred = np.stack([_read(f)[..., :3] / 255.0 for f in preds])
        full = dist(pred, gt)
        # the masks' shared bounding box, at least 32 pixels a side
        ys, xs = np.where(mk.max(0) > 0.5)
        y0, y1 = ys.min(), ys.max() + 1
        x0, x1 = xs.min(), xs.max() + 1
        H, W = mk.shape[1:]
        while (y1 - y0) < 32:
            y0, y1 = max(0, y0 - 1), min(H, y1 + 1)
        while (x1 - x0) < 32:
            x0, x1 = max(0, x0 - 1), min(W, x1 + 1)
        masked = dist(pred[:, y0:y1, x0:x1], gt[:, y0:y1, x0:x1])
        results[arm] = {"full": round(full, 5), "mask_bbox": round(masked, 5)}
        print(f"{arm:6s} {tag}: full={full:.5f} mask_bbox={masked:.5f}")

    table = {"metric": tag, "results": results}
    with open(os.path.join(args.out, "ablation_lpips.json"), "w") as f:
        json.dump(table, f, indent=2)
    return table


if __name__ == "__main__":
    main()
