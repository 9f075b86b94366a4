#!/usr/bin/env python
"""Labeled masked-region crop strips from an ablation run directory.

The port's twin of tools/make_crops.py: reads the held-out ground truth
(``scene/images_4/test_gt/img_*.png`` + ``mask_*.png``, written by the
synthetic-scene tool) and each arm's final
``logs/<arm>/eval_images_<iter>/rgb/<view>.png``, crops the mask's padded
bounding box, and tiles [GT | arm1 | arm2 | ...] with labels. PNGs are read
and written with the port's codec (utils/png.py) and the labels drawn in
numpy with a 3 × 5 bitmap font (lower case as upper), since PIL is not
assumed: the crops are the JAX tool's pixels, the label band its own.

Usage:
  python -m gbnerf_tpu_torch.tools.make_crops /tmp/abl out.png \\
      --arms s1,nog,prior [--view 1] [--pad 12] [--scale 4]
"""
from __future__ import annotations

import argparse
import glob
import os
import re

import numpy as np

from ..utils.png import read_png, write_png

# 3 × 5 glyphs, one string of 5 rows of 3 pixels ("#" ink)
_FONT = {
    "A": ".#.#.#####.##.#", "B": "##.#.###.#.###.", "C": ".###..#..#...##",
    "D": "##.#.##.##.###.", "E": "####..###..####", "F": "####..###..#...",
    "G": ".###..#.##.#.##", "H": "#.##.####.##.##", "I": "###.#..#..#.###",
    "J": "..#..#..##.#.#.", "K": "#.##.###.#.##.#", "L": "#..#..#..#..###",
    "M": "#.#####.##.##.#", "N": "##.#.##.##.##.#", "O": ".#.#.##.##.#.#.",
    "P": "##.#.###.#..#..", "Q": ".#.#.##.##.#..#", "R": "##.#.###.#.##.#",
    "S": ".###...#...###.", "T": "###.#..#..#..#.", "U": "#.##.##.##.####",
    "V": "#.##.##.##.#.#.", "W": "#.##.##.######.", "X": "#.##.#.#.#.##.#",
    "Y": "#.##.#.#..#..#.", "Z": "###..#.#.#..###", "0": "####.##.##.####",
    "1": ".#.##..#..#.###", "2": "##...#.#.#..###", "3": "##...#.#...###.",
    "4": "#.##.####..#..#", "5": "####..##...###.", "6": ".###..####.####",
    "7": "###..#.#..#..#.", "8": "####.#####.####", "9": "####.####..###.",
    "-": "......###......", "_": "............###", ".": ".............#.",
    " ": "...............",
}


def _glyph(ch: str) -> np.ndarray:
    rows = _FONT.get(ch.upper(), _FONT[" "])
    return np.array([c == "#" for c in rows]).reshape(5, 3)


def draw_text(canvas: np.ndarray, x: int, y: int, text: str,
              color=(0, 0, 0), scale: int = 2) -> None:
    """Draw ``text`` into canvas [H, W, 3] in place, top-left at (x, y)."""
    for i, ch in enumerate(text):
        g = np.kron(_glyph(ch), np.ones((scale, scale), bool))
        x0 = x + i * 4 * scale
        h = min(g.shape[0], canvas.shape[0] - y)
        w = min(g.shape[1], canvas.shape[1] - x0)
        if h <= 0 or w <= 0:
            break
        canvas[y:y + h, x0:x0 + w][g[:h, :w]] = color


def load(path: str) -> np.ndarray:
    """A PNG as [H, W, 3] uint8 (grey replicated, alpha dropped: PIL's
    convert("RGB"))."""
    a = read_png(path)
    if a.dtype == np.uint16:
        a = (a >> 8).astype(np.uint8)
    if a.ndim == 2:
        a = a[..., None]
    if a.shape[-1] in (1, 2):
        return np.repeat(a[..., :1], 3, axis=-1)
    return a[..., :3]


def load_grey(path: str) -> np.ndarray:
    """A PNG as [H, W] uint8 luma, PIL's convert("L"): (19595 R + 38470 G
    + 7471 B + 2^15) >> 16."""
    a = load(path).astype(np.uint32)
    return ((19595 * a[..., 0] + 38470 * a[..., 1] + 7471 * a[..., 2]
             + 0x8000) >> 16).astype(np.uint8)


def final_eval_dir(logdir: str) -> str:
    cands = glob.glob(os.path.join(logdir, "eval_images_*"))
    if not cands:
        raise SystemExit(f"no eval_images_* under {logdir}")
    return max(cands, key=lambda p: int(re.search(r"(\d+)$", p).group(1)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir", help="ablation run dir (scene/ + logs/)")
    ap.add_argument("png", help="output figure path")
    ap.add_argument("--arms", required=True,
                    help="comma list, tiled left-to-right after GT")
    ap.add_argument("--view", type=int, default=None,
                    help="held-out view index (default: largest mask)")
    ap.add_argument("--pad", type=int, default=10,
                    help="bbox padding in px")
    ap.add_argument("--scale", type=int, default=4,
                    help="nearest-neighbor upscale factor")
    args = ap.parse_args(argv)

    gt_dir = os.path.join(args.out_dir, "scene", "images_4", "test_gt")
    masks = sorted(glob.glob(os.path.join(gt_dir, "mask_*.png")))
    if not masks:
        raise SystemExit(f"no test_gt masks under {gt_dir}")
    mask_im = [load_grey(m) > 127 for m in masks]
    view = (args.view if args.view is not None
            else int(np.argmax([m.sum() for m in mask_im])))
    mask = mask_im[view]
    gt = load(os.path.join(gt_dir, f"img_{view:03d}.png"))

    ys, xs = np.nonzero(mask)
    y0 = max(0, ys.min() - args.pad)
    y1 = min(mask.shape[0], ys.max() + 1 + args.pad)
    x0 = max(0, xs.min() - args.pad)
    x1 = min(mask.shape[1], xs.max() + 1 + args.pad)

    tiles = [("GT", gt)]
    for arm in args.arms.split(","):
        d = final_eval_dir(os.path.join(args.out_dir, "logs", arm))
        tiles.append((arm, load(os.path.join(d, "rgb", f"{view:03d}.png"))))

    s, label_h, gap = args.scale, 16, 2
    ch, cw = (y1 - y0) * s, (x1 - x0) * s
    W = len(tiles) * (cw + gap) - gap
    canvas = np.full((ch + label_h, W, 3), 255, np.uint8)
    for i, (name, im) in enumerate(tiles):
        # nearest upscale by an integer factor: each pixel s × s
        crop = np.repeat(np.repeat(im[y0:y1, x0:x1], s, 0), s, 1)
        xoff = i * (cw + gap)
        canvas[label_h:, xoff:xoff + cw] = crop
        draw_text(canvas, xoff + 2, 2, name)
    write_png(args.png, canvas)
    print(f"wrote {args.png}  view={view} bbox=({y0}:{y1},{x0}:{x1}) "
          f"tiles={[t[0] for t in tiles]}")
    return canvas


if __name__ == "__main__":
    main()
