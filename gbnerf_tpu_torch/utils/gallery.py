"""Result galleries and keypoint overlays for browsing experiments.

Port of gbnerf_tpu/utils/gallery.py (numpy and the standard library).
"""
from __future__ import annotations

import html
import os
from typing import Dict, List, Sequence

import numpy as np


def generate_html_gallery(outdir: str, sections: Dict[str, List[str]],
                          *, title: str = "results",
                          width: int = 320) -> str:
    """Write ``<outdir>/index.html`` with one image grid a section
    ({name: [image paths, absolute or relative to outdir]}) → its path."""
    os.makedirs(outdir, exist_ok=True)
    rows = [f"<html><head><title>{html.escape(title)}</title>"
            "<style>body{font-family:sans-serif;background:#111;color:#eee}"
            "img{margin:2px;vertical-align:top}"
            "h2{margin:12px 0 4px}</style></head><body>"
            f"<h1>{html.escape(title)}</h1>"]
    for name, paths in sections.items():
        rows.append(f"<h2>{html.escape(name)}</h2><div>")
        for p in paths:
            rel = os.path.relpath(p, outdir) if os.path.isabs(p) else p
            rows.append(f'<img src="{html.escape(rel)}" width="{width}">')
        rows.append("</div>")
    rows.append("</body></html>")
    out = os.path.join(outdir, "index.html")
    with open(out, "w") as f:
        f.write("\n".join(rows))
    return out


def draw_keypoints(image, coords: Sequence, *, radius: int = 2,
                   color=(255, 0, 0)) -> np.ndarray:
    """A copy of image [H, W, 3] (uint8, or float in [0, 1]) as uint8 with
    a filled square of ``radius`` drawn at each (x, y)."""
    img = np.array(image, copy=True)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    H, W = img.shape[:2]
    for x, y in coords:
        x, y = int(round(float(x))), int(round(float(y)))
        y0, y1 = max(y - radius, 0), min(y + radius + 1, H)
        x0, x1 = max(x - radius, 0), min(x + radius + 1, W)
        img[y0:y1, x0:x1] = color
    return img
