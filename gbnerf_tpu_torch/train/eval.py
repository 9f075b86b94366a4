"""Eval rendering: pose-path renders and their map dumps.

Port of gbnerf_tpu/train/eval.py::render_pose_path. Maps are written as
.npy (``save_maps``), the raw-array dumps of the JAX package's render_only;
PNG and video writers need imageio and come with the CLI.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from .step import _full_view_rays, make_image_renderer


def render_pose_path(render_fn, poses, hwf, *, render_factor: int = 0,
                     block: int = 8192, device=None) -> Dict[str, np.ndarray]:
    """Render [N, 3, 4]+ poses on ``device`` → dict of stacked numpy maps.

    render_factor > 1 downsamples H, W and focal.
    """
    H, W, focal = int(hwf[0]), int(hwf[1]), float(hwf[2])
    if render_factor and render_factor > 1:
        H, W, focal = H // render_factor, W // render_factor, focal / render_factor

    image_render = make_image_renderer(render_fn, block=block)
    maps = {"rgb": [], "disp": [], "depth": [], "acc": []}
    for pose in poses:
        pose_t = torch.as_tensor(np.asarray(pose)[:3, :4], dtype=torch.float32,
                                 device=device)
        ro, rd = _full_view_rays(H, W, focal, pose_t)
        out = image_render(ro, rd)
        for k in maps:
            maps[k].append(out[k].cpu().numpy())
    return {k: np.stack(v) for k, v in maps.items()}


def save_maps(maps: Dict[str, np.ndarray], outdir: str) -> Dict[str, str]:
    """Write each stacked map as ``<outdir>/<name>.npy`` → {name: path}."""
    os.makedirs(outdir, exist_ok=True)
    paths = {}
    for k, v in maps.items():
        paths[k] = os.path.join(outdir, f"{k}.npy")
        np.save(paths[k], np.asarray(v))
    return paths
