"""Eval rendering: pose-path renders, their image and map dumps and the
held-out metrics.

Port of gbnerf_tpu/train/eval.py: ``render_pose_path``,
``dump_eval_images`` (rgb/disp PNGs through the port's codec, utils/png.py,
and the metrics, with LPIPS when an LPIPS function is given) with its
metric core ``eval_summary``, and ``save_maps`` (each map as .npy, the
raw-array dumps of the JAX package's render_only). The video writer is
not ported: spiral renders stay .npy maps.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from ..utils.metrics import to8b
from ..utils.png import write_png
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


def _psnr(mse: float) -> float:
    return -10.0 * np.log10(max(mse, 1e-10))


def eval_summary(maps: Dict[str, np.ndarray], gt: Optional[np.ndarray] = None,
                 gt_masks: Optional[np.ndarray] = None
                 ) -> Dict[str, Optional[float]]:
    """Held-out metrics of a pose-path render, as the JAX package's
    dump_eval_images computes them: mean PSNR over the ground-truth views,
    and where a view has an inpaint-region mask (1 = inpainted) the PSNR
    inside it and outside it. Entries are None when not computable."""
    psnrs, m_psnrs, u_psnrs = [], [], []
    if gt is not None:
        for k in range(len(maps["rgb"])):
            err = (maps["rgb"][k] - gt[k]) ** 2
            psnrs.append(_psnr(float(np.mean(err))))
            if gt_masks is not None and gt_masks[k].max() > 0:
                m = np.broadcast_to(gt_masks[k][..., None] > 0.5, err.shape)
                m_psnrs.append(_psnr(float(np.mean(err[m]))))
                u_psnrs.append(_psnr(float(np.mean(err[~m]))))

    def mean(xs):
        return float(np.mean(xs)) if xs else None

    return {"psnr": mean(psnrs), "psnr_masked": mean(m_psnrs),
            "psnr_unmasked": mean(u_psnrs)}


def dump_eval_images(maps: Dict[str, np.ndarray], outdir: str, *,
                     gt: Optional[np.ndarray] = None, lpips_fn=None,
                     gt_masks: Optional[np.ndarray] = None
                     ) -> Dict[str, Optional[float]]:
    """Per-frame ``rgb/NNN.png`` and ``disp/NNN.png`` (disparity over its
    maximum) under ``outdir`` — the reference's eval_images_{i}/ layout —
    and the metrics {psnr, lpips, psnr_masked, psnr_unmasked}: means over
    the ground-truth views (``eval_summary``), None where not computable.
    lpips_fn: an optional utils/lpips.py ``LPIPS``, run on its device;
    gt_masks: optional [N, H, W] inpaint-region test masks (1 = inpainted).
    """
    for sub in ("rgb", "disp"):
        os.makedirs(os.path.join(outdir, sub), exist_ok=True)
    lpipss = []
    for k in range(len(maps["rgb"])):
        write_png(os.path.join(outdir, "rgb", f"{k:03d}.png"),
                  to8b(maps["rgb"][k]))
        disp = maps["disp"][k]
        write_png(os.path.join(outdir, "disp", f"{k:03d}.png"),
                  to8b(disp / max(disp.max(), 1e-8)))
        if gt is not None and lpips_fn is not None:
            def dev(x):
                return torch.as_tensor(np.asarray(x, np.float32)[None],
                                       device=lpips_fn.device)

            with torch.no_grad():
                lpipss.append(float(torch.mean(lpips_fn(dev(maps["rgb"][k]),
                                                        dev(gt[k])))))
    em = eval_summary(maps, gt=gt, gt_masks=gt_masks)
    return {"psnr": em["psnr"],
            "lpips": float(np.mean(lpipss)) if lpipss else None,
            "psnr_masked": em["psnr_masked"],
            "psnr_unmasked": em["psnr_unmasked"]}
