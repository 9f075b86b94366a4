"""Eval rendering: pose-path renders, their image, video and map dumps,
the held-out metrics, and the one-ray σ profile.

Port of gbnerf_tpu/train/eval.py: ``render_pose_path``,
``convert_pose``, ``render_path_projection`` (per-pose z-values and
weights for reprojection), ``render_test_ray`` with ``visualize_sigma``,
``save_video``, ``dump_eval_images`` (rgb/disp PNGs through the port's
codec, utils/png.py, and the metrics, with LPIPS when an LPIPS function
is given) with its metric core ``eval_summary``, and ``save_maps`` (each
map as .npy). Videos are always GIFs (utils/gif.py: the JAX package
writes mp4 where imageio has an ffmpeg backend, else GIF), and
``visualize_sigma`` draws its plot with numpy, not matplotlib: the
machine with the card has neither imageio nor matplotlib.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from ..core.rays import ndc_rays
from ..core.render import raw2outputs
from ..utils.gif import write_gif
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


def convert_pose(c2w: np.ndarray) -> np.ndarray:
    """OpenGL → OpenCV camera: flip the y and z axes of a [4, 4] c2w."""
    flip_yz = np.eye(4)
    flip_yz[1, 1] = flip_yz[2, 2] = -1.0
    return c2w @ flip_yz


def render_path_projection(render_fn, poses, hwf, *, render_factor: int = 0,
                           device=None):
    """Per pose the fine pass's z_vals and weights [H·W, S] of a full view
    (one render call, no gradient), the OpenCV-convention c2w [4, 4] and
    the intrinsics K: the inputs of reprojection and warping →
    (z_vals list, weights list, c2ws list, K)."""
    H, W, focal = int(hwf[0]), int(hwf[1]), float(hwf[2])
    if render_factor and render_factor > 1:
        H, W, focal = H // render_factor, W // render_factor, focal / render_factor
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]])
    z_vals, weights, c2ws = [], [], []
    for pose in poses:
        p34 = np.asarray(pose, np.float32)[:3, :4]
        ro, rd = _full_view_rays(H, W, focal, torch.as_tensor(p34,
                                                              device=device))
        with torch.no_grad():
            out = render_fn(ro.reshape(-1, 3), rd.reshape(-1, 3), None,
                            train=False)
        z_vals.append(out.z_vals.cpu().numpy())
        weights.append(out.weights.cpu().numpy())
        c2ws.append(convert_pose(np.concatenate(
            [p34.astype(np.float64), np.array([[0, 0, 0, 1.0]])], axis=0)))
    return z_vals, weights, c2ws, K


def render_test_ray(field_fn, ray_o: torch.Tensor, ray_d: torch.Tensor, *,
                    near: float, far: float, n_samples: int, ndc=None
                    ) -> Dict[str, np.ndarray]:
    """σ and weight profile along one ray at ``n_samples`` uniform
    z-values from near to far (not the hierarchical samples of a render):
    ``field_fn`` (the fine field's FieldFn) queried at those points
    directly, σ = relu(raw σ), composited by ``raw2outputs``.

    ray_o, ray_d: [3] on the field's device. ndc: optional (H, W, focal):
    the ray goes through ndc_rays (near plane 1) and marches [0, 1], with
    the view direction of the world-space ray. → {z_vals [S], sigma [S],
    weights [S], alpha [S], depth (float), rgb [3]} as numpy.
    """
    with torch.no_grad():
        viewdirs = (ray_d / torch.linalg.norm(ray_d))[None]       # [1, 3]
        ro, rd = ray_o[None], ray_d[None]
        lo, hi = near, far
        if ndc is not None:
            H, W, focal = ndc
            ro, rd = ndc_rays(int(H), int(W), float(focal), 1.0, ro, rd)
            lo, hi = 0.0, 1.0
        t = torch.linspace(0.0, 1.0, n_samples, dtype=ro.dtype,
                           device=ro.device)
        z_vals = (lo * (1.0 - t) + hi * t)[None]                  # [1, S]
        pts = ro[:, None, :] + rd[:, None, :] * z_vals[..., None]
        raw = field_fn(pts, viewdirs)
        rgb, _, _, weights, depth, alpha = raw2outputs(raw, z_vals, rd)
        sigma = torch.relu(raw[..., 3])
    return {"z_vals": z_vals[0].cpu().numpy(),
            "sigma": sigma[0].cpu().numpy(),
            "weights": weights[0].cpu().numpy(),
            "alpha": alpha[0].cpu().numpy(),
            "depth": float(depth[0]),
            "rgb": rgb[0].cpu().numpy()}


# visualize_sigma's canvas: matplotlib's figsize (6, 3) at 100 dpi, the plot
# box inside the margins, its colours (the curve in matplotlib's first
# colour, the depth line red, dashed in runs of SIGMA_DASH pixels)
SIGMA_CANVAS, SIGMA_MARGINS = (300, 600), (12, 14, 36, 52)   # t, r, b, l
SIGMA_CURVE, SIGMA_DEPTH, SIGMA_DASH = (31, 119, 180), (255, 0, 0), 6


def visualize_sigma(profile: Dict[str, np.ndarray], path: str) -> None:
    """Plot one ray's σ against z_vals, with a dashed red vertical at its
    depth, to a PNG (drawn with numpy, written by utils/png.py)."""
    H, W = SIGMA_CANVAS
    top, right, bottom, left = SIGMA_MARGINS
    img = np.full((H, W, 3), 255, np.uint8)
    y0, y1, x0, x1 = top, H - 1 - bottom, left, W - 1 - right
    img[y0:y1 + 1, [x0, x1]] = 0                  # the plot box
    img[[y0, y1], x0:x1 + 1] = 0
    z = np.asarray(profile["z_vals"], np.float64)
    sig = np.asarray(profile["sigma"], np.float64)
    zlo, zhi = float(z.min()), float(z.max())
    if zhi <= zlo:
        zhi = zlo + 1.0
    smax = float(sig.max()) * 1.05 if sig.max() > 0 else 1.0

    def col(v):
        return x0 + 1 + (v - zlo) / (zhi - zlo) * (x1 - x0 - 2)

    def row(v):
        return y1 - 1 - v / smax * (y1 - y0 - 2)

    # the polyline, sampled at every pixel step of each segment, 2 px wide
    xs, ys = col(z), row(sig)
    for a in range(len(z) - 1):
        n = int(max(abs(xs[a + 1] - xs[a]), abs(ys[a + 1] - ys[a]))) + 2
        t = np.linspace(0.0, 1.0, n)
        cx = np.rint(xs[a] + t * (xs[a + 1] - xs[a])).astype(int)
        cy = np.rint(ys[a] + t * (ys[a + 1] - ys[a])).astype(int)
        for dy in (0, 1):
            img[np.clip(cy + dy, y0 + 1, y1 - 1), cx] = SIGMA_CURVE
    dc = int(np.rint(np.clip(col(profile["depth"]), x0 + 1, x1 - 1)))
    rows = np.arange(y0 + 1, y1)
    dash = rows[((rows - y0 - 1) // SIGMA_DASH) % 2 == 0]
    img[dash, dc] = SIGMA_DEPTH
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_png(path, img)


def save_video(frames: np.ndarray, path: str, fps: int = 30) -> str:
    """Write frames in [0, 1] ([N, H, W, 3] colour or [N, H, W] grey) as
    ``<path without its extension>.gif`` → that path."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    return write_gif(os.path.splitext(path)[0] + ".gif", to8b(frames),
                     fps=fps)


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
