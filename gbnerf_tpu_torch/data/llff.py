"""LLFF / SPIn-NeRF scene loading (poses_bounds.npy + inpainting assets).

Capability parity with the reference DS_NeRF/load_llff.py:
  - poses_bounds.npy [N, 17] → 3×5 pose/hwf + near/far bounds, axis fix
    [-u, r, -t] → [r, u, -t] (load_llff.py:345-346)
  - bound rescale by 1/(bds.min()·bd_factor) (load_llff.py:357-359)
  - pose recentering about the average pose (load_llff.py:246-258)
  - spiral render path from the average pose (load_llff.py:234-244, 420-422)
  - SPIn-NeRF asset layout: images_{f}/RGB_inpainted, images_{f}/label masks,
    images_{f}/Depth_inpainted (load_llff.py:98-109)
  - hard test/train split: first `test_split_count` poses are test
    (load_llff.py:449-450)
  - COLMAP sparse-depth supervision with reprojection-error weights
    2·exp(−(err/ē)²) (load_llff.py:467-518)

Divergence, documented per SURVEY.md §7 "quirks to normalize": the reference's
``spherify_hack`` branch (load_llff.py:368-388) is a no-op in the live path —
it rescales ``bds`` in place by ``sc`` and immediately divides the same array
by ``sc``, and its render poses are unconditionally overwritten by the spiral
path at load_llff.py:420-422. We do not reproduce it. ``spherify=True``
(the real branch) is implemented.

All host-side numpy; the training path uploads the resulting arrays once.

The port's copy of gbnerf_tpu/data/llff.py (``LLFFScene``, the pose
helpers, ``load_poses_bounds``, ``load_llff_data``, ``load_colmap_depth``,
``load_nerd_data``, ``load_sensor_depth``) that needs neither imageio nor
cv2: PNG files are read and written by the port's own codec
(utils/png.py), and the two resizes are numpy (``resize_nearest`` equals
cv2's INTER_NEAREST, ``resize_area`` its INTER_AREA within one level).
Other image formats go through imageio where it is installed.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

import numpy as np

from ..utils.png import read_png, write_png
from .colmap import qvec2rotmat, read_images_binary, read_points3d_binary

_IMG_EXTS = (".jpg", ".jpeg", ".png", ".JPG", ".JPEG", ".PNG")


def _imread(path: str) -> np.ndarray:
    """PNG through the port's codec always (the tests run the code the card
    runs); other formats through imageio where it imports."""
    if path.lower().endswith(".png"):
        return read_png(path)
    try:
        import imageio.v2 as imageio
    except ImportError:
        raise RuntimeError(f"{path}: without imageio only PNG images are "
                           "read") from None
    return np.asarray(imageio.imread(path))


def resize_nearest(img: np.ndarray, H: int, W: int) -> np.ndarray:
    """[h, w, ...] → [H, W, ...] by cv2.INTER_NEAREST's rule: destination
    pixel x takes source pixel min(floor(x · (1 / (W / w))), w − 1), the
    scale inverted in double precision as cv2 does."""
    def taps(n_src, n_dst):
        inv = 1.0 / (n_dst / n_src)
        return np.minimum(np.floor(np.arange(n_dst) * inv).astype(np.int64),
                          n_src - 1)

    return img[taps(img.shape[0], H)][:, taps(img.shape[1], W)]


def _area_weights(n_src: int, n_dst: int) -> np.ndarray:
    """[n_dst, n_src] weights of cv2.INTER_AREA's downsampling along one
    axis: destination pixel i averages the source interval [i·s, (i+1)·s),
    s = n_src / n_dst, each source pixel weighted by its overlap."""
    s = n_src / n_dst
    lo = np.arange(n_dst)[:, None] * s
    k = np.arange(n_src)[None, :]
    overlap = np.clip(np.minimum(k + 1, lo + s) - np.maximum(k, lo), 0, None)
    return overlap / overlap.sum(1, keepdims=True)


def _area_pass(a: np.ndarray, n_dst: int, axis: int) -> np.ndarray:
    """a resized along ``axis`` by the overlap weights, summing each
    destination pixel's few nonzero taps in source order (the weights are
    banded: a dense product would spend its time on zeros)."""
    w = _area_weights(a.shape[axis], n_dst)
    taps = int((w > 0).sum(1).max())
    first = np.argmax(w > 0, axis=1)
    idx = np.minimum(first[:, None] + np.arange(taps), a.shape[axis] - 1)
    wt = np.take_along_axis(w, idx, axis=1)
    wt[first[:, None] + np.arange(taps) >= a.shape[axis]] = 0.0
    a = np.moveaxis(a, axis, 0)
    shape = (-1,) + (1,) * (a.ndim - 1)
    out = wt[:, 0].reshape(shape) * a[idx[:, 0]]
    for t in range(1, taps):
        out += wt[:, t].reshape(shape) * a[idx[:, t]]
    return np.moveaxis(out, 0, axis)


def resize_area(img: np.ndarray, H: int, W: int) -> np.ndarray:
    """[h, w, ...] → [H, W, ...] (H ≤ h, W ≤ w) by area averaging, as
    cv2.INTER_AREA downsamples: at an integer factor that divides h and w
    the box mean, otherwise fractional overlap weights. Integer images
    are rounded to the nearest level (cv2 may differ by one level where
    its single-precision sums round the other way)."""
    out = _area_pass(img.astype(np.float64), H, axis=0)
    out = _area_pass(out, W, axis=1)
    if np.issubdtype(img.dtype, np.integer):
        info = np.iinfo(img.dtype)
        return np.clip(np.rint(out), info.min, info.max).astype(img.dtype)
    return out.astype(img.dtype)


def _list_images(d: str) -> List[str]:
    return [os.path.join(d, f) for f in sorted(os.listdir(d))
            if f.endswith(_IMG_EXTS)]


def normalize(v):
    n = np.linalg.norm(v)
    if not n > 1e-12:   # catches 0 and NaN
        # Fail loudly instead of seeding NaNs that propagate silently
        # through viewmatrix/recenter_poses. A zero
        # vector here means degenerate pose geometry: parallel up/forward
        # in viewmatrix, or cameras whose view directions cancel in
        # poses_avg (e.g. an outward-facing full circle).
        raise ValueError(
            f"normalize(): zero-length vector {v!r} — degenerate camera "
            "poses (parallel up/forward, or view directions that sum to "
            "zero across the pose set)")
    return v / n


def viewmatrix(z, up, pos):
    """Camera-to-world [right|up|back|pos] from forward (-z), up hint, origin."""
    vec2 = normalize(z)
    vec0 = normalize(np.cross(up, vec2))
    vec1 = normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, pos], axis=1)


def poses_avg(poses):
    """Average c2w (mean center, summed viewing dir / up), keeps hwf column."""
    hwf = poses[0, :3, -1:]
    center = poses[:, :3, 3].mean(0)
    vec2 = normalize(poses[:, :3, 2].sum(0))
    up = poses[:, :3, 1].sum(0)
    return np.concatenate([viewmatrix(vec2, up, center), hwf], axis=1)


def recenter_poses(poses):
    """Express all poses relative to their average pose."""
    out = poses.copy()
    bottom = np.array([[0, 0, 0, 1.0]])
    avg = np.concatenate([poses_avg(poses)[:3, :4], bottom], axis=0)
    p44 = np.concatenate(
        [poses[:, :3, :4], np.tile(bottom[None], (len(poses), 1, 1))], axis=1)
    out[:, :3, :4] = (np.linalg.inv(avg) @ p44)[:, :3, :4]
    return out


def render_path_spiral(c2w, up, rads, focal, zrate=0.5, rots=2, N=120):
    """Spiral novel-view path around the average pose (load_llff.py:234-244)."""
    render_poses = []
    rads = np.array(list(rads) + [1.0])
    hwf = c2w[:, 4:5]
    for theta in np.linspace(0.0, 2.0 * np.pi * rots, N + 1)[:-1]:
        c = c2w[:3, :4] @ (np.array(
            [np.cos(theta), -np.sin(theta), -np.sin(theta * zrate), 1.0]) * rads)
        z = normalize(c - c2w[:3, :4] @ np.array([0, 0, -focal, 1.0]))
        render_poses.append(np.concatenate([viewmatrix(z, up, c), hwf], axis=1))
    return np.stack(render_poses).astype(np.float32)


def spherify_poses(poses, bds):
    """Recenter about the point closest to all camera axes; circular path."""

    def p34_to_44(p):
        return np.concatenate(
            [p, np.tile(np.eye(4)[-1].reshape(1, 1, 4), (len(p), 1, 1))], axis=1)

    rays_d = poses[:, :3, 2:3]
    rays_o = poses[:, :3, 3:4]
    A = np.eye(3) - rays_d * np.transpose(rays_d, (0, 2, 1))
    b = -A @ rays_o
    center = np.squeeze(-np.linalg.inv(
        (np.transpose(A, (0, 2, 1)) @ A).mean(0)) @ b.mean(0))

    up = (poses[:, :3, 3] - center).mean(0)
    vec0 = normalize(up)
    vec1 = normalize(np.cross([0.1, 0.2, 0.3], vec0))
    vec2 = normalize(np.cross(vec0, vec1))
    c2w = np.stack([vec1, vec2, vec0, center], axis=1)

    poses_reset = np.linalg.inv(p34_to_44(c2w[None])) @ p34_to_44(poses[:, :3, :4])
    rad = np.sqrt(np.mean(np.sum(poses_reset[:, :3, 3] ** 2, -1)))
    sc = 1.0 / rad
    poses_reset[:, :3, 3] *= sc
    bds = bds * sc

    centroid = poses_reset[:, :3, 3].mean(0)
    zh = centroid[2]
    radcircle = np.sqrt(1.0 - zh ** 2)
    new_poses = []
    for th in np.linspace(0.0, 2.0 * np.pi, 120):
        camorigin = np.array([radcircle * np.cos(th), radcircle * np.sin(th), zh])
        v2 = normalize(camorigin)
        v0 = normalize(np.cross(v2, np.array([0.0, 0.0, -1.0])))
        v1 = normalize(np.cross(v2, v0))
        new_poses.append(np.stack([v0, v1, v2, camorigin], axis=1))
    new_poses = np.stack(new_poses)

    hwf = np.broadcast_to(poses[0, :3, -1:], new_poses[:, :3, :1].shape)
    new_poses = np.concatenate([new_poses, hwf], axis=-1)
    poses_reset = np.concatenate(
        [poses_reset[:, :3, :4],
         np.broadcast_to(poses[0, :3, -1:], poses_reset[:, :3, :1].shape)], axis=-1)
    return poses_reset.astype(np.float32), new_poses.astype(np.float32), bds


@dataclass
class LLFFScene:
    """Everything the training loop needs, as plain numpy arrays."""

    images: np.ndarray             # [N_train, H, W, 3] float32 in [0, 1]
    masks: np.ndarray              # [N_train, H, W] float32 (1 = inpaint region)
    inpainted_depths: np.ndarray   # [N_train, H, W] float32 in [0, 1]
    poses: np.ndarray              # [N_train, 3, 5] train c2w + hwf
    poses_test: np.ndarray         # [N_test, 3, 5]
    bds: np.ndarray                # [N_total, 2] near/far (rescaled)
    render_poses: np.ndarray       # [120, 3, 5] spiral path
    hwf: tuple                     # (H, W, focal)
    near: float = 0.0
    far: float = 1.0
    depth_rays: Optional[List[dict]] = field(default=None)  # colmap supervision
    # Held-out GT for the test poses, when the scene ships it (synthetic
    # scenes via images_*/test_gt/; absent in the SPIn-NeRF layout) — used
    # only for eval-PSNR observability, never for training.
    images_test: Optional[np.ndarray] = field(default=None)
    # Optional test-view inpaint-region masks (test_gt/mask_*.png) enabling
    # masked-region eval metrics — the quantity the guidance stage exists to
    # improve. Never used for training.
    masks_test: Optional[np.ndarray] = field(default=None)


def load_poses_bounds(basedir: str):
    """poses_bounds.npy → ([N, 3, 5] poses with LLFF axis fix, [N, 2] bounds)."""
    arr = np.load(os.path.join(basedir, "poses_bounds.npy"))
    poses = arr[:, :-2].reshape(-1, 3, 5)
    bds = arr[:, -2:]
    # [-u, r, -t] → [r, u, -t]
    poses = np.concatenate(
        [poses[:, :, 1:2], -poses[:, :, 0:1], poses[:, :, 2:]], axis=2)
    return poses.astype(np.float32), bds.astype(np.float32)


def _load_mask_like(path: str, shape, normalize_max: bool) -> np.ndarray:
    try:
        m = _imread(path).astype(np.float32)
    except Exception:
        return -np.ones(shape, np.float32)
    m = m / (m.max() if normalize_max and m.max() > 0 else 255.0)
    if m.ndim > 2:
        m = m[..., 0]
    if m.shape != shape:
        m = resize_nearest(m, shape[0], shape[1])
    return m


def _minify(basedir: str, factor: int, *, origin: bool = True) -> None:
    """Generate images_{factor}/ from full-res assets (pure-Python _minify).

    Parity: the reference DS_NeRF/load_llff.py:14-66 (`_minify`), minus
    the ImageMagick `mogrify` shell-out — ``resize_area`` is the same
    area-average downsampling. Mirrors whichever of the SPIn-NeRF subdirs
    (RGB_inpainted / label / Depth_inpainted) exist at full res; a plain
    images/ dir (origin=False layouts) is downsampled flat. Each image is
    written as PNG under its stem (as mogrify's ``-format png`` does; the
    JAX package keeps the source's name and format).
    """
    src_base = os.path.join(basedir, "images")
    dst_base = os.path.join(basedir, f"images_{factor}")
    subdirs = [d for d in ("RGB_inpainted", "label", "Depth_inpainted")
               if os.path.isdir(os.path.join(src_base, d))]
    pairs = ([(os.path.join(src_base, d), os.path.join(dst_base, d))
              for d in subdirs] if subdirs else [(src_base, dst_base)])
    if not os.path.isdir(src_base):
        return
    for src, dst in pairs:
        os.makedirs(dst, exist_ok=True)
        for f in _list_images(src):
            img = _imread(f)
            H, W = img.shape[:2]
            small = resize_area(img, H // factor, W // factor)
            stem = os.path.splitext(os.path.basename(f))[0]
            write_png(os.path.join(dst, stem + ".png"), small)


def load_llff_data(
    basedir: str,
    factor: int = 4,
    *,
    recenter: bool = True,
    bd_factor: float = 0.75,
    spherify: bool = False,
    origin: bool = True,
    test_split_count: int = 40,
    llffhold: int = 0,
    load_images: bool = True,
) -> LLFFScene:
    """Load a SPIn-NeRF-style LLFF scene.

    The image directory is ``images_{factor}`` (or its ``RGB_inpainted``
    subdir when ``origin=True``). When the factor dir is absent but a
    full-res ``images/`` exists, it is generated on the fly by ``_minify``
    — the reference shells out to ImageMagick mogrify (load_llff.py:52-59);
    ours is ``resize_area`` (cv2's INTER_AREA) with the same on-disk cache
    layout.
    """
    all_poses, bds = load_poses_bounds(basedir)

    sfx = f"_{factor}" if factor and factor != 1 else ""
    base_imgdir = os.path.join(basedir, "images" + sfx)
    if load_images and sfx and not os.path.isdir(base_imgdir):
        _minify(basedir, factor, origin=origin)
    imgdir = os.path.join(base_imgdir, "RGB_inpainted") if origin else base_imgdir
    mskdir = os.path.join(base_imgdir, "label")
    depthdir = os.path.join(base_imgdir, "Depth_inpainted")

    imgfiles = _list_images(imgdir)
    if not imgfiles:
        raise FileNotFoundError(f"no images in {imgdir}")

    sh = _imread(imgfiles[0]).shape
    all_poses[:, 0, 4] = sh[0]
    all_poses[:, 1, 4] = sh[1]
    all_poses[:, 2, 4] = all_poses[:, 2, 4] / factor

    sc = 1.0 if bd_factor is None else 1.0 / (bds.min() * bd_factor)
    all_poses[:, :3, 3] *= sc
    bds = bds * sc

    if recenter:
        all_poses = recenter_poses(all_poses)

    if spherify:
        all_poses, render_poses, bds = spherify_poses(all_poses, bds)
    else:
        c2w = poses_avg(all_poses)
        up = normalize(all_poses[:, :3, 1].sum(0))
        close_depth, inf_depth = bds.min() * 0.9, bds.max() * 5.0
        dt = 0.75
        focal_path = 1.0 / ((1.0 - dt) / close_depth + dt / inf_depth)
        rads = np.percentile(np.abs(all_poses[:, :3, 3]), 90, 0)
        render_poses = render_path_spiral(c2w, up, rads, focal_path)

    # Hard split: the leading poses are the test cameras (reference pins 40
    # for SPIn-NeRF, load_llff.py:449-450). The asset dirs hold only train
    # views, so the split size is inferred from the count difference — which
    # reproduces 40 on SPIn-NeRF (100 poses, 60 train images) and stays
    # correct for any other scene layout. When every pose has an image (no
    # implied split), `llffhold` holds out every Nth view (reference
    # run.py:804-806 `i_test = arange[::llffhold]`), else `test_split_count`
    # holds out the first K — both with the held-out images kept as eval GT.
    n_total = len(all_poses)
    n_test = n_total - len(imgfiles) if len(imgfiles) < n_total else 0
    i_test = None
    if n_test == 0 and len(imgfiles) == n_total:
        if 0 < llffhold < n_total:
            i_test = np.arange(n_total)[::llffhold]
        elif 0 < test_split_count < n_total:
            i_test = np.arange(test_split_count)
    if i_test is not None and len(i_test):
        train_sel = np.ones(n_total, bool)
        train_sel[i_test] = False
        n_test = len(i_test)
        poses_test, poses_train = all_poses[i_test], all_poses[train_sel]
    else:
        i_test = None
        poses_test, poses_train = all_poses[:n_test], all_poses[n_test:]

    H, W = int(sh[0]), int(sh[1])
    focal = float(all_poses[0, 2, 4])

    if not load_images:
        return LLFFScene(
            images=np.zeros((0, H, W, 3), np.float32),
            masks=np.zeros((0, H, W), np.float32),
            inpainted_depths=np.zeros((0, H, W), np.float32),
            poses=poses_train, poses_test=poses_test, bds=bds,
            render_poses=render_poses, hwf=(H, W, focal),
            near=float(bds.min() * 0.9), far=float(bds.max() * 1.0),
        )

    images = np.stack(
        [_imread(f)[..., :3].astype(np.float32) / 255.0 for f in imgfiles])

    mskfiles = []
    if os.path.isdir(mskdir):
        mskfiles = [f for f in _list_images(mskdir)
                    if "cutout" not in f and "pseudo" not in f]
    masks = np.stack(
        [_load_mask_like(f, (H, W), normalize_max=True) for f in mskfiles]
    ) if mskfiles else np.zeros_like(images[..., 0])
    if masks.size and masks.max() > 0:
        masks = masks / masks.max()

    depthfiles = _list_images(depthdir) if os.path.isdir(depthdir) else []
    inpainted_depths = np.stack(
        [_load_mask_like(f, (H, W), normalize_max=False) for f in depthfiles]
    ) if depthfiles else np.zeros_like(images[..., 0])

    n_img = len(images)
    if len(masks) != n_img:
        masks = np.zeros((n_img, H, W), np.float32)
    if len(inpainted_depths) != n_img:
        inpainted_depths = np.zeros((n_img, H, W), np.float32)

    gtdir = os.path.join(os.path.dirname(mskdir), "test_gt")
    images_test = masks_test = None
    if i_test is not None:
        # index-based holdout: the held-out images ARE the eval ground
        # truth; drop them (and their per-view assets) from training.
        images_test = images[i_test]
        images, masks = images[train_sel], masks[train_sel]
        inpainted_depths = inpainted_depths[train_sel]
        n_img = len(images)
    if os.path.isdir(gtdir):
        allfiles = _list_images(gtdir)
        gtfiles = [f for f in allfiles
                   if not os.path.basename(f).startswith("mask")]
        gtmasks = [f for f in allfiles
                   if os.path.basename(f).startswith("mask")]
        if len(gtfiles) == n_test:
            images_test = np.stack(
                [_imread(f)[..., :3].astype(np.float32) / 255.0
                 for f in gtfiles])
            if len(gtmasks) == n_test:
                masks_test = np.stack(
                    [_load_mask_like(f, (H, W), normalize_max=True)
                     for f in gtmasks]).astype(np.float32)

    return LLFFScene(
        images=images, masks=masks.astype(np.float32),
        inpainted_depths=inpainted_depths.astype(np.float32),
        poses=poses_train, poses_test=poses_test, bds=bds,
        render_poses=render_poses, hwf=(H, W, focal),
        near=float(bds.min() * 0.9), far=float(bds.max() * 1.0),
        images_test=images_test, masks_test=masks_test,
    )


def load_nerd_data(basedir: str, factor: int = 8, *, recenter: bool = True,
                   bd_factor: float = 0.75, spherify: bool = False) -> LLFFScene:
    """NeRD layout: LLFF poses_bounds + images_{f}/ + masks (binarised at
    0.5) in images_{f}/masks/, else masks_{f}/; the objects (the images on
    white outside the masks) ride in the inpainted_depths slot, the NeRD
    path having no inpainted depths. No test split."""
    scene = load_llff_data(basedir, factor, recenter=recenter,
                           bd_factor=bd_factor, spherify=spherify,
                           origin=False, test_split_count=0)
    sfx = f"_{factor}" if factor != 1 else ""
    candidates = (os.path.join(basedir, f"images{sfx}", "masks"),
                  os.path.join(basedir, f"masks{sfx}"))
    mskdir = next((d for d in candidates if os.path.isdir(d)), candidates[0])
    if os.path.isdir(mskdir):
        H, W = scene.images.shape[1:3]
        masks = np.stack([_load_mask_like(f, (H, W), normalize_max=False)
                          for f in _list_images(mskdir)])
        masks = (masks > 0.5).astype(np.float32)
        m3 = masks[..., None]
        objects = scene.images * m3 + (1.0 - m3)
        scene = LLFFScene(
            images=scene.images, masks=masks, inpainted_depths=objects[..., 0],
            poses=scene.poses, poses_test=scene.poses_test, bds=scene.bds,
            render_poses=scene.render_poses, hwf=scene.hwf,
            near=scene.near, far=scene.far)
    return scene


def load_colmap_depth(
    basedir: str,
    factor: int = 4,
    *,
    bd_factor: float = 0.75,
    skip_first: int = 40,
) -> List[dict]:
    """Per-train-image sparse depth supervision from the COLMAP model.

    For every 2D keypoint with a 3D match: depth = ⟨c2w_z, p3D − c⟩ · sc,
    kept if inside that image's [near, far], weighted by 2·exp(−(err/ē)²).
    ``skip_first`` mirrors the reference's +40 image-id offset (test images
    occupy the first ids; load_llff.py:491-498).

    Returns: list of {"depth": [K], "coord": [K, 2], "weight": [K]} per train
    image, coords already divided by ``factor``.
    """
    images = read_images_binary(str(Path(basedir) / "sparse" / "0" / "images.bin"))
    points = read_points3d_binary(
        str(Path(basedir) / "sparse" / "0" / "points3D.bin"))

    errs = np.array([p.error for p in points.values()])
    err_mean = errs.mean()

    # c2w for every registered image, in registration (id) order.
    ids = sorted(images.keys())
    c2ws = []
    for iid in ids:
        im = images[iid]
        R, t = qvec2rotmat(im.qvec), im.tvec
        w2c = np.eye(4)
        w2c[:3, :3], w2c[:3, 3] = R, t
        c2ws.append(np.linalg.inv(w2c))
    c2ws = np.stack(c2ws)

    _, bds = load_poses_bounds(basedir)
    sc = 1.0 if bd_factor is None else 1.0 / (bds.min() * bd_factor)

    data_list = []
    n_train = len(ids) - skip_first
    for k in range(n_train):
        im = images[ids[k + skip_first]]
        c2w = c2ws[k]  # reference indexes poses WITHOUT the offset (run as-is)
        lo, hi = bds[k, 0] * sc, bds[k, 1] * sc
        depth_l, coord_l, weight_l = [], [], []
        valid = im.point3D_ids >= 0
        for xy, pid in zip(im.xys[valid], im.point3D_ids[valid]):
            p3d = points[int(pid)].xyz
            depth = float(c2w[:3, 2] @ (p3d - c2w[:3, 3])) * sc
            if depth < lo or depth > hi:
                continue
            err = points[int(pid)].error
            depth_l.append(depth)
            coord_l.append(xy / factor)
            weight_l.append(2.0 * np.exp(-((err / err_mean) ** 2)))
        if depth_l:
            data_list.append({
                "depth": np.array(depth_l, np.float32),
                "coord": np.array(coord_l, np.float32),
                "weight": np.array(weight_l, np.float32),
            })
    return data_list


def load_sensor_depth(basedir: str, factor: int = 8, *,
                      bd_factor: float = 0.75) -> List[dict]:
    """``load_colmap_depth`` over every registered image (no test-split id
    offset), also written to ``<basedir>/colmap_depth.npy`` as a pickled
    object array, as the JAX package writes it."""
    data_list = load_colmap_depth(basedir, factor, bd_factor=bd_factor,
                                  skip_first=0)
    np.save(str(Path(basedir) / "colmap_depth.npy"),
            np.asarray(data_list, dtype=object), allow_pickle=True)
    return data_list
