"""Blender-synthetic and DTU scene loaders.

Port of gbnerf_tpu/data/blender.py (``pose_spherical`` and its helpers,
``load_blender_data``, ``load_dtu_data``) that needs neither imageio nor
cv2: PNGs are read by the port's codec (utils/png.py, through
``llff._imread``, which hands other formats to imageio where it
imports), ``half_res`` resizes with ``llff.resize_area`` (cv2's
INTER_AREA, also at the non-integer factor of an odd size), and the
projection matrices of DTU are split by ``decompose_projection``, a numpy
copy of cv2.decomposeProjectionMatrix's RQ decomposition.

Blender: transforms_{split}.json → RGBA images + c2w poses,
camera_angle_x → focal, a spherical render path (40 views at φ = −30°,
r = 4), the optional mask/ (m_*.png) and object/ (o_*.png) companions of
the train frames (in the split directory first, then at the scene root),
half_res, testskip.
"""
from __future__ import annotations

import json
import os

import numpy as np

from .llff import _imread, resize_area


def _trans_t(t):
    m = np.eye(4, dtype=np.float32)
    m[2, 3] = t
    return m


def _rot_phi(phi):
    m = np.eye(4, dtype=np.float32)
    m[1, 1] = np.cos(phi); m[1, 2] = -np.sin(phi)
    m[2, 1] = np.sin(phi); m[2, 2] = np.cos(phi)
    return m


def _rot_theta(th):
    m = np.eye(4, dtype=np.float32)
    m[0, 0] = np.cos(th); m[0, 2] = -np.sin(th)
    m[2, 0] = np.sin(th); m[2, 2] = np.cos(th)
    return m


def pose_spherical(theta: float, phi: float, radius: float) -> np.ndarray:
    """c2w [4, 4] of a camera at ``radius`` looking at the origin, at
    azimuth ``theta`` and elevation ``phi`` (degrees)."""
    c2w = _trans_t(radius)
    c2w = _rot_phi(phi / 180.0 * np.pi) @ c2w
    c2w = _rot_theta(theta / 180.0 * np.pi) @ c2w
    flip = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
                    np.float32)
    return flip @ c2w


def load_blender_data(basedir: str, half_res: bool = False, testskip: int = 1):
    """Returns (imgs RGBA [N,H,W,4], poses [N,4,4], render_poses, [H,W,focal],
    i_split (train/val/test index arrays), masks [Nt,H,W], objects)."""
    splits = ["train", "val", "test"]
    metas = {}
    for s in splits:
        with open(os.path.join(basedir, f"transforms_{s}.json")) as fp:
            metas[s] = json.load(fp)

    all_imgs, all_poses, masks, objects, counts = [], [], [], [], [0]
    for s in splits:
        meta = metas[s]
        skip = 1 if (s == "train" or testskip == 0) else testskip
        imgs, poses = [], []
        for frame in meta["frames"][::skip]:
            fname = os.path.join(basedir, frame["file_path"] + ".png")
            if s == "train":
                d, base = os.path.split(fname)
                stem = base[2:-4] if base.startswith("r_") else base[:-4]
                for sub, prefix, dest in (("mask", "m_", masks),
                                          ("object", "o_", objects)):
                    # the companions of <base>/train/r_k.png live in
                    # <base>/train/mask/ (the reference's layout), else in
                    # <base>/mask/
                    p_split = os.path.join(d, sub, f"{prefix}{stem}.png")
                    p_root = os.path.join(os.path.dirname(d), sub,
                                          f"{prefix}{stem}.png")
                    for cand in (p_split, p_root):
                        if os.path.exists(cand):
                            dest.append(_imread(cand))
                            break
            imgs.append(_imread(fname))
            poses.append(np.array(frame["transform_matrix"], np.float32))
        imgs = (np.stack(imgs) / 255.0).astype(np.float32)
        counts.append(counts[-1] + len(imgs))
        all_imgs.append(imgs)
        all_poses.append(np.stack(poses))

    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(3)]
    imgs = np.concatenate(all_imgs)
    poses = np.concatenate(all_poses)
    masks_a = (np.stack(masks).astype(np.float32) / 255.0 if masks
               else np.zeros((0,) + imgs.shape[1:3], np.float32))
    objects_a = (np.stack(objects).astype(np.float32) / 255.0 if objects
                 else np.zeros((0,) + imgs.shape[1:3], np.float32))

    H, W = imgs[0].shape[:2]
    focal = 0.5 * W / np.tan(0.5 * float(metas["test"]["camera_angle_x"]))
    render_poses = np.stack([pose_spherical(a, -30.0, 4.0)
                             for a in np.linspace(-180, 180, 41)[:-1]])

    if half_res:
        H, W, focal = H // 2, W // 2, focal / 2.0

        def half(stack):
            return (np.stack([resize_area(a, H, W) for a in stack])
                    if len(stack) else stack)

        imgs, masks_a, objects_a = half(imgs), half(masks_a), half(objects_a)

    return imgs, poses, render_poses, [H, W, focal], i_split, masks_a, objects_a


def rq_decomposition(M: np.ndarray):
    """M [3, 3] = R Q with R upper triangular and Q a rotation, as
    cv2.RQDecomp3x3 computes it: Givens rotations about x, y and z zero
    M's [2, 1], [2, 0] and [1, 0]; then, where R[0, 0] < 0, R and Q turn
    by 180° about y so that R's first two diagonal entries are positive
    (R[2, 2] carries the sign of det M). → (R, Q), float64."""
    M = np.asarray(M, np.float64)
    eps = np.finfo(np.float64).eps

    def givens(s, c):
        z = 1.0 / np.sqrt(c * c + s * s + eps)
        return s * z, c * z

    s, c = givens(M[2, 1], M[2, 2])
    qx = np.array([[1.0, 0.0, 0.0], [0.0, c, s], [0.0, -s, c]])
    R = M @ qx
    R[2, 1] = 0.0
    s, c = givens(-R[2, 0], R[2, 2])
    qy = np.array([[c, 0.0, -s], [0.0, 1.0, 0.0], [s, 0.0, c]])
    R = R @ qy
    R[2, 0] = 0.0
    s, c = givens(R[1, 0], R[1, 1])
    qz = np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]])
    R = R @ qz
    R[1, 0] = 0.0
    Q = (qz.T @ qy.T) @ qx.T
    if R[0, 0] < 0:
        flip = np.diag([-1.0, 1.0, -1.0])
        R, Q = R @ flip, flip @ Q
    return R, Q


def decompose_projection(P: np.ndarray):
    """P [3, 4] → (K, R, t [4, 1]) as cv2.decomposeProjectionMatrix gives
    them: K R the RQ decomposition of P's left 3 × 3 (``rq_decomposition``,
    K not normalised) and t the homogeneous camera centre, P's null vector
    (unit norm, either sign: the centre is t[:3] / t[3])."""
    P = np.asarray(P, np.float64)
    K, R = rq_decomposition(P[:, :3])
    t = np.linalg.svd(P)[2][-1]
    return K, R, t[:, None]


def load_dtu_data(path: str):
    """DTU layout: image/ + cameras.npz with world_mat_i (P = K[R|t]) and
    optional scale_mat_i → (imgs [N,H,W,3], poses [N,3,4], [H, W, focal])."""
    imgdir = os.path.join(path, "image")
    imgfiles = [os.path.join(imgdir, f) for f in sorted(os.listdir(imgdir))
                if f.lower().endswith((".jpg", ".png"))]
    imgs = np.stack([_imread(f)[..., :3] / 255.0
                     for f in imgfiles]).astype(np.float32)

    cams = np.load(os.path.join(path, "cameras.npz"))
    flip = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)
    poses, focal = [], 0.0
    for i in range(len(imgs)):
        P = cams[f"world_mat_{i}"][:3]
        K, R, t = decompose_projection(P)
        K = K / K[2, 2]
        focal += (K[0, 0] + K[1, 1]) / 2.0
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = R.T
        pose[:3, 3] = (t[:3] / t[3])[:, 0]
        scale = cams.get(f"scale_mat_{i}")
        if scale is not None:
            pose[:3, 3:] -= scale[:3, 3:]
            pose[:3, 3:] /= np.diagonal(scale[:3, :3])[..., None]
        poses.append((flip @ pose @ flip)[:3, :4])
    poses = np.stack(poses)
    H, W = imgs[0].shape[:2]
    return imgs, poses, [H, W, focal / len(imgs)]
