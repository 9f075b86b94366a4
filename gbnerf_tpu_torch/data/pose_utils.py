"""COLMAP → poses_bounds.npy (offline preprocessing).

The port's own copy of gbnerf_tpu/data/pose_utils.py, on the port's COLMAP
reader (data/colmap.py). It mirrors the reference's gen_poses
(DS_NeRF/llff/poses/pose_utils.py:259, colmap_wrapper.py:23-78): optionally
run the COLMAP binaries (feature_extractor → matcher → mapper), then convert
the sparse model to the LLFF poses_bounds.npy convention:

  stored 3×5 per image = [[-u | r | -t | trans | hwf]] columns in COLMAP's
  (x right, y down, z forward) frame → LLFF's column permutation
  [y, x, −z, t, hwf]; bounds = 0.5 / 99.5 depth percentiles of the visible
  3D points per image (pose_utils.py:82).
"""
from __future__ import annotations

import os
import subprocess
from typing import Optional

import numpy as np

from .colmap import image_w2c, read_model


def run_colmap(basedir: str, match_type: str = "exhaustive_matcher",
               colmap_bin: str = "colmap") -> None:
    """feature_extractor → matcher → mapper into ``basedir/sparse``, the
    log in ``basedir/colmap_output.txt`` (colmap_wrapper.py's)."""
    db = os.path.join(basedir, "database.db")
    imgdir = os.path.join(basedir, "images")
    sparse = os.path.join(basedir, "sparse")
    os.makedirs(sparse, exist_ok=True)
    logfile = os.path.join(basedir, "colmap_output.txt")
    with open(logfile, "w") as log:
        for args in (
            [colmap_bin, "feature_extractor", "--database_path", db,
             "--image_path", imgdir, "--ImageReader.single_camera", "1"],
            [colmap_bin, match_type, "--database_path", db],
            [colmap_bin, "mapper", "--database_path", db, "--image_path",
             imgdir, "--output_path", sparse,
             "--Mapper.num_threads", "16",
             "--Mapper.init_min_tri_angle", "4",
             "--Mapper.multiple_models", "0",
             "--Mapper.extract_colors", "0"],
        ):
            subprocess.run(args, check=True, stdout=log, stderr=log)


def colmap_to_poses_bounds(basedir: str) -> np.ndarray:
    """The sparse/0 model → [N, 17] poses_bounds rows, in image-name
    order."""
    cams, images, points = read_model(os.path.join(basedir, "sparse", "0"))
    cam = next(iter(cams.values()))
    H, W = cam.height, cam.width
    if cam.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL"):
        focal = cam.params[0]
    else:
        # Divergence kept from the JAX package: the reference takes
        # params[0] (= fx) unconditionally (pose_utils.py:21); for the
        # PINHOLE family fx and fy are averaged, which suits the LLFF
        # single-focal convention better.
        focal = 0.5 * (cam.params[0] + cam.params[1])

    order = sorted(images.keys(), key=lambda i: images[i].name)
    rows = []
    for iid in order:
        im = images[iid]
        R, t = image_w2c(im)
        w2c = np.eye(4)
        w2c[:3, :3], w2c[:3, 3] = R, t
        c2w = np.linalg.inv(w2c)[:3, :4]
        # COLMAP (r, d, f) → LLFF stored columns [d, r, -f] ≡ [-u, r, -t]
        m = np.concatenate(
            [c2w[:, 1:2], c2w[:, 0:1], -c2w[:, 2:3], c2w[:, 3:4]], axis=1)
        hwf = np.array([[H], [W], [focal]], np.float64)
        p35 = np.concatenate([m, hwf], axis=1)

        # depth bounds from this image's visible 3D points
        zs = [float(R[2] @ points[pid].xyz + t[2])
              for pid in im.point3D_ids if pid >= 0 and pid in points]
        if zs:
            close, inf = np.percentile(zs, 0.5), np.percentile(zs, 99.5)
        else:
            close, inf = 0.1, 100.0
        rows.append(np.concatenate([p35.ravel(), [close, inf]]))
    return np.stack(rows)


def gen_poses(basedir: str, match_type: str = "exhaustive_matcher",
              colmap_bin: str = "colmap") -> Optional[np.ndarray]:
    """The whole pipeline: COLMAP unless sparse/0 already holds a model,
    then ``basedir/poses_bounds.npy``; returns its rows."""
    sparse0 = os.path.join(basedir, "sparse", "0")
    have = (os.path.exists(sparse0) and
            {f.split(".")[0] for f in os.listdir(sparse0)} >=
            {"cameras", "images", "points3D"})
    if not have:
        run_colmap(basedir, match_type, colmap_bin)
    arr = colmap_to_poses_bounds(basedir)
    np.save(os.path.join(basedir, "poses_bounds.npy"), arr)
    return arr
