"""Port vs JAX: COLMAP → poses_bounds.npy (data/pose_utils.py).

A sparse model written by the port's COLMAP writers is converted by both
packages: rtol 1e-12 (the same float64 formulas). ``gen_poses`` on an
existing model writes poses_bounds.npy without COLMAP; ``run_colmap`` runs
its three stages against a stand-in binary that logs its arguments, and
against a real ``colmap`` where the machine has one (it skips otherwise).
"""
import os
import shutil
import stat
import subprocess

import numpy as np
import pytest

from gbnerf_tpu.data.pose_utils import colmap_to_poses_bounds as j_c2pb
from gbnerf_tpu_torch.data import colmap as tcolmap
from gbnerf_tpu_torch.data import pose_utils as tpu
from gbnerf_tpu_torch.data.llff import load_poses_bounds


def write_sparse_model(tmp_path, rng, n_img=5, model="PINHOLE"):
    """A sparse/0 model: one camera, n_img posed images seeing 10 of 40
    points each, some of their point ids -1 (unmatched keypoints)."""
    sparse = tmp_path / "sparse" / "0"
    os.makedirs(sparse, exist_ok=True)
    params = (np.array([500.0, 520.0, 320.0, 240.0]) if model == "PINHOLE"
              else np.array([510.0, 320.0, 240.0, 0.01]))
    tcolmap.write_cameras_binary(
        {1: tcolmap.Camera(1, model, 640, 480, params)},
        str(sparse / "cameras.bin"))
    pts = {i: tcolmap.Point3D(i, rng.normal(size=3) + np.array([0, 0, 4.0]),
                              np.zeros(3, np.uint8), float(rng.random()),
                              np.array([1], np.int32),
                              np.array([0], np.int32))
           for i in range(1, 41)}
    tcolmap.write_points3d_binary(pts, str(sparse / "points3D.bin"))
    images, c2ws = {}, []
    for k in range(n_img):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        if np.linalg.det(q) < 0:
            q[:, 0] *= -1
        t = rng.normal(size=3)
        w2c = np.eye(4)
        w2c[:3, :3], w2c[:3, 3] = q, t
        c2ws.append(np.linalg.inv(w2c)[:3, :4])
        pids = rng.choice(np.arange(1, 41), 10, replace=False).astype(
            np.int64)
        pids[:2] = -1
        # names out of id order: the rows follow the names
        images[k + 1] = tcolmap.Image(k + 1, tcolmap.rotmat2qvec(q), t, 1,
                                      f"img_{(3 * k) % n_img:03d}.png",
                                      rng.random((10, 2)) * 100, pids)
    tcolmap.write_images_binary(images, str(sparse / "images.bin"))
    return c2ws, images


@pytest.mark.parametrize("model", ["PINHOLE", "SIMPLE_RADIAL"])
def test_colmap_to_poses_bounds_matches_jax(model, tmp_path, rng):
    c2ws, images = write_sparse_model(tmp_path, rng, model=model)
    got = tpu.colmap_to_poses_bounds(str(tmp_path))
    ref = j_c2pb(str(tmp_path))
    assert got.shape == (5, 17)
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=0)
    # the focal: f, or for PINHOLE the documented mean of fx 500, fy 520
    assert (got[:, 14] == 510.0).all()
    # rows in image-name order; the loader's [-u, r, -t] → [r, u, -t]
    # recovers each camera's centre and axes
    np.save(tmp_path / "poses_bounds.npy", got)
    poses, bds = load_poses_bounds(str(tmp_path))
    order = sorted(images, key=lambda i: images[i].name)
    for row, iid in enumerate(order):
        c2w = c2ws[iid - 1]
        np.testing.assert_allclose(poses[row, :3, 3], c2w[:, 3], atol=1e-5)
        np.testing.assert_allclose(poses[row, :3, 0], c2w[:, 0], atol=1e-5)
        np.testing.assert_allclose(poses[row, :3, 1], -c2w[:, 1], atol=1e-5)
    assert (bds[:, 0] < bds[:, 1]).all()


def test_gen_poses_uses_the_existing_model(tmp_path, rng):
    write_sparse_model(tmp_path, rng)
    arr = tpu.gen_poses(str(tmp_path), colmap_bin=str(tmp_path / "absent"))
    np.testing.assert_array_equal(np.load(tmp_path / "poses_bounds.npy"),
                                  arr)
    np.testing.assert_allclose(arr, j_c2pb(str(tmp_path)), rtol=1e-12)


def test_run_colmap_runs_the_three_stages(tmp_path, rng):
    """A stand-in colmap binary logs each call; its mapper writes the
    model that gen_poses then converts."""
    src = tmp_path / "src"
    write_sparse_model(src, rng)
    fake = tmp_path / "colmap"
    fake.write_text(
        "#!/bin/sh\n"
        f"echo \"$@\" >> {tmp_path / 'calls.log'}\n"
        'if [ "$1" = mapper ]; then\n'
        '  while [ "$1" != "--output_path" ]; do shift; done\n'
        f'  cp -r {src / "sparse" / "0"} "$2/0"\nfi\n')
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    scene = tmp_path / "scene"
    (scene / "images").mkdir(parents=True)
    arr = tpu.gen_poses(str(scene), "sequential_matcher", str(fake))
    calls = (tmp_path / "calls.log").read_text().splitlines()
    assert [c.split()[0] for c in calls] == ["feature_extractor",
                                             "sequential_matcher", "mapper"]
    assert f"--database_path {scene / 'database.db'}" in calls[1]
    assert "--Mapper.multiple_models 0" in calls[2]
    assert (scene / "colmap_output.txt").exists()
    np.testing.assert_allclose(arr, j_c2pb(str(src)), rtol=1e-12)
    # a failing stage raises
    fake.write_text("#!/bin/sh\nexit 3\n")
    shutil.rmtree(scene / "sparse")
    with pytest.raises(subprocess.CalledProcessError):
        tpu.run_colmap(str(scene), colmap_bin=str(fake))


def test_run_colmap_with_a_real_binary(tmp_path):
    colmap = shutil.which("colmap")
    if colmap is None:
        pytest.skip("no colmap binary on this machine")
    from gbnerf_tpu_torch.tools import make_synthetic_scene as syn

    (tmp_path / "images").mkdir()
    for k in range(6):
        th = (k / 5 - 0.5) * 0.8
        img, _, _ = syn.render_scene(96, 128, 150.0, syn.look_at(
            np.array([2.5 * np.sin(th), 0.2, 2.5 * np.cos(th)])))
        from gbnerf_tpu_torch.utils.png import write_png
        write_png(str(tmp_path / "images" / f"{k:03d}.png"),
                  (np.clip(img, 0, 1) * 255).astype(np.uint8))
    tpu.run_colmap(str(tmp_path), colmap_bin=colmap)
    assert (tmp_path / "sparse").is_dir()
