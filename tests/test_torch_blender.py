"""Port vs JAX: the Blender, DTU and NeRD loaders, the sensor-depth loader
and ``load_scene`` for every dataset type.

The loaders are numpy on both sides. The JAX package reads through
imageio and resizes and decomposes through cv2; the port reads PNGs with
its own codec, resizes with ``resize_area`` and decomposes with a numpy RQ
decomposition. Arrays read without a resize are equal; ``half_res``
(cv2's INTER_AREA on float32 RGBA, also at the non-integer factor of an
odd size) agrees to 1e-6 (cv2 sums in float32); the
DTU poses to 1e-5 (float32 poses from float64 decompositions that agree
to ~1e-13 relative).
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from gbnerf_tpu import config as jconfig
from gbnerf_tpu.data import blender as jblender
from gbnerf_tpu.data import llff as jllff
from gbnerf_tpu.train import loop as jloop
from gbnerf_tpu_torch import config as tconfig
from gbnerf_tpu_torch.data import blender as tblender
from gbnerf_tpu_torch.data import llff as tllff
from gbnerf_tpu_torch.train import loop as tloop

ROOT = Path(__file__).resolve().parents[1]


def _write_blender(d, H, W, seed, *, companions_in_split, rgba_masks=False):
    import imageio.v2 as imageio

    rng = np.random.default_rng(seed)
    for split, n in (("train", 3), ("val", 2), ("test", 3)):
        os.makedirs(d / split, exist_ok=True)
        frames = []
        for k in range(n):
            name = f"r_{k}"
            rgba = (rng.random((H, W, 4)) * 255).astype(np.uint8)
            imageio.imwrite(str(d / split / f"{name}.png"), rgba)
            pose = np.asarray(jblender.pose_spherical(360 * k / n, -30.0,
                                                      4.0))
            frames.append({"file_path": f"./{split}/{name}",
                           "transform_matrix": pose.tolist()})
            if split == "train":
                base = d / split if companions_in_split else d
                for sub, prefix in (("mask", "m_"), ("object", "o_")):
                    os.makedirs(base / sub, exist_ok=True)
                    shape = (H, W, 4) if rgba_masks else (H, W)
                    m = (rng.random(shape) * 255).astype(np.uint8)
                    imageio.imwrite(str(base / sub / f"{prefix}{k}.png"), m)
        with open(d / f"transforms_{split}.json", "w") as f:
            json.dump({"camera_angle_x": 0.8, "frames": frames}, f)
    return str(d)


@pytest.fixture(scope="module")
def blender_dirs(tmp_path_factory):
    """The JAX test's layout (20 × 20, companions at the scene root), and
    an odd size (21 × 23) with RGBA companions in the split directory."""
    return {
        "even": _write_blender(tmp_path_factory.mktemp("blender_even"), 20,
                               20, 0, companions_in_split=False),
        "odd": _write_blender(tmp_path_factory.mktemp("blender_odd"), 21, 23,
                              1, companions_in_split=True, rgba_masks=True),
    }


@pytest.mark.parametrize("which,half_res,testskip", [
    ("even", False, 1), ("even", True, 2), ("odd", False, 0),
    ("odd", True, 1)])
def test_load_blender_data_matches_jax(blender_dirs, which, half_res,
                                       testskip):
    got = tblender.load_blender_data(blender_dirs[which], half_res=half_res,
                                     testskip=testskip)
    ref = jblender.load_blender_data(blender_dirs[which], half_res=half_res,
                                     testskip=testskip)
    names = ("imgs", "poses", "render_poses", "hwf", "i_split", "masks",
             "objects")
    for name, g, r in zip(names, got, ref):
        if name == "i_split":
            for a, b in zip(g, r):
                np.testing.assert_array_equal(a, b)
        elif name == "hwf":
            assert g[:2] == r[:2] and g[2] == pytest.approx(r[2], rel=1e-12)
        else:
            assert g.shape == r.shape and g.dtype == r.dtype, name
            np.testing.assert_allclose(g, r, rtol=0,
                                       atol=1e-6 if half_res else 0,
                                       err_msg=name)
    imgs, _, render_poses, hwf, i_split, masks, objects = got
    n_val_test = len(i_split[1]) + len(i_split[2])
    assert render_poses.shape == (40, 4, 4) and len(masks) == len(objects) == 3
    assert n_val_test == {0: 5, 1: 5, 2: 3}[testskip]
    H = {"even": 20, "odd": 21}[which]
    assert hwf[0] == (H // 2 if half_res else H) and imgs.shape[-1] == 4


@pytest.mark.parametrize("shape", [(20, 20), (21, 23), (801, 800),
                                   (37, 41, 4)])
def test_resize_area_matches_cv2_inter_area(rng, shape):
    """half_res's resize: float32 RGBA (and grey) at an even size and at
    odd sizes, where H // 2 makes a non-integer factor."""
    import cv2

    full = shape if len(shape) == 3 else shape + (4,)
    for img in (rng.random(full).astype(np.float32),
                rng.random(full[:2]).astype(np.float32)):
        H, W = img.shape[0] // 2, img.shape[1] // 2
        got = tllff.resize_area(img, H, W)
        ref = cv2.resize(img, (W, H), interpolation=cv2.INTER_AREA)
        assert got.shape == ref.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_pose_spherical_matches_jax():
    for theta, phi, r in ((0.0, -30.0, 4.0), (123.0, 10.0, 2.5),
                          (-180.0, -90.0, 1.0)):
        np.testing.assert_array_equal(tblender.pose_spherical(theta, phi, r),
                                      jblender.pose_spherical(theta, phi, r))


def _random_projections(rng):
    """Seeded P = K [R | t]: positive and negative determinants, P scaled
    by −1, and plain Gaussian matrices."""
    import cv2

    out = []
    for i in range(40):
        K = np.array([[rng.uniform(100, 900), rng.uniform(-5, 5),
                       rng.uniform(100, 400)],
                      [0, rng.uniform(100, 900), rng.uniform(100, 400)],
                      [0, 0, 1.0]])
        R = cv2.Rodrigues(rng.standard_normal(3))[0]
        P = K @ np.concatenate([R, rng.standard_normal((3, 1))], 1)
        out += [P, -P]
        g = rng.standard_normal((3, 4))
        if np.linalg.det(g[:, :3]) > 0:
            g[0] = -g[0]                    # a negative determinant
        out += [g, -g]
    return out


def test_decompose_projection_matches_cv2(rng):
    """(K / K[2, 2], R, t[:3] / t[3]), what load_dtu_data reads, against
    cv2.decomposeProjectionMatrix; both signs of det and of P."""
    import cv2

    dets = set()
    for P in _random_projections(rng):
        K, R, t = cv2.decomposeProjectionMatrix(P)[:3]
        k, r, tt = tblender.decompose_projection(P)
        dets.add(bool(np.linalg.det(P[:, :3]) > 0))
        np.testing.assert_allclose(k / k[2, 2], K / K[2, 2], rtol=1e-10,
                                   atol=1e-10 * np.abs(K / K[2, 2]).max())
        np.testing.assert_allclose(r, R, rtol=0, atol=1e-10)
        np.testing.assert_allclose(tt[:3] / tt[3], t[:3] / t[3], rtol=1e-9,
                                   atol=1e-12)
        assert abs(np.linalg.det(r) - 1.0) < 1e-10 and k[0, 0] > 0 < k[1, 1]
        np.testing.assert_allclose(k @ r, P[:, :3], rtol=1e-10,
                                   atol=1e-10 * np.abs(P).max())
    assert dets == {True, False}


@pytest.fixture(scope="module")
def dtu_dir(tmp_path_factory):
    """tests/test_alt_loaders.py's DTU fixture, with a scale matrix that is
    not the identity and one camera whose P is scaled by −1."""
    import imageio.v2 as imageio

    rng = np.random.default_rng(0)
    d = tmp_path_factory.mktemp("dtu")
    os.makedirs(d / "image")
    H = W = 16
    K = np.array([[20.0, 0, 8], [0, 20.0, 8], [0, 0, 1]])
    cams = {}
    for i in range(4):
        img = (rng.random((H, W, 3)) * 255).astype(np.uint8)
        imageio.imwrite(str(d / "image" / f"{i:03d}.png"), img)
        th = 0.3 * i
        R = np.array([[np.cos(th), -np.sin(th), 0],
                      [np.sin(th), np.cos(th), 0], [0, 0, 1.0]])
        t = np.array([0.1 * i, 0.0, 2.0])
        P = np.eye(4)
        P[:3] = K @ np.concatenate([R, t[:, None]], axis=1)
        cams[f"world_mat_{i}"] = -P if i == 3 else P
        scale = np.eye(4)
        scale[:3, :3] *= 1.5
        scale[:3, 3] = [0.1, -0.2, 0.3]
        cams[f"scale_mat_{i}"] = scale
    np.savez(str(d / "cameras.npz"), **cams)
    return str(d)


def test_load_dtu_data_matches_jax(dtu_dir):
    imgs, poses, hwf = tblender.load_dtu_data(dtu_dir)
    jimgs, jposes, jhwf = jblender.load_dtu_data(dtu_dir)
    np.testing.assert_array_equal(imgs, jimgs)
    assert poses.dtype == jposes.dtype == np.float32
    np.testing.assert_allclose(poses, jposes, rtol=0, atol=1e-5)
    assert hwf[:2] == jhwf[:2]
    assert hwf[2] == pytest.approx(jhwf[2], rel=1e-10)


def _write_nerd(d, in_images_dir):
    import imageio.v2 as imageio

    rng = np.random.default_rng(1)
    H, W, n = 12, 16, 4
    mdir = d / "images_4" / "masks" if in_images_dir else d / "masks_4"
    os.makedirs(mdir)
    os.makedirs(d / "images_4", exist_ok=True)
    for i in range(n):
        imageio.imwrite(str(d / "images_4" / f"{i:03d}.png"),
                        (rng.random((H, W, 3)) * 255).astype(np.uint8))
        m = (rng.random((H, W)) * 255).astype(np.uint8)   # binarised at 0.5
        imageio.imwrite(str(mdir / f"{i:03d}.png"), m)
    poses = np.zeros((n, 3, 5), np.float32)
    for i in range(n):
        th = 0.2 * i
        poses[i, :3, :3] = [[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                            [-np.sin(th), 0, np.cos(th)]]
        poses[i, :3, 3] = [0.1 * i, 0.05 * i, 0]
        poses[i, :3, 4] = [H, W, 20.0]
    pb = np.concatenate([poses.reshape(n, -1),
                         np.tile([1.0, 5.0], (n, 1))], axis=1)
    np.save(str(d / "poses_bounds.npy"), pb)
    return str(d)


@pytest.fixture(scope="module")
def nerd_dirs(tmp_path_factory):
    return {where: _write_nerd(tmp_path_factory.mktemp(f"nerd_{where}"),
                               where == "images")
            for where in ("images", "root")}


def _assert_same_scene(a, b, atol=0.0):
    for field in a.__dataclass_fields__:
        va, vb = getattr(a, field), getattr(b, field)
        if isinstance(va, np.ndarray) or isinstance(vb, np.ndarray):
            assert np.shape(va) == np.shape(vb), field
            np.testing.assert_allclose(va, vb, rtol=0, atol=atol,
                                       err_msg=field)
        elif isinstance(va, (tuple, list)):
            assert len(va) == len(vb), field
            np.testing.assert_allclose(np.asarray(va, float),
                                       np.asarray(vb, float), rtol=1e-12,
                                       err_msg=field)
        else:
            assert va == vb, field


@pytest.mark.parametrize("where", ["images", "root"])
@pytest.mark.parametrize("recenter", [True, False])
def test_load_nerd_data_matches_jax(nerd_dirs, where, recenter):
    got = tllff.load_nerd_data(nerd_dirs[where], factor=4, recenter=recenter)
    ref = jllff.load_nerd_data(nerd_dirs[where], factor=4, recenter=recenter)
    _assert_same_scene(got, ref)
    assert set(np.unique(got.masks)) == {0.0, 1.0}
    obj = got.inpainted_depths
    assert np.allclose(obj[got.masks == 0], 1.0)


@pytest.fixture(scope="module")
def llff_dir(tmp_path_factory):
    """A scene with a sparse COLMAP model, written by the port's twin of
    tools/make_synthetic_scene.py."""
    out = tmp_path_factory.mktemp("synth") / "scene"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    subprocess.run([sys.executable, "-m",
                    "gbnerf_tpu_torch.tools.make_synthetic_scene", str(out),
                    "--task", "inpaint", "--colmap_sparse", "--n_sparse",
                    "30", "--n_train", "4", "--n_test", "2", "--H", "24",
                    "--W", "32"], check=True, env=env, cwd=ROOT,
                   capture_output=True, timeout=120)
    return str(out)


def test_load_sensor_depth_matches_jax(llff_dir, tmp_path):
    """Every registered image (no test offset), and colmap_depth.npy
    written as the same pickled object array."""
    import shutil

    jdir, tdir = tmp_path / "j", tmp_path / "t"
    shutil.copytree(llff_dir, jdir)
    shutil.copytree(llff_dir, tdir)
    got = tllff.load_sensor_depth(str(tdir), factor=4)
    ref = jllff.load_sensor_depth(str(jdir), factor=4)
    assert len(got) == len(ref) >= 4
    on_disk = (np.load(tdir / "colmap_depth.npy", allow_pickle=True),
               np.load(jdir / "colmap_depth.npy", allow_pickle=True))
    assert on_disk[0].dtype == on_disk[1].dtype == object
    for g, r, dg, dr in zip(got, ref, *on_disk):
        assert g.keys() == r.keys() == dg.keys() == dr.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)
            np.testing.assert_array_equal(dg[k], dr[k], err_msg=k)


def _configs(dataset_type, datadir, **data):
    out = []
    for mod in (jconfig, tconfig):
        cfg = mod.Config()
        cfg = cfg.replace(
            data=dataclasses.replace(cfg.data, datadir=datadir,
                                     dataset_type=dataset_type, **data),
            render=dataclasses.replace(cfg.render, white_bkgd=True))
        out.append(cfg)
    return out


@pytest.mark.parametrize("case", ["llff", "nerd", "blender", "blender_half",
                                  "blender_black", "dtu"])
def test_load_scene_matches_jax(case, llff_dir, nerd_dirs, blender_dirs,
                                dtu_dir):
    """load_scene for all four dataset types: every field of the scene
    equal to the JAX load_scene's (half_res and DTU at the tolerances of
    the tests above)."""
    atol = 0.0
    if case == "llff":
        jcfg, tcfg = _configs("llff", llff_dir, factor=4, test_split_count=2)
    elif case == "nerd":
        jcfg, tcfg = _configs("nerd", nerd_dirs["images"], factor=4)
    elif case == "dtu":
        jcfg, tcfg = _configs("dtu", dtu_dir)
        atol = 1e-5
    else:
        jcfg, tcfg = _configs("blender", blender_dirs["odd"], testskip=1,
                              half_res=case == "blender_half")
        atol = 1e-6 if case == "blender_half" else 0.0
        if case == "blender_black":
            jcfg = jcfg.replace(render=dataclasses.replace(
                jcfg.render, white_bkgd=False))
            tcfg = tcfg.replace(render=dataclasses.replace(
                tcfg.render, white_bkgd=False))
    got, ref = tloop.load_scene(tcfg), jloop.load_scene(jcfg)
    _assert_same_scene(got, ref, atol=atol)
    assert got.images.shape[-1] == 3 and len(got.masks) == len(got.images)
    if case.startswith("blender"):
        assert (got.near, got.far) == (2.0, 6.0) and got.poses.shape[1:] == (
            3, 5)
    with pytest.raises(SystemExit):
        tloop.load_scene(_configs("bogus", llff_dir)[1])


_BLOCKED = """
import sys, json
sys.modules["imageio"] = None
sys.modules["cv2"] = None
import numpy as np
from gbnerf_tpu_torch.data import blender
imgs, poses, rp, hwf, split, masks, objects = blender.load_blender_data(
    sys.argv[1], half_res=True, testskip=1)
np.savez(sys.argv[2], imgs=imgs, masks=masks, objects=objects)
imgs, poses, hwf = blender.load_dtu_data(sys.argv[3])
np.savez(sys.argv[4], imgs=imgs, poses=poses)
"""


def test_loaders_run_without_imageio_and_cv2(blender_dirs, dtu_dir,
                                             tmp_path):
    """The card's machine has neither module: with both blocked, the
    Blender loader (half_res at an odd size) and the DTU loader give the
    arrays the JAX package reads with them."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    subprocess.run([sys.executable, "-c", _BLOCKED, blender_dirs["odd"],
                    str(tmp_path / "b.npz"), dtu_dir,
                    str(tmp_path / "d.npz")], check=True, env=env, cwd=ROOT,
                   timeout=120)
    ref = jblender.load_blender_data(blender_dirs["odd"], half_res=True,
                                     testskip=1)
    with np.load(tmp_path / "b.npz") as got:
        for k, r in (("imgs", ref[0]), ("masks", ref[5]),
                     ("objects", ref[6])):
            np.testing.assert_allclose(got[k], r, rtol=0, atol=1e-6,
                                       err_msg=k)
    jimgs, jposes, _ = jblender.load_dtu_data(dtu_dir)
    with np.load(tmp_path / "d.npz") as got:
        np.testing.assert_array_equal(got["imgs"], jimgs)
        np.testing.assert_allclose(got["poses"], jposes, rtol=0, atol=1e-5)
