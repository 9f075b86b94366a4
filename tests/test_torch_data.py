"""Port vs JAX: the scene loaders (numpy-only copies), the ray banks, batch
sampling and the image losses.

The loaders and ``build_ray_banks`` are numpy on both sides and must give
equal arrays, on a scene written by tools/make_synthetic_scene.py (with a
synthetic COLMAP sparse model), and on one written by the port's twin of
that tool, with the port's loader also run where imageio and cv2 cannot
be imported. ``sample_batch`` is held to the JAX draw by
injecting the indices JAX drew.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gbnerf_tpu.data import colmap as jcolmap
from gbnerf_tpu.data import llff as jllff
from gbnerf_tpu.data import rays_bank as jbank
from gbnerf_tpu.utils import metrics as jmetrics
from gbnerf_tpu_torch.data import colmap as tcolmap
from gbnerf_tpu_torch.data import llff as tllff
from gbnerf_tpu_torch.data import rays_bank as tbank
from gbnerf_tpu_torch.utils.png import read_png, write_png
from gbnerf_tpu_torch.utils import metrics as tmetrics

ROOT = Path(__file__).resolve().parents[1]
N_TEST, N_TRAIN = 2, 5


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("synth") / "scene"
    subprocess.run([sys.executable, str(ROOT / "tools" /
                                        "make_synthetic_scene.py"), str(out),
                    "--task", "inpaint", "--colmap_sparse", "--n_sparse",
                    "30", "--n_train", str(N_TRAIN), "--n_test", str(N_TEST),
                    "--H", "24", "--W", "32"],
                   check=True, capture_output=True, timeout=120)
    return str(out)


def _assert_same_records(a, b):
    assert a.keys() == b.keys()
    for k in a:
        for field in a[k].__dataclass_fields__:
            va, vb = getattr(a[k], field), getattr(b[k], field)
            if isinstance(va, np.ndarray):
                np.testing.assert_array_equal(va, vb, err_msg=field)
            else:
                assert va == vb, field


def test_colmap_binary_model_matches_jax(scene_dir):
    sp = os.path.join(scene_dir, "sparse", "0")
    for name, reader in (("cameras.bin", "read_cameras_binary"),
                         ("images.bin", "read_images_binary"),
                         ("points3D.bin", "read_points3d_binary")):
        path = os.path.join(sp, name)
        _assert_same_records(getattr(tcolmap, reader)(path),
                             getattr(jcolmap, reader)(path))


def test_colmap_write_read_round_trip_matches_jax(scene_dir, tmp_path):
    """The port writes text and binary models; both packages read them
    back to the same records as the source model. The text comparison
    keeps the images that have 2-D points: the JAX reader mis-pairs the
    empty point line of an image without any (see the next test)."""
    cams, images, points = tcolmap.read_model(
        os.path.join(scene_dir, "sparse", "0"))
    with_pts = {k: v for k, v in images.items() if len(v.xys)}
    assert 0 < len(with_pts) < len(images)
    for ext, ims in ((".txt", with_pts), (".bin", images)):
        out = tmp_path / ext[1:]
        tcolmap.write_model(cams, ims, points, str(out), ext=ext)
        got = tcolmap.read_model(str(out))
        ref = jcolmap.read_model(str(out))
        for g, r, src in zip(got, ref, (cams, ims, points)):
            _assert_same_records(g, r)
            _assert_same_records(g, src)


def test_colmap_text_images_without_points_round_trip(scene_dir, tmp_path):
    """An image with no 2-D points is written with an empty second line;
    the port's reader pairs it with its head (a fault of the JAX reader,
    ROADMAP C)."""
    _, images, _ = tcolmap.read_model(os.path.join(scene_dir, "sparse", "0"))
    assert any(len(v.xys) == 0 for v in images.values())
    path = str(tmp_path / "images.txt")
    tcolmap.write_images_text(images, path)
    _assert_same_records(tcolmap.read_images_text(path), images)


def test_quaternions_match_jax(rng):
    q = rng.standard_normal(4)
    q /= np.linalg.norm(q)
    R = tcolmap.qvec2rotmat(q)
    np.testing.assert_array_equal(R, jcolmap.qvec2rotmat(q))
    np.testing.assert_array_equal(tcolmap.rotmat2qvec(R),
                                  jcolmap.rotmat2qvec(R))
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-12)


def _assert_same_scene(a, b):
    for field in a.__dataclass_fields__:
        va, vb = getattr(a, field), getattr(b, field)
        if isinstance(va, np.ndarray):
            np.testing.assert_array_equal(va, vb, err_msg=field)
        elif isinstance(va, tuple):
            assert tuple(va) == tuple(vb), field
        else:
            assert va == vb, field


def test_load_llff_data_matches_jax(scene_dir):
    got = tllff.load_llff_data(scene_dir, 4, test_split_count=N_TEST)
    ref = jllff.load_llff_data(scene_dir, 4, test_split_count=N_TEST)
    _assert_same_scene(got, ref)
    assert got.images.shape == (N_TRAIN, 24, 32, 3)
    assert got.images_test is not None and got.masks_test is not None


def test_load_llff_data_holdout_and_no_images_match_jax(scene_dir):
    """The llffhold branch, and load_images=False (poses only)."""
    for kw in ({"llffhold": 2, "test_split_count": 0},
               {"load_images": False}):
        _assert_same_scene(tllff.load_llff_data(scene_dir, 4, **kw),
                           jllff.load_llff_data(scene_dir, 4, **kw))


def test_pose_helpers_match_jax(scene_dir):
    poses, bds = tllff.load_poses_bounds(scene_dir)
    jposes, jbds = jllff.load_poses_bounds(scene_dir)
    np.testing.assert_array_equal(poses, jposes)
    np.testing.assert_array_equal(bds, jbds)
    for name in ("recenter_poses", "poses_avg"):
        np.testing.assert_array_equal(getattr(tllff, name)(poses),
                                      getattr(jllff, name)(poses))
    for g, r in zip(tllff.spherify_poses(poses, bds),
                    jllff.spherify_poses(poses, bds)):
        np.testing.assert_array_equal(g, r)
    with pytest.raises(ValueError):
        tllff.normalize(np.zeros(3))


def test_load_colmap_depth_matches_jax(scene_dir):
    got = tllff.load_colmap_depth(scene_dir, 4, skip_first=N_TEST)
    ref = jllff.load_colmap_depth(scene_dir, 4, skip_first=N_TEST)
    assert len(got) == len(ref) == N_TRAIN
    for g, r in zip(got, ref):
        assert g.keys() == r.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)


def test_llff_module_imports_without_image_codecs():
    """The machine with the card has neither imageio nor cv2: importing the
    port's loader must not need them."""
    code = ("import sys; sys.modules['imageio'] = None; "
            "sys.modules['cv2'] = None; "
            "import gbnerf_tpu_torch.data.llff, gbnerf_tpu_torch.train.loop")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=ROOT, timeout=120)


@pytest.fixture(scope="module")
def twin_scene_dir(tmp_path_factory):
    """The same scene written by the port's twin of the tool."""
    out = tmp_path_factory.mktemp("twin") / "scene"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    subprocess.run([sys.executable, "-m",
                    "gbnerf_tpu_torch.tools.make_synthetic_scene", str(out),
                    "--task", "inpaint", "--colmap_sparse", "--n_sparse",
                    "30", "--n_train", str(N_TRAIN), "--n_test", str(N_TEST),
                    "--H", "24", "--W", "32"], check=True, env=env, cwd=ROOT,
                   capture_output=True, timeout=120)
    return str(out)


def test_load_llff_data_of_the_twins_scene_matches_jax(twin_scene_dir):
    """Both packages' loaders on a scene the port's twin wrote (PNGs of the
    port's codec): equal arrays (atol 1e-6: the same uint8 / 255)."""
    got = tllff.load_llff_data(twin_scene_dir, 4, test_split_count=N_TEST)
    ref = jllff.load_llff_data(twin_scene_dir, 4, test_split_count=N_TEST)
    for field in got.__dataclass_fields__:
        g, r = getattr(got, field), getattr(ref, field)
        if isinstance(g, np.ndarray):
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-6,
                                       err_msg=field)
        else:
            assert tuple(np.atleast_1d(g)) == tuple(np.atleast_1d(r)), field
    assert got.masks_test is not None and got.masks.max() == 1.0


_BLOCKED_LOAD = """
import sys
sys.modules["imageio"] = None
sys.modules["cv2"] = None
import numpy as np
from gbnerf_tpu_torch.data import llff
scene = llff.load_llff_data(sys.argv[1], 4, test_split_count=int(sys.argv[3]))
depth = llff.load_colmap_depth(sys.argv[1], 4, skip_first=int(sys.argv[3]))
np.savez(sys.argv[2], images=scene.images, masks=scene.masks,
         depths=scene.inpainted_depths, images_test=scene.images_test,
         masks_test=scene.masks_test, poses=scene.poses,
         d0=depth[0]["depth"])
"""


def test_port_loader_runs_without_imageio_and_cv2(twin_scene_dir, tmp_path):
    """The card's machine has neither module: with both blocked the port
    loads the scene (and minifies a full-resolution one) to the arrays the
    JAX package loads with them."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = tmp_path / "blocked.npz"
    subprocess.run([sys.executable, "-c", _BLOCKED_LOAD, twin_scene_dir,
                    str(out), str(N_TEST)], check=True, env=env, cwd=ROOT,
                   timeout=120)
    ref = jllff.load_llff_data(twin_scene_dir, 4, test_split_count=N_TEST)
    depth = jllff.load_colmap_depth(twin_scene_dir, 4, skip_first=N_TEST)
    with np.load(out) as got:
        for k, r in (("images", ref.images), ("masks", ref.masks),
                     ("depths", ref.inpainted_depths),
                     ("images_test", ref.images_test),
                     ("masks_test", ref.masks_test), ("poses", ref.poses),
                     ("d0", depth[0]["depth"])):
            np.testing.assert_allclose(got[k], r, rtol=0, atol=1e-6,
                                       err_msg=k)


def test_minify_without_imageio_and_cv2_within_one_level_of_jax(
        twin_scene_dir, tmp_path):
    """A scene shipped at full resolution only (images/, no images_4/):
    the port's _minify (area resize, PNG) against the JAX package's
    (cv2.INTER_AREA, imageio): within one level (1/255) of each other."""
    import shutil

    full = tmp_path / "full"
    shutil.copytree(twin_scene_dir, full)
    shutil.move(str(full / "images_4"), str(full / "images_small"))
    src = tllff.load_llff_data(twin_scene_dir, 4, test_split_count=N_TEST)
    # the full-resolution assets: each image ×4 by pixel repetition
    for sub in ("RGB_inpainted", "label", "Depth_inpainted"):
        os.makedirs(full / "images" / sub)
        for f in sorted(os.listdir(full / "images_small" / sub)):
            img = read_png(str(full / "images_small" / sub / f))
            big = np.repeat(np.repeat(img, 4, 0), 4, 1)
            big[1::4, 2::4] = big[1::4, 2::4] // 2     # not a flat box
            write_png(str(full / "images" / sub / f), big)
    jdir = tmp_path / "jfull"
    shutil.copytree(full, jdir)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = tmp_path / "blocked.npz"
    subprocess.run([sys.executable, "-c", _BLOCKED_LOAD, str(full),
                    str(out), str(N_TEST)], check=True, env=env, cwd=ROOT,
                   timeout=120)
    ref = jllff.load_llff_data(str(jdir), 4, test_split_count=N_TEST)
    with np.load(out) as got:
        for k, r in (("images", ref.images), ("masks", ref.masks),
                     ("depths", ref.inpainted_depths)):
            assert got[k].shape == r.shape == getattr(
                src, {"depths": "inpainted_depths"}.get(k, k)).shape
            np.testing.assert_allclose(got[k], r, rtol=0,
                                       atol=1 / 255 + 1e-6, err_msg=k)


@pytest.fixture(scope="module")
def banks(scene_dir):
    scene = tllff.load_llff_data(scene_dir, 4, test_split_count=N_TEST)
    depth = tllff.load_colmap_depth(scene_dir, 4, skip_first=N_TEST)
    args = (scene.images, scene.masks, scene.inpainted_depths, scene.poses,
            scene.hwf[2], depth)
    return tbank.build_ray_banks(*args), jbank.build_ray_banks(*args)


def test_build_ray_banks_matches_jax(banks):
    got, ref = banks
    for name in ("rgb", "rgb_clf", "rgb_sds", "inp", "depth"):
        g, r = getattr(got, name), getattr(ref, name)
        assert len(g) == len(r) > 0, name
        for field in ("rays_o", "rays_d", "target"):
            np.testing.assert_array_equal(getattr(g, field),
                                          getattr(r, field),
                                          err_msg=f"{name}.{field}")
    for field in ("mask_coords", "mask_valid", "mask_counts"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(ref, field), err_msg=field)


def test_sample_batch_with_injected_draw_matches_jax(banks):
    got, ref = banks
    key = jax.random.PRNGKey(3)
    jstream = ref.rgb_clf.device_put()
    jb = jbank.sample_batch(jstream, key, 64)
    idx = np.asarray(jax.random.randint(key, (64,), 0, len(ref.rgb_clf)))
    tb = tbank.sample_batch(got.rgb_clf.to("cpu"), 64,
                            idx=torch.from_numpy(idx.copy()))
    for k in ("o", "d", "target"):
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]),
                                      err_msg=k)


def test_sample_batch_draws_from_the_generator(banks):
    stream = banks[0].inp.to("cpu")
    a = tbank.sample_batch(stream, 500, torch.Generator().manual_seed(1))
    b = tbank.sample_batch(stream, 500, torch.Generator().manual_seed(1))
    c = tbank.sample_batch(stream, 500, torch.Generator().manual_seed(2))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["o"], c["o"]) or not torch.equal(a["d"], c["d"])
    assert a["target"].shape == (500, 1) and a["o"].dtype == torch.float32


def test_ray_stream_to_device_keeps_values(banks):
    s = banks[0].depth
    t = s.to("cpu")
    np.testing.assert_array_equal(t["o"].numpy(), s.rays_o)
    np.testing.assert_array_equal(t["d"].numpy(), s.rays_d)
    np.testing.assert_array_equal(t["target"].numpy(), s.target)


def test_image_losses_match_jax(rng):
    x, y = (rng.random((40, 3)).astype(np.float32) for _ in range(2))
    m = rng.random((40, 1)).astype(np.float32)
    w = rng.random((40, 3)).astype(np.float32)
    t = torch.from_numpy
    for name, args in (("img2mse", (x, y)), ("img2l1", (x, y)),
                       ("img2mse_mask", (x, y, m)),
                       ("weighted_mse", (x, y, w))):
        got = getattr(tmetrics, name)(*map(t, args))
        ref = getattr(jmetrics, name)(*map(jnp.asarray, args))
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6,
                                   err_msg=name)
