"""Port vs JAX: the eval paths this slice adds — ``get_rays_by_coord``,
``render_test_ray`` (with ``visualize_sigma``), ``render_path_projection``
and ``convert_pose`` — and the port's GIF writer and reader, and
``render_only``'s artifact set.

``render_test_ray`` is held with ``NeRFMLP`` in float64 on both sides
(rtol 1e-6, as tests/test_torch_render.py holds the render glue), and on
small CP fields with converted parameters at the field tolerance (both
round every matmul operand to bf16 but sum in another order: σ to
rtol 3e-2 with atol 5e-3·max|σ|, the composited depth to 2e-2).
The GIFs are read back with imageio's and Pillow's readers: grey frames
exactly, colour frames within half a step of the palette.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gbnerf_tpu.config import Config, FieldConfig, RenderConfig
from gbnerf_tpu.core import rays as jrays
from gbnerf_tpu.core.fields import NeRFMLP as JNeRFMLP
from gbnerf_tpu.core.fields import make_field_fn as j_make_field_fn
from gbnerf_tpu.train import eval as jeval
from gbnerf_tpu.train import step as jstep
from gbnerf_tpu.train.state import create_train_state
from gbnerf_tpu_torch import convert
from gbnerf_tpu_torch.core import rays as trays
from gbnerf_tpu_torch.core.fields import NeRFMLP as TNeRFMLP
from gbnerf_tpu_torch.core.fields import make_field_fn as t_make_field_fn
from gbnerf_tpu_torch.train import eval as teval
from gbnerf_tpu_torch.train import loop as tloop
from gbnerf_tpu_torch.train import step as tstep
from gbnerf_tpu_torch.train.state import create_params
from gbnerf_tpu_torch.utils.gif import read_gif, write_gif
from gbnerf_tpu_torch.utils.png import read_png

torch.set_num_threads(1)

MLP_KW = dict(depth=3, width=32, skips=(1,), multires=4, multires_views=2)
PROFILE_KEYS = ("z_vals", "sigma", "weights", "alpha", "depth", "rgb")


def test_get_rays_by_coord_matches_jax(rng):
    coords = rng.uniform(-2, 30, (50, 2)).astype(np.float32)
    c2w = rng.standard_normal((3, 4)).astype(np.float32)
    ref = jrays.get_rays_by_coord(24, 32, 27.5, jnp.asarray(c2w),
                                  jnp.asarray(coords))
    got = trays.get_rays_by_coord(24, 32, 27.5, torch.from_numpy(c2w),
                                  torch.from_numpy(coords))
    for g, r in zip(got, ref):
        assert g.shape == (50, 3)
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    # a keypoint at a pixel's corner gives get_rays' ray of that pixel
    full = trays.get_rays(24, 32, 27.5, torch.from_numpy(c2w))[1]
    at = trays.get_rays_by_coord(24, 32, 27.5, torch.from_numpy(c2w),
                                 torch.tensor([[5.0, 7.0]]))[1]
    np.testing.assert_array_equal(at[0].numpy(), full[7, 5].numpy())


def _mlp_pair(seed):
    jm = JNeRFMLP(compute_dtype=jnp.float64, **MLP_KW)
    pts = jnp.zeros((2, 3))
    params = jm.init(jax.random.PRNGKey(seed), pts, pts)["params"]
    params = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64),
                                    params)
    tm = TNeRFMLP(compute_dtype=torch.float64, **MLP_KW).double()
    convert.load_jax_params(tm, params)
    return jm, params, tm


def _forward_ray(rng, dtype):
    ro = (rng.standard_normal(3) * 0.2).astype(dtype)
    rd = rng.standard_normal(3).astype(dtype)
    rd[2] = -abs(rd[2]) - 0.5                     # forward-facing, for NDC
    return ro, rd


@pytest.mark.parametrize("ndc", [None, (24, 32, 30.0)])
def test_render_test_ray_f64_matches_jax(rng, ndc):
    ro, rd = _forward_ray(rng, np.float64)
    jax.config.update("jax_enable_x64", True)
    try:
        jm, params, tm = _mlp_pair(4)
        ref = jeval.render_test_ray(
            lambda p: j_make_field_fn(jm, p), params, jnp.asarray(ro),
            jnp.asarray(rd), near=0.5, far=4.0, n_samples=33, ndc=ndc)
    finally:
        jax.config.update("jax_enable_x64", False)
    got = teval.render_test_ray(t_make_field_fn(tm), torch.from_numpy(ro),
                                torch.from_numpy(rd), near=0.5, far=4.0,
                                n_samples=33, ndc=ndc)
    assert set(got) == set(ref)
    for k in PROFILE_KEYS:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=1e-9,
                                   err_msg=k)
    assert got["z_vals"].shape == (33,) and got["rgb"].shape == (3,)
    lo, hi = (0.0, 1.0) if ndc else (0.5, 4.0)
    assert got["z_vals"][0] == lo and got["z_vals"][-1] == hi
    assert (got["sigma"] >= 0).all()


def _cp_setup():
    cfg = Config(field=FieldConfig(cp_resolutions=(5, 9, 17), cp_rank=4,
                                   cp_bound=3.0),
                 render=RenderConfig(N_samples=16, N_importance=16))
    state, jc, jf = create_train_state(cfg, jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, state.params)
    tc, tf = create_params(cfg, torch.Generator().manual_seed(0))
    convert.load_jax_params(tc, params["coarse"])
    convert.load_jax_params(tf, params["fine"])
    return cfg, state.params, jc, jf, tc, tf


@pytest.mark.parametrize("ndc", [None, (24, 32, 30.0)])
def test_render_test_ray_cp_matches_jax(rng, ndc):
    """On converted CP fields (the fine field, as render_only calls it),
    64 samples: σ at the field tolerance, the depth to 2e-2."""
    _, jparams, _, jf, _, tf = _cp_setup()
    ro, rd = _forward_ray(rng, np.float32)
    ref = jeval.render_test_ray(
        lambda p: j_make_field_fn(jf, p["fine"]), jparams, jnp.asarray(ro),
        jnp.asarray(rd), near=0.5, far=2.5, n_samples=64, ndc=ndc)
    got = teval.render_test_ray(t_make_field_fn(tf), torch.from_numpy(ro),
                                torch.from_numpy(rd), near=0.5, far=2.5,
                                n_samples=64, ndc=ndc)
    np.testing.assert_allclose(got["z_vals"], ref["z_vals"], rtol=1e-6,
                               atol=1e-7)
    atol = 5e-3 * max(float(np.abs(ref["sigma"]).max()), 1e-3)
    np.testing.assert_allclose(got["sigma"], ref["sigma"], rtol=3e-2,
                               atol=atol)
    assert (ref["sigma"] > 0).any()
    assert abs(got["depth"] - ref["depth"]) <= 2e-2
    np.testing.assert_allclose(got["rgb"], ref["rgb"], rtol=0, atol=5e-3)


def _poses(n):
    """A camera arc around the origin, looking at it (OpenGL, −z forward)."""
    out = []
    for th in np.linspace(0.0, 0.6, n):
        eye = np.array([2.0 * np.sin(th), 0.3, 2.0 * np.cos(th)])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(fwd, [0.0, 1.0, 0.0])
        right /= np.linalg.norm(right)
        up = np.cross(right, fwd)
        out.append(np.stack([right, up, -fwd, eye], 1))
    return np.stack(out).astype(np.float32)


def test_render_path_projection_and_convert_pose_match_jax():
    cfg, jparams, jc, jf, tc, tf = _cp_setup()
    poses = _poses(2)
    hwf = (12, 10, 11.0)
    jz, jw, jc2w, jK = jeval.render_path_projection(
        jstep.make_render_fn(cfg, jc, jf, 0.5, 4.5), jparams, poses, hwf,
        render_factor=2)
    tz, tw, tc2w, tK = teval.render_path_projection(
        tstep.make_render_fn(cfg, tc, tf, 0.5, 4.5), poses, hwf,
        render_factor=2, device="cpu")
    np.testing.assert_array_equal(tK, jK)
    assert tK[0, 2] == 2.5 and tK[0, 0] == 5.5
    for g, r in zip(tc2w, jc2w):
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-7)
    for g, r in zip(tz, jz):
        assert g.shape == r.shape == (30, 32)
        np.testing.assert_allclose(g, r, rtol=0, atol=2e-2)
    for g, r in zip(tw, jw):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.sum(-1), r.sum(-1), rtol=0, atol=5e-3)
    p = np.eye(4)
    p[:3, :4] = poses[0]
    np.testing.assert_array_equal(teval.convert_pose(p),
                                  jeval.convert_pose(p))
    np.testing.assert_array_equal(np.diag(teval.convert_pose(np.eye(4))),
                                  [1, -1, -1, 1])


def test_gif_round_trip_through_imageio_and_pillow(rng, tmp_path):
    """A grey ramp comes back exactly and an RGB frame within half a
    palette step; the frame count, the loop and the delays are written."""
    import imageio.v2 as imageio
    from PIL import Image, ImageSequence

    grey = np.stack([np.tile(np.arange(256, dtype=np.uint8), (7, 1))
                     + 0 * k for k in range(3)])
    grey[1] = grey[1][:, ::-1]
    path = write_gif(str(tmp_path / "g.gif"), grey, fps=10)
    got = np.stack([np.asarray(f) for f in imageio.mimread(path)])
    assert got.shape[0] == 3
    np.testing.assert_array_equal(got.reshape(3, 7, 256, -1)[..., 0], grey)
    im = Image.open(path)
    assert im.n_frames == 3 and im.info["loop"] == 0
    durations = [f.info["duration"] for f in ImageSequence.Iterator(im)]
    assert durations == [100, 100, 100]

    rgb = (rng.random((4, 13, 17, 3)) * 255).astype(np.uint8)
    path = write_gif(str(tmp_path / "c.gif"), rgb, fps=25)
    got = np.stack([np.asarray(f.convert("RGB"))
                    for f in ImageSequence.Iterator(Image.open(path))])
    assert got.shape == rgb.shape
    step = 255.0 / (np.array([6, 7, 6]) - 1)
    assert (np.abs(got.astype(float) - rgb) <= step / 2 + 0.5).all()
    assert [f.info["duration"] for f in ImageSequence.Iterator(
        Image.open(path))] == [40] * 4
    # the port's reader on its own files and on Pillow's LZW-coded files
    frames, delays = read_gif(path)
    np.testing.assert_array_equal(frames, got)
    assert delays == [40] * 4
    frames, _ = read_gif(str(tmp_path / "g.gif"))
    np.testing.assert_array_equal(frames[..., 1], grey)
    smooth = np.stack([np.tile(np.linspace(0, 255, 64).astype(np.uint8)
                               [None, :, None], (48, 1, 3))] * 3)
    smooth[1] //= 2
    pil = [Image.fromarray(x) for x in list(smooth) + list(rgb[:, :12, :16])]
    pil = [p.resize((64, 48)) for p in pil]
    pil[0].save(tmp_path / "p.gif", save_all=True, append_images=pil[1:],
                duration=50, loop=0)
    ref = np.stack([np.asarray(f.convert("RGB")) for f in
                    ImageSequence.Iterator(Image.open(tmp_path / "p.gif"))])
    frames, delays = read_gif(str(tmp_path / "p.gif"))
    np.testing.assert_array_equal(frames, ref)
    assert delays == [50] * len(ref)
    with pytest.raises(TypeError):
        write_gif(str(tmp_path / "bad.gif"), rgb.astype(np.float32))


def test_save_video_writes_a_gif(tmp_path):
    frames = np.linspace(0, 1, 2 * 5 * 6 * 3, dtype=np.float32).reshape(
        2, 5, 6, 3)
    path = teval.save_video(frames, str(tmp_path / "v" / "spiral_rgb.mp4"))
    assert path == str(tmp_path / "v" / "spiral_rgb.gif")
    got, delays = read_gif(path)
    assert got.shape == (2, 5, 6, 3) and delays == [30, 30]
    disp = teval.save_video(frames[..., 0], str(tmp_path / "d.gif"))
    np.testing.assert_array_equal(read_gif(disp)[0][..., 0],
                                  (255 * frames[..., 0]).astype(np.uint8))


def test_visualize_sigma_png(tmp_path):
    """The plot decodes, draws the σ curve and a red dashed vertical at
    the depth (in the column of the depth on the z axis)."""
    z = np.linspace(2.0, 6.0, 64)
    prof = {"z_vals": z, "sigma": 50 * np.exp(-(z - 4.0) ** 2 * 8),
            "depth": 4.5}
    path = str(tmp_path / "s" / "sigma.png")
    teval.visualize_sigma(prof, path)
    img = read_png(path)
    H, W = teval.SIGMA_CANVAS
    assert img.shape == (H, W, 3) and img.dtype == np.uint8
    curve = (img == teval.SIGMA_CURVE).all(-1)
    assert curve.sum() > 2 * 64
    # the curve's peak is at z = 4 (the plot's middle), high in the box
    rows, cols = np.nonzero(curve)
    top, right, bottom, left = teval.SIGMA_MARGINS
    x0, x1 = left, W - 1 - right
    peak_col = cols[rows == rows.min()].mean()
    assert abs(peak_col - (x0 + 1 + 0.5 * (x1 - x0 - 2))) <= 2
    red = (img == teval.SIGMA_DEPTH).all(-1)
    red_cols = np.unique(np.nonzero(red)[1])
    assert len(red_cols) == 1
    assert abs(red_cols[0] - (x0 + 1 + 0.625 * (x1 - x0 - 2))) <= 1
    n_red = red[:, red_cols[0]].sum()
    assert 0.4 * (H - top - bottom) <= n_red <= 0.6 * (H - top - bottom)


def _scene(n_train, H, W):
    """A sphere seen from an arc (the synthetic-scene twin's render), the
    middle view held out, the first two as the path."""
    from gbnerf_tpu_torch.data.llff import LLFFScene
    from gbnerf_tpu_torch.tools import make_synthetic_scene as syn

    focal = 1.2 * W
    imgs, poses = [], []
    for k in range(n_train + 1):
        th = (k / n_train - 0.5) * 0.8
        c2w = syn.look_at(np.array([2.5 * np.sin(th), 0.2,
                                    2.5 * np.cos(th)]))
        imgs.append(syn.render_scene(H, W, focal, c2w)[0])
        poses.append(np.concatenate(
            [c2w, np.array([[H], [W], [focal]], np.float32)], 1))
    imgs, poses = np.stack(imgs), np.stack(poses)
    test = n_train // 2
    train = [k for k in range(n_train + 1) if k != test]
    return LLFFScene(images=imgs[train],
                     masks=np.zeros((n_train, H, W), np.float32),
                     inpainted_depths=np.zeros((n_train, H, W), np.float32),
                     poses=poses[train], poses_test=poses[test:test + 1],
                     bds=np.array([[1.0, 4.0]], np.float32),
                     render_poses=poses[:2], hwf=(H, W, focal), near=1.0,
                     far=4.0, images_test=imgs[test:test + 1])


def _tiny_cfg(tmp_path, **train):
    from gbnerf_tpu_torch.config import (Config as TConfig, DataConfig,
                                         FieldConfig as TFieldConfig,
                                         RenderConfig as TRenderConfig,
                                         TrainConfig)

    kw = dict(N_rand=32, N_iters=4, lrate=5e-3, lrate_decay=250, i_print=2,
              i_weights=4, i_video=4, i_evaluate=100, i_testset=4,
              first_stage=True, basedir=str(tmp_path), expname="run",
              render_factor=0)
    kw.update(train)
    return TConfig(
        field=TFieldConfig(cp_resolutions=(5, 9, 17), cp_rank=4,
                           cp_bound=1.5),
        render=TRenderConfig(N_samples=8, N_importance=8, lindisp=False,
                             white_bkgd=True, render_block=512),
        data=DataConfig(colmap_depth=False), train=TrainConfig(**kw))


def test_train_and_render_only_write_the_artifact_set(tmp_path):
    """train() writes testset_{i}/rgb,disp PNGs and the spiral's rgb and
    disp GIFs; render_only with render_test_ray writes test/ PNGs,
    test_ray.npz, sigma.png, depth/disp/acc.npy and spiral_rgb.gif. Each
    decodes through the port's readers (and the GIF through imageio)."""
    import imageio.v2 as imageio

    scene = _scene(n_train=2, H=12, W=16)
    cfg = _tiny_cfg(tmp_path)
    tloop.train(cfg, scene=scene, device="cpu", log_fn=lambda i, m: None)
    exp = tmp_path / "run"
    n_test, n_path = len(scene.poses_test), len(scene.render_poses)
    for sub in ("rgb", "disp"):
        pngs = sorted((exp / "testset_4" / sub).glob("*.png"))
        assert len(pngs) == n_test
        assert read_png(str(pngs[0])).shape[:2] == (12, 16)
    for kind in ("rgb", "disp"):
        frames, delays = read_gif(str(exp / f"spiral_000004_{kind}.gif"))
        assert frames.shape == (n_path, 12, 16, 3) and len(delays) == n_path
    cfg = cfg.replace(train=dataclasses.replace(cfg.train,
                                                render_test_ray=True))
    out = tloop.render_only(cfg, scene=scene, device="cpu")
    rd = exp / "renderonly_000004"
    assert out["outdir"] == str(rd)
    assert len(list((rd / "test" / "rgb").glob("*.png"))) == n_test
    assert len(list((rd / "test" / "disp").glob("*.png"))) == n_test
    with np.load(rd / "test_ray.npz") as prof:
        assert set(prof.files) == set(PROFILE_KEYS)
        assert prof["z_vals"].shape == (cfg.render.N_samples,)
        assert np.isfinite(prof["sigma"]).all()
    assert read_png(str(rd / "sigma.png")).shape == teval.SIGMA_CANVAS + (3,)
    for k in ("depth", "disp", "acc"):
        a = np.load(rd / f"{k}.npy")
        assert a.shape == (n_path, 12, 16) and np.isfinite(a).all()
    frames, _ = read_gif(str(rd / "spiral_rgb.gif"))
    assert frames.shape == (n_path, 12, 16, 3)
    assert len(imageio.mimread(str(rd / "spiral_rgb.gif"))) == n_path
    # without test poses the ray is the first train pose's
    scene.poses_test = scene.poses_test[:0]
    tloop.render_only(cfg, scene=scene, device="cpu")
    assert (rd / "test_ray.npz").is_file()


def test_render_test_ray_hands_the_kernel_dense_operands(monkeypatch, rng):
    """One ray's 64 samples against one view direction: the SH rows are a
    broadcast over the samples, which the CUDA kernel (K1) reads as dense
    float4 rows. The operands CPGridField hands cp_field_fused pass the
    kernel's own argument check (here on the CPU, where the plain
    version then runs)."""
    from gbnerf_tpu_torch.core import cp_field
    from gbnerf_tpu_torch.ops import field_fused as ff

    calls = []

    def checked(x01, sh, ulines, Ws, *, sigma_only=False):
        ff.check_field_args(x01, sh, ulines, Ws, sigma_only=sigma_only)
        calls.append(x01.shape[0])
        return ff.cp_field_fused(x01, sh, ulines, Ws, sigma_only=sigma_only)

    monkeypatch.setattr(cp_field, "cp_field_fused", checked)
    _, _, _, _, _, tf = _cp_setup()
    ro, rd = _forward_ray(rng, np.float32)
    prof = teval.render_test_ray(t_make_field_fn(tf), torch.from_numpy(ro),
                                 torch.from_numpy(rd), near=0.5, far=2.5,
                                 n_samples=64)
    assert calls == [64] and np.isfinite(prof["sigma"]).all()


@pytest.mark.cuda
def test_render_test_ray_on_the_card_matches_the_cpu(rng):
    """render_test_ray's call on the card (K1 at one ray's 64 samples)
    against the same fields on the CPU (the plain version), at the field
    tolerance. chip_smoke.py makes this check at the full width."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K1 is CUDA C++; no CPU mode)")
    import copy

    _, _, _, _, _, tf = _cp_setup()
    ro, rd = _forward_ray(rng, np.float32)
    kw = dict(near=0.5, far=2.5, n_samples=64)
    ref = teval.render_test_ray(t_make_field_fn(tf), torch.from_numpy(ro),
                                torch.from_numpy(rd), **kw)
    dev = torch.device("cuda:0")
    got = teval.render_test_ray(
        t_make_field_fn(copy.deepcopy(tf).to(dev)),
        torch.from_numpy(ro).to(dev), torch.from_numpy(rd).to(dev), **kw)
    atol = 5e-3 * max(float(np.abs(ref["sigma"]).max()), 1e-3)
    np.testing.assert_allclose(got["sigma"], ref["sigma"], rtol=3e-2,
                               atol=atol)
    assert abs(got["depth"] - ref["depth"]) <= 2e-2
