"""Port vs JAX: compositing, the coarse/fine render and the eval path.

- ``render_rays`` with ``NeRFMLP`` in float64 on both sides, at rtol 1e-6:
  the hierarchical pipeline is chaotic where the CDF is flat (an ulp of
  difference in a field moves fine samples by ~1e-2), so a tight check of
  the glue needs the framework noise floor pushed down by float64
  (cf. tests/test_golden_reference.py:909-912).
- The eval slice (``make_render_fn(train=False)`` → ``make_image_renderer``
  → ``render_pose_path``) on small CP fields with converted params, at a
  bf16 tolerance: both sides round every field matmul operand to bf16 but
  sum in another order, which can flip one rounding of a hidden
  activation (≈ 4e-3 relative); the flip moves σ, and through the
  resampling the fine samples. Held: rgb and acc to 5e-3, depth and disp
  to 2e-2 (absolute), over maps whose values are O(1).
"""
import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gbnerf_tpu.config import Config, FieldConfig, RenderConfig
from gbnerf_tpu.core import render as jrender
from gbnerf_tpu.core.fields import NeRFMLP as JNeRFMLP
from gbnerf_tpu.core.fields import make_field_fn as j_make_field_fn
from gbnerf_tpu.train import eval as jeval
from gbnerf_tpu.train import step as jstep
from gbnerf_tpu.train.state import create_train_state
from gbnerf_tpu.utils import metrics as jmetrics
from gbnerf_tpu_torch import convert
from gbnerf_tpu_torch.core import render as trender
from gbnerf_tpu_torch.core.fields import NeRFMLP as TNeRFMLP
from gbnerf_tpu_torch.core.fields import make_field_fn as t_make_field_fn
from gbnerf_tpu_torch.train import eval as teval
from gbnerf_tpu_torch.train import step as tstep
from gbnerf_tpu_torch.train.state import create_params
from gbnerf_tpu_torch.utils import metrics as tmetrics

torch.set_num_threads(1)

MAP_ATOL = {"rgb": 5e-3, "acc": 5e-3, "depth": 2e-2, "disp": 2e-2}


@pytest.mark.parametrize("white_bkgd", [False, True])
def test_raw2outputs_matches_jax(rng, white_bkgd):
    raw = rng.standard_normal((20, 33, 4)).astype(np.float32) * 2
    z = np.sort(rng.uniform(0.5, 4.0, (20, 33)).astype(np.float32), -1)
    d = rng.standard_normal((20, 3)).astype(np.float32)
    key = jax.random.PRNGKey(2)
    ref = jrender.raw2outputs(jnp.asarray(raw), jnp.asarray(z),
                              jnp.asarray(d), raw_noise_std=0.5, rng=key,
                              white_bkgd=white_bkgd)
    # the JAX σ-noise draw, injected into the port
    noise = np.array(jax.random.normal(key, (20, 33), jnp.float32))
    got = trender.raw2outputs(torch.from_numpy(raw), torch.from_numpy(z),
                              torch.from_numpy(d), raw_noise_std=0.5,
                              noise=torch.from_numpy(noise),
                              white_bkgd=white_bkgd)
    for name, g, r in zip(("rgb", "disp", "acc", "weights", "depth",
                           "alpha"), got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-5,
                                   atol=2e-6, err_msg=name)


def _mlp_pair(seed, kw):
    jm = JNeRFMLP(compute_dtype=jnp.float64, **kw)
    pts = jnp.zeros((2, 3))
    params = jm.init(jax.random.PRNGKey(seed), pts, pts)["params"]
    params = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64),
                                    params)
    tm = TNeRFMLP(compute_dtype=torch.float64, **kw).double()
    convert.load_jax_params(tm, params)
    return jm, params, tm


MLP_KW = dict(depth=3, width=32, skips=(1,), multires=4, multires_views=2)


def _rays64(rng, n):
    rays_o = rng.standard_normal((n, 3))
    rays_d = rng.standard_normal((n, 3)) * rng.uniform(0.5, 1.5, (n, 1))
    viewdirs = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    near = rng.uniform(0.3, 0.8, (n, 1))
    far = rng.uniform(3.0, 5.0, (n, 1))
    return rays_o, rays_d, viewdirs, near, far


@pytest.mark.parametrize("lindisp", [False, True])
@pytest.mark.parametrize("fast_resample", [True, False])
def test_render_rays_f64_matches_jax(rng, lindisp, fast_resample):
    rays = _rays64(rng, 24)
    jax.config.update("jax_enable_x64", True)
    try:
        jc, pc, tc = _mlp_pair(0, MLP_KW)
        jf, pf, tf = _mlp_pair(1, MLP_KW)
        ref = jrender.render_rays(
            j_make_field_fn(jc, pc), j_make_field_fn(jf, pf),
            *(jnp.asarray(a) for a in rays), N_samples=17, N_importance=9,
            lindisp=lindisp, fast_resample=fast_resample)
        ref = jax.tree_util.tree_map(np.asarray, ref)
    finally:
        jax.config.update("jax_enable_x64", False)
    with torch.no_grad():
        got = trender.render_rays(
            t_make_field_fn(tc), t_make_field_fn(tf),
            *(torch.from_numpy(a) for a in rays), N_samples=17,
            N_importance=9, lindisp=lindisp, fast_resample=fast_resample)
    for name in ("rgb", "disp", "acc", "depth", "weights", "z_vals", "alpha",
                 "rgb0", "disp0", "acc0", "depth0", "z_std"):
        g, r = getattr(got, name), getattr(ref, name)
        assert g.dtype == torch.float64, name
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-6, atol=1e-9,
                                   err_msg=name)


def test_make_render_fn_ndc_f64_matches_jax(rng):
    """The NDC branch: world-space viewdirs, rays through ndc_rays, marched
    over [0, 1]."""
    cfg = Config(render=RenderConfig(N_samples=16, N_importance=8,
                                     no_ndc=False, white_bkgd=True))
    hwf = (24, 32, 30.0)
    ro = rng.standard_normal((20, 3)) * 0.2
    rd = rng.standard_normal((20, 3))
    rd[:, 2] = -np.abs(rd[:, 2]) - 0.5
    jax.config.update("jax_enable_x64", True)
    try:
        jc, pc, tc = _mlp_pair(2, MLP_KW)
        jf, pf, tf = _mlp_pair(3, MLP_KW)
        jr = jstep.make_render_fn(cfg, jc, jf, 2.0, 6.0, hwf=hwf)
        ref = jr({"coarse": pc, "fine": pf}, jnp.asarray(ro),
                 jnp.asarray(rd), None, train=False)
        ref = jax.tree_util.tree_map(np.asarray, ref)
    finally:
        jax.config.update("jax_enable_x64", False)
    tr = tstep.make_render_fn(cfg, tc, tf, 2.0, 6.0, hwf=hwf)
    with torch.no_grad():
        got = tr(torch.from_numpy(ro), torch.from_numpy(rd), train=False)
    for name in ("rgb", "disp", "acc", "depth", "z_vals"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   getattr(ref, name), rtol=1e-6, atol=1e-9,
                                   err_msg=name)
    with pytest.raises(ValueError):
        tstep.make_render_fn(cfg, tc, tf, 2.0, 6.0)


def _cp_cfg(**render):
    return Config(
        field=FieldConfig(cp_resolutions=(5, 9, 17), cp_rank=4, cp_bound=3.0),
        render=RenderConfig(N_samples=64, N_importance=64, lindisp=True,
                            white_bkgd=True, **render))


def _cp_setup(cfg):
    state, jc, jf = create_train_state(cfg, jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, state.params)
    tc, tf = create_params(cfg, torch.Generator().manual_seed(0))
    convert.load_jax_params(tc, params["coarse"])
    convert.load_jax_params(tf, params["fine"])
    return state.params, jc, jf, tc, tf


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


def _check_maps(got, ref):
    for k, atol in MAP_ATOL.items():
        g, r = np.asarray(got[k]), np.asarray(ref[k])
        assert g.shape == r.shape, k
        assert np.isfinite(g).all(), k
        np.testing.assert_allclose(g, r, rtol=0, atol=atol, err_msg=k)


def test_eval_slice_cp_matches_jax(rng):
    """make_render_fn(train=False) + make_image_renderer on CP fields."""
    cfg = _cp_cfg()
    jparams, jc, jf, tc, tf = _cp_setup(cfg)
    pose = _poses(1)[0]
    jro, jrd = jstep._full_view_rays(9, 13, 11.0, jnp.asarray(pose))
    ref = jstep.make_image_renderer(
        jstep.make_render_fn(cfg, jc, jf, 0.5, 4.5), block=50)(
            jparams, jro, jrd)
    tro, trd = tstep._full_view_rays(9, 13, 11.0, torch.from_numpy(pose))
    got = tstep.make_image_renderer(
        tstep.make_render_fn(cfg, tc, tf, 0.5, 4.5), block=50)(tro, trd)
    assert got["rgb"].shape == (9, 13, 3) and got["acc"].shape == (9, 13)
    _check_maps({k: v.numpy() for k, v in got.items()}, ref)


def test_render_pose_path_matches_jax_and_saves_npy(tmp_path):
    cfg = _cp_cfg()
    jparams, jc, jf, tc, tf = _cp_setup(cfg)
    poses = _poses(2)
    hwf = (16, 12, 14.0)
    ref = jeval.render_pose_path(jstep.make_render_fn(cfg, jc, jf, 0.5, 4.5),
                                 jparams, poses, hwf, render_factor=2,
                                 block=64)
    got = teval.render_pose_path(tstep.make_render_fn(cfg, tc, tf, 0.5, 4.5),
                                 poses, hwf, render_factor=2, block=64,
                                 device="cpu")
    assert got["rgb"].shape == (2, 8, 6, 3)
    _check_maps(got, ref)
    paths = teval.save_maps(got, str(tmp_path / "maps"))
    for k, p in paths.items():
        assert os.path.basename(p) == f"{k}.npy"
        np.testing.assert_array_equal(np.load(p), got[k])


def test_render_rays_blocked_equals_one_block(rng):
    cfg = _cp_cfg()
    _, _, _, tc, tf = _cp_setup(cfg)
    render = tstep.make_render_fn(cfg, tc, tf, 0.5, 4.5)
    rays = {"o": torch.from_numpy(rng.standard_normal((70, 3)).astype(
                np.float32) * 0.1),
            "d": torch.from_numpy(rng.standard_normal((70, 3)).astype(
                np.float32))}

    def block_fn(r):
        out = render(r["o"], r["d"], train=False)
        return {"rgb": out.rgb, "depth": out.depth}

    with torch.no_grad():
        whole = block_fn(rays)
        blocked = trender.render_rays_blocked(block_fn, rays, block_size=32)
    for k in whole:
        assert blocked[k].shape == whole[k].shape
        np.testing.assert_allclose(blocked[k].numpy(), whole[k].numpy(),
                                   rtol=1e-6, atol=1e-6)


def test_train_mode_render_draws_from_the_generator(rng):
    """train=True jitters, adds σ noise and draws the fine-sample uniforms
    from the injected generator: the same seed gives the same render."""
    cfg = _cp_cfg(perturb=1.0, raw_noise_std=1.0)
    cfg = cfg.replace(render=dataclasses.replace(cfg.render, N_samples=16,
                                                 N_importance=16))
    _, _, _, tc, tf = _cp_setup(cfg)
    render = tstep.make_render_fn(cfg, tc, tf, 0.5, 4.5)
    ro = torch.zeros(10, 3)
    rd = torch.from_numpy(rng.standard_normal((10, 3)).astype(np.float32))
    with torch.no_grad():
        a = render(ro, rd, torch.Generator().manual_seed(5), train=True)
        b = render(ro, rd, torch.Generator().manual_seed(5), train=True)
        c = render(ro, rd, torch.Generator().manual_seed(6), train=True)
    assert torch.equal(a.rgb, b.rgb) and torch.equal(a.z_vals, b.z_vals)
    assert not torch.equal(a.z_vals, c.z_vals)
    assert bool((a.z_vals[:, 1:] >= a.z_vals[:, :-1]).all())


def test_metrics_match_jax(rng):
    mse = rng.uniform(1e-4, 1e-1, (7,)).astype(np.float32)
    np.testing.assert_allclose(
        tmetrics.mse2psnr(torch.from_numpy(mse)).numpy(),
        np.asarray(jmetrics.mse2psnr(jnp.asarray(mse))), rtol=1e-6)
    x = rng.uniform(-0.5, 1.5, (4, 5, 3)).astype(np.float32)
    np.testing.assert_array_equal(tmetrics.to8b(x), jmetrics.to8b(x))
