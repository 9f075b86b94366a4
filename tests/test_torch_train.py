"""Port vs JAX: stage-1 training — losses, LR schedule and Adam, the
assembled loss and its gradients, the train-state converter, checkpoints,
the loop and the CLI.

Tolerances, with their reasons:
- the f64 ``NeRFMLP`` runs (σ loss, the assembled stage-1 loss and its
  gradients): rtol 1e-6, as tests/test_golden_reference.py:1334-1407 — the
  render pipeline is chaotic where the CDF is flat, and f64 pushes the
  framework noise below it. The field's output is f32 in both packages
  (flax's NeRFMLP returns f32 even in an x64 run), so every gradient
  carries the f32 rounding of raw's cotangent, which entries that cancel
  to ≈ 0 amplify: they get an atol of 1e-6 · max |leaf|;
- Adam against optax at f64: rtol 1e-12 (the same formula);
- the small CP field: the bf16 tolerances of tests/test_field_bwd.py
  (rtol 3e-2, atol 5e-3 · max) on the gradients, and rtol 1e-3 on the loss
  terms: both sides round every field matmul operand to bf16 and sum in
  another order, which can flip one rounding of a hidden activation.
"""
import dataclasses
import importlib.util
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from gbnerf_tpu.config import (Config, DataConfig, FieldConfig, RenderConfig,
                               TrainConfig)
from gbnerf_tpu.core.fields import NeRFMLP as JNeRFMLP
from gbnerf_tpu.core.fields import make_field_fn as j_make_field_fn
from gbnerf_tpu.data.llff import LLFFScene
from gbnerf_tpu.train import losses as jlosses
from gbnerf_tpu.train import state as jstate
from gbnerf_tpu.train import step as jstep
from gbnerf_tpu_torch import convert
from gbnerf_tpu_torch import run as trun
from gbnerf_tpu_torch.core.fields import NeRFMLP as TNeRFMLP
from gbnerf_tpu_torch.core.fields import make_field_fn as t_make_field_fn
from gbnerf_tpu_torch.train import loop as tloop
from gbnerf_tpu_torch.train import losses as tlosses
from gbnerf_tpu_torch.train import state as tstate
from gbnerf_tpu_torch.train import step as tstep
from gbnerf_tpu_torch.train.checkpoint import CheckpointManager
from gbnerf_tpu_torch.train import eval as teval
from gbnerf_tpu_torch.utils.metrics import to8b
from gbnerf_tpu_torch.utils.gif import read_gif
from gbnerf_tpu_torch.utils.png import read_png

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


class x64:
    """JAX float64 for the duration of a with-block."""

    def __enter__(self):
        jax.config.update("jax_enable_x64", True)

    def __exit__(self, *exc):
        jax.config.update("jax_enable_x64", False)


MLP_KW = dict(depth=2, width=32, skips=(1,), multires=4, multires_views=2)


def _mlp_pair(seed):
    jm = JNeRFMLP(compute_dtype=jnp.float64, **MLP_KW)
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((2, 3)),
                     jnp.zeros((2, 3)))["params"]
    params = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64),
                                    params)
    tm = TNeRFMLP(compute_dtype=torch.float64, **MLP_KW).double()
    convert.load_jax_params(tm, params)
    return jm, params, tm


def _cp_cfg(**train):
    return Config(
        field=FieldConfig(cp_resolutions=(5, 9, 17), cp_rank=4, cp_bound=3.0),
        render=RenderConfig(N_samples=16, N_importance=16, lindisp=True,
                            white_bkgd=True, perturb=0.0, raw_noise_std=0.0),
        data=DataConfig(depth_lambda=0.1, sdepth_lambda=0.1),
        train=TrainConfig(sigma_loss_weight=0.05, tv_loss_weight=1e-3,
                          first_stage=True, **train))


def _cp_setup(cfg, seed=0):
    """The port's fields, and the same weights as the JAX package's params
    and a fresh optax state (no flax init: it runs eagerly and is slow)."""
    st, tc, tf = tstate.create_train_state(cfg, torch.Generator().manual_seed(
        seed))
    params = convert.params_to_jax({"coarse": tc.state_dict(),
                                    "fine": tf.state_dict()})
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jst = jstate.TrainState(jnp.zeros((), jnp.int32), jparams,
                            jstate.make_optimizer(cfg).init(jparams))
    jc = jstate.build_field(cfg, fine=False)
    jf = jstate.build_field(cfg, fine=True)
    return jst, jc, jf, params, st, tc, tf


def _grads_to_jax(modules):
    return convert.params_to_jax({
        name: {k: (p.grad if p.grad is not None else torch.zeros_like(p))
               for k, p in m.named_parameters()}
        for name, m in modules.items()})


def _tree_close(got, ref, rtol, atol_frac):
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    flat_r = dict(jax.tree_util.tree_leaves_with_path(ref))
    assert len(flat_g) == len(flat_r)
    for path, g in flat_g:
        r = np.asarray(flat_r[path])
        atol = atol_frac * max(np.abs(r).max(), 1e-30)
        np.testing.assert_allclose(np.asarray(g), r, rtol=rtol, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


def test_cp_tv_loss_and_grad_match_jax():
    cfg = _cp_cfg()
    _, _, _, params, _, tc, tf = _cp_setup(cfg)
    ref, jg = jax.jit(jax.value_and_grad(jlosses.cp_tv_loss))(params)
    got = tlosses.cp_tv_loss([tc, tf])
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)
    got_g = _grads_to_jax({"coarse": tc, "fine": tf})
    for name in ("coarse", "fine"):
        for key in ("lines_0", "lines_1", "lines_2"):
            np.testing.assert_allclose(got_g[name][key], jg[name][key],
                                       rtol=1e-5, atol=1e-12)
        assert float(np.abs(got_g[name]["ws0"]).max()) == 0.0


def _rays64(rng, n):
    ro = rng.standard_normal((n, 3)) * 0.3
    rd = rng.standard_normal((n, 3)) * rng.uniform(0.5, 1.5, (n, 1))
    return ro, rd, rd / np.linalg.norm(rd, axis=-1, keepdims=True)


def test_sigma_loss_matches_jax_with_injected_draws(rng):
    """The JAX draws (jitter uniforms, σ noise) injected into the port."""
    ro, rd, vd = _rays64(rng, 12)
    depths = rng.uniform(1.5, 3.5, 12)
    key = jax.random.PRNGKey(4)
    with x64():
        jm, params, tm = _mlp_pair(0)
        ref = jax.jit(lambda p, o, d, v, z: jlosses.sigma_loss(
            j_make_field_fn(jm, p), o, d, v, 0.5, z, N_samples=9,
            perturb=True, raw_noise_std=0.5, rng=key))(
            params, *(jnp.asarray(a) for a in (ro, rd, vd, depths)))
        k1, k2 = jax.random.split(key)
        u = np.array(jax.random.uniform(k1, (12, 9), jnp.float64))
        noise = np.array(jax.random.normal(k2, (12, 9), jnp.float32))
    t = torch.from_numpy
    got = tlosses.sigma_loss(t_make_field_fn(tm), t(ro), t(rd), t(vd), 0.5,
                             t(depths), N_samples=9, perturb=True,
                             raw_noise_std=0.5, u=t(u), noise=t(noise))
    assert got.shape == (12,)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-6)


def test_sigma_loss_stays_finite_where_jax_overflows():
    """σ ≳ 88 overflows exp in f32: the JAX form gives NaN, the port's
    shifted form the limit of the same expression."""
    sig = np.array([[0.0, 1.0, 95.0], [0.0, 2.0, 3.0]], np.float32)

    def jfield(pts, vd):
        return jnp.concatenate([jnp.zeros(pts.shape[:-1] + (3,)),
                                jnp.asarray(sig)[..., None]], -1)

    def tfield(pts, vd):
        return torch.cat([torch.zeros(pts.shape[:-1] + (3,)),
                          torch.from_numpy(sig)[..., None]], -1)

    ro, rd = np.zeros((2, 3), np.float32), np.ones((2, 3), np.float32)
    depths = np.array([2.0, 3.0], np.float32)
    ref = np.asarray(jlosses.sigma_loss(jfield, ro, rd, rd, 0.5, depths,
                                        N_samples=3, perturb=False))
    t = torch.from_numpy
    got = tlosses.sigma_loss(tfield, t(ro), t(rd), t(rd), 0.5, t(depths),
                             N_samples=3, perturb=False).numpy()
    assert np.isnan(ref[0]) and np.isfinite(got).all()
    np.testing.assert_allclose(got[0], -1.0, rtol=1e-6)
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-6)


def test_lr_schedule_matches_jax():
    cfg = _cp_cfg(lrate=3e-3, lrate_decay=10)
    got, ref = tstate.lr_schedule(cfg), jstate.lr_schedule(cfg)
    for s in (0, 1, 999, 10000, 25000):
        np.testing.assert_allclose(got(s), float(ref(s)), rtol=1e-12)


def test_adam_three_steps_match_optax_f64(rng):
    """optax takes the schedule at the count before it increments and the
    bias correction at count + 1; adam_step does the same. A fast decay
    makes each step's learning rate differ by 10x."""
    cfg = _cp_cfg(lrate=1e-2, lrate_decay=0.001)
    p0 = {"a": rng.standard_normal((4, 3)), "b": rng.standard_normal(5)}
    grads = [{k: rng.standard_normal(v.shape) for k, v in p0.items()}
             for _ in range(3)]
    with x64():
        tx = jstate.make_optimizer(cfg)
        jp = {k: jnp.asarray(v) for k, v in p0.items()}
        opt = tx.init(jp)
        ref = []
        for g in grads:
            upd, opt = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                 opt, jp)
            jp = optax.apply_updates(jp, upd)
            ref.append({k: np.asarray(v) for k, v in jp.items()})
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in p0.items()}
    state = tstate.TrainState(0, torch.nn.Module(), None,
                              tstate.make_optimizer(cfg, tp.values()))
    schedule = tstate.lr_schedule(cfg)
    for g, r in zip(grads, ref):
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        tstate.adam_step(state, schedule)
        for k in tp:
            np.testing.assert_allclose(tp[k].detach().numpy(), r[k],
                                       rtol=1e-12, atol=1e-15)
    assert state.step == 3


def _batches64(rng, n=20):
    out = {}
    for name, width in (("clf", 3), ("inp", 1), ("depth", 2)):
        ro, rd, _ = _rays64(rng, n)
        tgt = rng.random((n, width))
        if name == "depth":
            tgt[:, 0] = rng.uniform(1.5, 3.5, n)
        out[name] = {"o": ro, "d": rd, "target": tgt}
    return out


def test_stage1_loss_and_grads_match_jax_f64_mlp(rng):
    """loss_fn and its gradient against jax.value_and_grad(step.loss_fn),
    with every term on (rgb, rgb0, inpainted disparity, COLMAP weighted
    depth, σ likelihood), perturb 0 and raw_noise_std 0."""
    cfg = Config(
        field=FieldConfig(no_tcnn=True),
        render=RenderConfig(N_samples=9, N_importance=5, perturb=0.0,
                            raw_noise_std=0.0, lindisp=False,
                            white_bkgd=True),
        data=DataConfig(depth_lambda=0.1, sdepth_lambda=0.05),
        train=TrainConfig(sigma_loss_weight=0.2, first_stage=True))
    batches = _batches64(rng)
    with x64():
        jc, pc, tc = _mlp_pair(1)
        jf, pf, tf = _mlp_pair(2)
        jsf = jstep.make_train_step_stage1(cfg, jc, jf, 0.5, 4.0)
        jb = jax.tree_util.tree_map(jnp.asarray, batches)
        (ref, jm), jg = jax.jit(jax.value_and_grad(jsf.loss_fn,
                                                   has_aux=True))(
            {"coarse": pc, "fine": pf}, jb, jax.random.PRNGKey(0))
        jg = jax.tree_util.tree_map(np.asarray, jg)
    tb = {k: {kk: torch.from_numpy(vv) for kk, vv in v.items()}
          for k, v in batches.items()}
    loss, m = tstep.make_train_step_stage1(cfg, tc, tf, 0.5, 4.0).loss_fn(tb)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(ref), rtol=1e-6)
    for k in ("img_loss", "depth_loss", "col_loss", "sigma_loss", "psnr"):
        assert float(jm[k]) != 0.0, k
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-6,
                                   err_msg=k)
    _tree_close(_grads_to_jax({"coarse": tc, "fine": tf}), jg, rtol=1e-6,
                atol_frac=1e-6)


def test_stage1_loss_and_grads_match_jax_cp_bf16(rng):
    """The same on small CP fields (bf16 tolerances, see the docstring)."""
    cfg = _cp_cfg()
    jst, jc, jf, params, st, tc, tf = _cp_setup(cfg)
    b = _batches64(rng, 24)
    batches = {k: {kk: vv.astype(np.float32) for kk, vv in v.items()}
               for k, v in b.items()}
    jsf = jstep.make_train_step_stage1(cfg, jc, jf, 0.5, 4.0)
    (ref, jm), jg = jax.jit(jax.value_and_grad(jsf.loss_fn, has_aux=True))(
        jst.params, jax.tree_util.tree_map(jnp.asarray, batches),
        jax.random.PRNGKey(0))
    tb = {k: {kk: torch.from_numpy(vv) for kk, vv in v.items()}
          for k, v in batches.items()}
    loss, m = tstep.make_train_step_stage1(cfg, tc, tf, 0.5, 4.0).loss_fn(tb)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(ref), rtol=1e-3)
    for k in ("img_loss", "depth_loss", "col_loss", "sigma_loss"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-3,
                                   err_msg=k)
    _tree_close(_grads_to_jax({"coarse": tc, "fine": tf}),
                jax.tree_util.tree_map(np.asarray, jg), rtol=3e-2,
                atol_frac=5e-3)


def test_train_step_updates_the_state_in_place():
    cfg = _cp_cfg(N_rand=16)
    st, tc, tf = tstate.create_train_state(cfg, torch.Generator().manual_seed(
        0))
    g = torch.Generator().manual_seed(0)
    banks = {"rgb_clf": {"o": torch.zeros(50, 3), "d": torch.randn(50, 3, generator=g),
                         "target": torch.rand(50, 3, generator=g)},
             "inp": {"o": torch.zeros(50, 3), "d": torch.randn(50, 3, generator=g),
                     "target": torch.rand(50, 1, generator=g)},
             "depth": None}
    before = tc.ws0.detach().clone()
    step = tstep.make_train_step_stage1(cfg, tc, tf, 0.5, 4.0)
    st2, m = step(st, banks, g)
    assert st2 is st and st.step == 1
    assert not torch.equal(before, tc.ws0.detach())
    assert float(m["col_loss"]) == 0.0 and np.isfinite(float(m["loss"]))
    assert all(not v.requires_grad for v in m.values())


def _optax_steps(cfg, jst, rng, n):
    tx = jstate.make_optimizer(cfg)
    params, opt = jst.params, jst.opt_state
    grads = []
    for _ in range(n):
        g = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.standard_normal(p.shape), p.dtype),
            params)
        upd, opt = tx.update(g, opt, params)
        params = optax.apply_updates(params, upd)
        grads.append(g)
    return params, opt, grads


def test_train_state_from_jax_round_trip_and_continues(rng):
    """A JAX train state after two optax updates → the port, which then
    takes the third update as optax does; and back again unchanged."""
    cfg = _cp_cfg()
    jst = _cp_setup(cfg)[0]
    params, opt, grads = _optax_steps(cfg, jst, rng, 3)
    # replay the first two updates to get the state before the third
    tx = jstate.make_optimizer(cfg)
    p2, o2 = jst.params, jst.opt_state
    for g in grads[:2]:
        upd, o2 = tx.update(g, o2, p2)
        p2 = optax.apply_updates(p2, upd)
    host = jax.device_get((p2, o2))
    state = convert.train_state_from_jax(host[0], host[1], 2, cfg=cfg)
    assert state.step == 2
    back_p, back_o, back_step = convert.train_state_to_jax(state)
    assert int(back_step) == 2 and int(back_o[0]["count"]) == 2
    for got, ref in ((back_p, host[0]), (back_o[0]["mu"], host[1][0].mu),
                     (back_o[0]["nu"], host[1][0].nu)):
        _tree_close(got, jax.tree_util.tree_map(np.asarray, ref), rtol=0,
                    atol_frac=0)
    g3 = convert.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                        grads[2]))
    for name, module in (("coarse", state.coarse), ("fine", state.fine)):
        for key, p in module.named_parameters():
            p.grad = g3[name][key].clone()
    tstate.adam_step(state, tstate.lr_schedule(cfg))
    _tree_close(convert.train_state_to_jax(state)[0],
                jax.tree_util.tree_map(np.asarray, params), rtol=1e-5,
                atol_frac=1e-6)


def test_checkpoint_save_restore_and_max_to_keep(tmp_path):
    cfg = _cp_cfg()
    st, tc, _ = tstate.create_train_state(cfg, torch.Generator().manual_seed(
        0))
    for p in st.coarse.parameters():
        p.grad = torch.ones_like(p)
    for p in st.fine.parameters():
        p.grad = torch.ones_like(p)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    assert mgr.latest_step() is None
    for s in (1, 2, 3):
        tstate.adam_step(st, tstate.lr_schedule(cfg))
        mgr.save(s, st)
    assert mgr.steps() == [2, 3] and mgr.latest_step() == 3
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["2.pt", "3.pt"]
    fresh, fc, _ = tstate.create_train_state(
        cfg, torch.Generator().manual_seed(5))
    mgr.restore(fresh)
    assert fresh.step == 3
    for a, b in zip(fresh.coarse.state_dict().values(),
                    st.coarse.state_dict().values()):
        assert torch.equal(a, b)
    sa = fresh.optimizer.state_dict()["state"]
    sb = st.optimizer.state_dict()["state"]
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k]["exp_avg_sq"], sb[k]["exp_avg_sq"])
    mgr.restore(fresh, step=2)
    assert fresh.step == 2


def _load_synthetic_tool():
    spec = importlib.util.spec_from_file_location(
        "make_synthetic_scene", ROOT / "tools" / "make_synthetic_scene.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _scene(n_train=4, H=24, W=32):
    """An in-memory scene: a sphere seen from an arc (tools/
    make_synthetic_scene.py's render), one held-out view with ground
    truth."""
    syn = _load_synthetic_tool()
    focal = 1.2 * W
    imgs, poses, disps = [], [], []
    for k in range(n_train + 1):
        th = (k / n_train - 0.5) * 0.8
        c2w = syn.look_at(np.array([2.5 * np.sin(th), 0.2,
                                    2.5 * np.cos(th)]))
        img, depth, _ = syn.render_scene(H, W, focal, c2w)
        imgs.append(img.astype(np.float32))
        disps.append((1.0 / np.maximum(depth, 1e-3)).astype(np.float32))
        poses.append(np.concatenate(
            [c2w, np.array([[H], [W], [focal]], np.float32)], 1))
    imgs, poses, disps = np.stack(imgs), np.stack(poses), np.stack(disps)
    test = n_train // 2
    train = [k for k in range(n_train + 1) if k != test]
    masks = np.zeros((n_train, H, W), np.float32)
    masks[:, 8:12, 10:16] = 1.0
    return LLFFScene(images=imgs[train], masks=masks,
                     inpainted_depths=disps[train] / disps.max(),
                     poses=poses[train], poses_test=poses[test:test + 1],
                     bds=np.array([[1.0, 4.0]], np.float32),
                     render_poses=poses[:2], hwf=(H, W, focal), near=1.0,
                     far=4.0, images_test=imgs[test:test + 1])


def _loop_cfg(tmp_path, **train):
    kw = dict(N_iters=40, N_rand=64, lrate=2e-2, i_print=10, i_weights=20,
              i_video=40, i_evaluate=40, i_testset=40, first_stage=True,
              basedir=str(tmp_path), expname="run", render_factor=0)
    kw.update(train)
    return Config(
        field=FieldConfig(cp_resolutions=(5, 9, 17), cp_rank=4,
                          cp_bound=1.5),
        render=RenderConfig(N_samples=16, N_importance=16, lindisp=False,
                            white_bkgd=False, perturb=1.0,
                            raw_noise_std=1.0, render_block=512),
        data=DataConfig(colmap_depth=False), train=TrainConfig(**kw))


def test_train_lowers_img_loss_checkpoints_evaluates_and_resumes(tmp_path):
    scene = _scene()
    cfg = _loop_cfg(tmp_path)
    out = tloop.train(cfg, scene=scene, device="cpu",
                      log_fn=lambda i, m: None)
    hist = [m["img_loss"] for _, m in out["history"]]
    assert len(hist) == 4 and all(np.isfinite(hist))
    assert hist[-1] < hist[0], hist
    assert out["state"].step == 40 and not out["preempted"]
    exp = tmp_path / "run"
    assert sorted(os.listdir(exp / "ckpt")) == ["20.pt", "40.pt"]
    lines = [json.loads(l) for l in open(exp / "metrics.jsonl")]
    assert [l["iter"] for l in lines] == [10, 20, 30, 40, 40]
    assert "eval_psnr" in lines[-1] and np.isfinite(lines[-1]["eval_psnr"])
    maps = {k: np.load(exp / "eval_images_40" / f"{k}.npy")
            for k in ("rgb", "disp", "depth", "acc")}
    assert maps["rgb"].shape[1:] == (24, 32, 3)
    assert all(np.isfinite(v).all() for v in maps.values())
    # the testset's PNGs and the spiral's GIFs, as the JAX loop writes them
    for sub in ("rgb", "disp"):
        assert read_png(str(exp / "testset_40" / sub / "000.png")).shape[:2] \
            == (24, 32)
    for kind in ("rgb", "disp"):
        frames, _ = read_gif(str(exp / f"spiral_000040_{kind}.gif"))
        assert frames.shape == (2, 24, 32, 3), kind
    # the eval's PNGs are to8b of its maps
    maps = {k: np.load(exp / "eval_images_40" / f"{k}.npy")
            for k in ("rgb", "disp")}
    np.testing.assert_array_equal(
        read_png(str(exp / "eval_images_40" / "rgb" / "000.png")),
        to8b(maps["rgb"][0]))
    assert read_png(str(exp / "eval_images_40" / "disp" / "000.png")
                    ).shape == (24, 32)
    # resume: the same config with more iterations continues at 40
    cfg2 = cfg.replace(train=dataclasses.replace(cfg.train, N_iters=50))
    out2 = tloop.train(cfg2, scene=scene, device="cpu",
                       log_fn=lambda i, m: None)
    assert out2["state"].step == 50
    assert [i for i, _ in out2["history"]] == [50]


def test_train_sigterm_saves_and_stops(tmp_path):
    """SIGTERM sets a flag; the loop stops at the next iteration and saves
    the state it reached."""
    scene = _scene(n_train=2, H=12, W=16)
    cfg = _loop_cfg(tmp_path, N_iters=30, i_print=5, i_weights=100,
                    i_video=100, i_evaluate=100, i_testset=100)

    def log_fn(i, m):
        handler = signal.getsignal(signal.SIGTERM)
        if i == 10 and callable(handler):
            handler(signal.SIGTERM, None)

    before = signal.getsignal(signal.SIGTERM)
    out = tloop.train(cfg, scene=scene, device="cpu", log_fn=log_fn)
    assert signal.getsignal(signal.SIGTERM) == before
    if callable(before) or before in (signal.SIG_DFL, signal.SIG_IGN):
        assert out["preempted"] and out["state"].step == 10
        assert CheckpointManager(str(tmp_path / "run" / "ckpt")
                                 ).latest_step() == 10


def test_train_ft_path_and_ema(tmp_path):
    """ft_path warm-starts from another run's checkpoint of a pinned step;
    ema_decay keeps a finite EMA of the params that lags them."""
    scene = _scene(n_train=2, H=12, W=16)
    quiet = dict(i_print=5, i_weights=5, i_video=100, i_evaluate=100,
                 i_testset=100)
    src = tloop.train(_loop_cfg(tmp_path, N_iters=10, **quiet), scene=scene,
                      device="cpu", log_fn=lambda i, m: None)
    ckpt = tmp_path / "run" / "ckpt"
    assert sorted(os.listdir(ckpt)) == ["10.pt", "5.pt"]
    cfg = _loop_cfg(tmp_path, N_iters=8, expname="warm", ema_decay=0.9,
                    ft_path=str(ckpt / "5"), **quiet)
    out = tloop.train(cfg, scene=scene, device="cpu",
                      log_fn=lambda i, m: None)
    assert out["state"].step == 8 and [i for i, _ in out["history"]] == []
    params = [p for f in out["state"].fields() for p in f.parameters()]
    ema = out["ema_params"]
    assert len(ema) == len(params)
    assert all(torch.isfinite(e).all() for e in ema)
    assert any(not torch.equal(e, p.detach()) for e, p in zip(ema, params))
    assert src["state"].step == 10


def test_train_nan_restarts_then_aborts(tmp_path):
    """A non-finite loss at an i_print step re-initialises (no checkpoint
    yet) and re-seeds; past nan_restarts the run stops, and no non-finite
    state is ever checkpointed."""
    scene = _scene(n_train=2, H=12, W=16)
    scene.images[:] = np.nan
    cfg = _loop_cfg(tmp_path, N_iters=10, i_print=2, i_weights=2,
                    i_video=100, i_evaluate=100, i_testset=100,
                    nan_restarts=1)
    with pytest.raises(SystemExit, match="non-finite"):
        tloop.train(cfg, scene=scene, device="cpu", log_fn=lambda i, m: None)
    assert os.listdir(tmp_path / "run" / "ckpt") == []


def test_unported_paths_raise(tmp_path):
    """Stage 2 trains now, with LPIPS (tests/test_torch_stage2.py), the
    frozen-σ field runs (tests/test_torch_frozen_sigma.py), every loader
    reads (tests/test_torch_blender.py), and a mesh builds the step
    (tests/test_torch_parallel.py runs it on N ranks); a mesh that is not
    a DeviceMesh is refused."""
    import torch.distributed as dist

    from gbnerf_tpu_torch.parallel.mesh import make_mesh

    cfg = _loop_cfg(tmp_path)
    st, tc, tf = tstate.create_train_state(cfg, torch.Generator())
    with pytest.raises(TypeError, match="DeviceMesh"):
        tstep.make_train_step_stage1(cfg, tc, tf, 1.0, 4.0, mesh=object())
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        assert callable(tstep.make_train_step_stage1(
            cfg, tc, tf, 1.0, 4.0, mesh=make_mesh()))
    finally:
        dist.destroy_process_group()
    assert callable(tstep.make_train_step_stage1(cfg, tc, tf, 1.0, 4.0,
                                                 alpha=tf))


def _run_cli(args, cwd):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, "-m", "gbnerf_tpu_torch.run",
                           *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def test_cli_trains_then_renders_only(tmp_path):
    scene = tmp_path / "scene"
    subprocess.run([sys.executable, str(ROOT / "tools" /
                                        "make_synthetic_scene.py"),
                    str(scene), "--colmap_sparse", "--n_sparse", "20",
                    "--n_train", "3", "--n_test", "1", "--H", "16",
                    "--W", "20"], check=True, capture_output=True,
                   timeout=120)
    cfg = tmp_path / "cfg.txt"
    cfg.write_text("\n".join([
        f"expname = cli", f"basedir = {tmp_path / 'logs'}",
        f"datadir = {scene}", "dataset_type = llff", "factor = 4",
        "cp_resolutions = 5,9,17", "cp_rank = 4", "cp_bound = 3.0",
        "N_rand = 32", "N_samples = 8", "N_importance = 8",
        "no_ndc = True", "white_bkgd = True", "first_stage = True",
        "N_iters = 6", "i_print = 3", "i_weights = 6", "i_video = 6",
        "i_evaluate = 6", "i_testset = 6", "render_factor = 1"]) + "\n")
    sets = ["--set", "data.test_split_count=1", "--device", "cpu"]
    r = _run_cli(["--config", str(cfg), *sets], tmp_path)
    assert r.returncode == 0, r.stderr
    assert "[6/6]" in r.stdout and "col_loss" in r.stdout
    exp = tmp_path / "logs" / "cli"
    assert (exp / "ckpt" / "6.pt").is_file()
    # the same entry point in this process: --render_only, a bad key
    assert trun.main(["--config", str(cfg), *sets, "--render_only"]) == 0
    rgb = read_png(str(exp / "renderonly_000006" / "test" / "rgb" /
                       "000.png"))
    assert rgb.shape == (16, 20, 3)
    depth = np.load(exp / "renderonly_000006" / "depth.npy")
    assert depth.shape[1:] == (16, 20) and np.isfinite(depth).all()
    assert read_gif(str(exp / "renderonly_000006" / "spiral_rgb.gif")
                    )[0].shape[1:] == (16, 20, 3)
    with pytest.raises(SystemExit, match="unknown config key"):
        trun.main(["--config", str(cfg), "--set", "train.nope=1"])


def _tool(args, cwd, module=None):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    cmd = ([sys.executable, "-m", module] if module else
           [sys.executable, str(ROOT / "tools" / "make_synthetic_scene.py")])
    return subprocess.run(cmd + args, cwd=cwd, env=env, check=True,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("family", ["spheres", "hard"])
def test_synthetic_scene_twin_writes_the_originals_scene(tmp_path, family):
    """gbnerf_tpu_torch.tools.make_synthetic_scene against
    tools/make_synthetic_scene.py with the same arguments: every image
    decodes to the same array (read by imageio, which the original wrote
    with), poses_bounds.npy is equal and the sparse/0 model reads back to
    the same records."""
    import imageio.v2 as imageio

    from gbnerf_tpu.data import colmap as jcolmap

    args = ["--task", "inpaint", "--colmap_sparse", "--n_sparse", "25",
            "--n_train", "3", "--n_test", "2", "--H", "20", "--W", "28",
            "--family", family, "--seed", "3"]
    _tool([str(tmp_path / "orig")] + args, ROOT)
    _tool([str(tmp_path / "twin")] + args, ROOT,
          "gbnerf_tpu_torch.tools.make_synthetic_scene")
    files = sorted(p.relative_to(tmp_path / "orig")
                   for p in (tmp_path / "orig").rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(tmp_path / "twin")
                           for p in (tmp_path / "twin").rglob("*")
                           if p.is_file())
    pngs = [f for f in files if f.suffix == ".png"]
    assert len(pngs) == 3 * 3 + 2 * 2
    for f in pngs:
        np.testing.assert_array_equal(
            imageio.imread(tmp_path / "twin" / f),
            imageio.imread(tmp_path / "orig" / f), err_msg=str(f))
    np.testing.assert_array_equal(
        np.load(tmp_path / "twin" / "poses_bounds.npy"),
        np.load(tmp_path / "orig" / "poses_bounds.npy"))
    twin = jcolmap.read_model(str(tmp_path / "twin" / "sparse" / "0"))
    orig = jcolmap.read_model(str(tmp_path / "orig" / "sparse" / "0"))
    for t, o in zip(twin, orig):
        assert t.keys() == o.keys()
        for k in t:
            for field in t[k].__dataclass_fields__:
                np.testing.assert_array_equal(getattr(t[k], field),
                                              getattr(o[k], field))


def test_dump_eval_images_matches_jax(tmp_path):
    """PNGs and metrics of the port's dump_eval_images against the JAX
    package's on the same maps, ground truth, masks and LPIPS weights:
    the PNGs decode equal, the PSNRs to rtol 1e-6, LPIPS to rtol 1e-4
    (tests/test_torch_lpips.py)."""
    from gbnerf_tpu.train import eval as jeval
    from gbnerf_tpu.utils import lpips as jlpips
    from gbnerf_tpu_torch.utils import lpips as tlpips

    rng = np.random.default_rng(0)
    n, H, W = 3, 34, 40
    maps = {"rgb": rng.random((n, H, W, 3)).astype(np.float32) * 1.1 - 0.05,
            "disp": rng.random((n, H, W)).astype(np.float32) * 3}
    gt = np.clip(maps["rgb"] + rng.normal(0, 0.05, maps["rgb"].shape), 0,
                 1).astype(np.float32)
    masks = np.zeros((n, H, W), np.float32)
    masks[0, 5:20, 8:30] = 1.0
    masks[2, :4, :] = 1.0                    # view 1 has no mask
    jl = jlpips.LPIPS(jax.random.PRNGKey(2))
    tl = tlpips.LPIPS(weights=jax.tree_util.tree_map(np.asarray, jl.params))
    ref = jeval.dump_eval_images(maps, str(tmp_path / "j"), gt=gt,
                                 lpips_fn=jl, gt_masks=masks)
    got = teval.dump_eval_images(maps, str(tmp_path / "t"), gt=gt,
                                 lpips_fn=tl, gt_masks=masks)
    assert list(got) == list(ref)
    for k in ("psnr", "psnr_masked", "psnr_unmasked"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(got["lpips"], ref["lpips"], rtol=1e-4)
    for sub in ("rgb", "disp"):
        for k in range(n):
            f = f"{sub}/{k:03d}.png"
            np.testing.assert_array_equal(read_png(str(tmp_path / "t" / f)),
                                          read_png(str(tmp_path / "j" / f)))
    bare = teval.dump_eval_images(maps, str(tmp_path / "b"))
    assert bare == {"psnr": None, "lpips": None, "psnr_masked": None,
                    "psnr_unmasked": None}


def test_run_ablation_twin_writes_the_originals_s1_and_nog_configs(tmp_path):
    """The twin's configs against tools/run_ablation.py's at --production
    --colmap --lindisp --combine sds --arms s1,nog, paths aside; and
    priorC's (collaborative guidance), which the twin checks."""
    _tool([str(tmp_path / "orig"), "--production", "--colmap", "--lindisp",
           "--combine", "sds", "--arms", "s1,nog", "--check"], ROOT,
          "tools.run_ablation")
    _tool([str(tmp_path / "twin"), "--check"], ROOT,
          "gbnerf_tpu_torch.tools.run_ablation")
    for arm in ("s1", "nog"):
        o = (tmp_path / "orig" / f"cfg_{arm}.txt").read_text().replace(
            str(tmp_path / "orig"), "OUT")
        t = (tmp_path / "twin" / f"cfg_{arm}.txt").read_text().replace(
            str(tmp_path / "twin"), "OUT")
        assert t == o, arm
    _tool([str(tmp_path / "origC"), "--production", "--colmap",
           "--lindisp", "--combine", "sds", "--arms", "s1,priorC",
           "--check"], ROOT, "tools.run_ablation")
    r = _tool([str(tmp_path / "twinC"), "--arms", "s1,priorC", "--check"],
              ROOT, "gbnerf_tpu_torch.tools.run_ablation")
    assert "[check] OK" in r.stdout and "priorC-sds" in r.stdout
    for name in ("cfg_s1.txt", "cfg_priorC-sds.txt"):
        o = (tmp_path / "origC" / name).read_text().replace(
            str(tmp_path / "origC"), "OUT")
        t = (tmp_path / "twinC" / name).read_text().replace(
            str(tmp_path / "twinC"), "OUT")
        assert t == o, name
    assert "is_colla_guidance = True" in t


@pytest.mark.parametrize("combine", ["sds", "csd", "csd_ref"])
def test_run_ablation_twin_writes_the_originals_guided_configs(tmp_path,
                                                               combine):
    """Every arm (rand, prior, priorN, priorL, priorNL, priorC beside s1
    and nog) under each combine: the twin's --check configs equal
    tools/run_ablation.py's at --production --colmap --lindisp, paths
    aside, file for file."""
    arms = "s1,nog,rand,prior,priorN,priorL,priorNL,priorC"
    _tool([str(tmp_path / "orig"), "--production", "--colmap", "--lindisp",
           "--combine", combine, "--arms", arms, "--check"], ROOT,
          "tools.run_ablation")
    r = _tool([str(tmp_path / "twin"), "--combine", combine, "--arms", arms,
               "--check"], ROOT, "gbnerf_tpu_torch.tools.run_ablation")
    assert "[check] OK" in r.stdout
    names = sorted(p.name for p in (tmp_path / "orig").glob("cfg_*.txt"))
    assert len(names) == 8
    assert sorted(p.name for p in (tmp_path / "twin").glob("cfg_*.txt")) \
        == names
    for name in names:
        o = (tmp_path / "orig" / name).read_text().replace(
            str(tmp_path / "orig"), "OUT")
        t = (tmp_path / "twin" / name).read_text().replace(
            str(tmp_path / "twin"), "OUT")
        assert t == o, name


def test_run_ablation_twin_s1_then_nog_on_the_cpu(tmp_path):
    """s1 → nog through the CLI at tiny widths (the original's small-MLP
    field, 24 × 32 views, 4 + 4 steps): both arms evaluate, nog resumes
    from s1's checkpoint with random LPIPS, and the eval PNGs decode to
    to8b of the eval maps."""
    out = tmp_path / "abl"
    r = _tool([str(out), "--smoke", "--iters1", "4", "--iters2", "4",
               "--H", "24", "--W", "32", "--n_train", "4", "--n_test", "2",
               "--device", "cpu"], ROOT, "gbnerf_tpu_torch.tools.run_ablation")
    assert "| nog |" in r.stdout
    res = json.loads((out / "ablation.json").read_text())
    for arm, it in (("s1", 4), ("nog", 8)):
        assert res[arm]["iter"] == it
        for k in ("eval_psnr", "eval_psnr_masked", "eval_psnr_unmasked"):
            assert np.isfinite(res[arm][k]), (arm, k)
    log = (out / "nog.log").read_text()
    assert "resumed at iter 4" in log and "[lpips] WARNING" in log
    ev = out / "logs" / "nog" / "eval_images_8"
    rgb = np.load(ev / "rgb.npy")
    for k in range(2):
        np.testing.assert_array_equal(read_png(str(ev / "rgb" /
                                                   f"{k:03d}.png")),
                                      to8b(rgb[k]))
    assert (out / "logs" / "nog" / "ckpt" / "8.pt").is_file()
