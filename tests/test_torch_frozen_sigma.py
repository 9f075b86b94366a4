"""Port vs JAX: the frozen-σ field (the reference's NeRF_RGB,
``alpha_model_path``) — ``make_frozen_sigma_field_fn`` on the MLP, the
stage-1 and stage-2 losses with ``alpha=`` on small CP fields, and
``load_alpha_model`` through ``train()`` and ``render_only`` on the CPU.

σ comes from the frozen field, σ-only and without gradient; the trainable
fields give the colour. So no gradient reaches the alpha field, and none
reaches the trainable fields' σ column of ``ws1`` (the σ-net's output
weight that feeds σ alone, ``core/cp_field.py``): a step leaves it as it
was, bit for bit.

Tolerances, with their reasons: the MLP in f32 on both sides, rtol 1e-6
with atol 1e-6·max|ref| (the same f32 formulas); the CP fields as
tests/test_torch_train.py's CP case (bf16 field matmuls summed in another
order): loss terms rtol 1e-3, gradients rtol 3e-2 with atol
5e-3·max|ref|; σ against the alpha field's own call: equal.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gbnerf_tpu.core.fields import NeRFMLP as JNeRFMLP
from gbnerf_tpu.core.fields import make_field_fn as j_make_field_fn
from gbnerf_tpu.core.fields import (
    make_frozen_sigma_field_fn as j_make_frozen)
from gbnerf_tpu.guidance import stable as jst
from gbnerf_tpu.train import state as jstate
from gbnerf_tpu.train import step as jstep
from gbnerf_tpu_torch import convert
from gbnerf_tpu_torch.core.fields import NeRFMLP as TNeRFMLP
from gbnerf_tpu_torch.core.fields import make_field_fn as t_make_field_fn
from gbnerf_tpu_torch.core.fields import (
    make_frozen_sigma_field_fn as t_make_frozen)
from gbnerf_tpu_torch.guidance import stable as tst
from gbnerf_tpu_torch.train import loop as tloop
from gbnerf_tpu_torch.train import state as tstate
from gbnerf_tpu_torch.train import step as tstep

from _sd_pair import draws, make_stack
from test_torch_train import (MLP_KW, _batches64, _cp_cfg, _cp_setup,
                              _grads_to_jax, _loop_cfg, _scene, _tree_close)

torch.set_num_threads(1)


def _mlp(seed):
    jm = JNeRFMLP(**MLP_KW)
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((2, 3)),
                     jnp.zeros((2, 3)))["params"]
    tm = TNeRFMLP(**MLP_KW)
    convert.load_jax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    return jm, params, tm


def test_frozen_sigma_field_matches_jax(rng):
    """As tests/test_fields.py::test_frozen_sigma_field_nerf_rgb_parity:
    σ from the alpha field, rgb from the trainable one, σ-only calls to
    the alpha field alone; the rgb field's gradients match the JAX
    package's and none reaches the alpha field."""
    jm, p_rgb, t_rgb = _mlp(0)
    _, p_alpha, t_alpha = _mlp(2)
    t_alpha.requires_grad_(False)
    pts = rng.standard_normal((6, 5, 3)).astype(np.float32)
    dirs = rng.standard_normal((6, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)

    def jfield(pr, pa):
        return j_make_frozen(j_make_field_fn(jm, pr), j_make_field_fn(jm, pa))

    tfield = t_make_frozen(t_make_field_fn(t_rgb), t_make_field_fn(t_alpha))
    tp, td = torch.from_numpy(pts), torch.from_numpy(dirs)
    raw = tfield(tp, td)
    ref = jfield(p_rgb, p_alpha)(pts, dirs)
    np.testing.assert_allclose(raw.detach().numpy(), ref, rtol=1e-6,
                               atol=1e-6 * np.abs(ref).max())
    alpha_raw = t_make_field_fn(t_alpha)(tp, td, sigma_only=True)
    assert torch.equal(raw[..., 3], alpha_raw[..., 3])
    assert torch.equal(tfield(tp, td, sigma_only=True), alpha_raw)
    assert not tfield(tp, td, sigma_only=True).requires_grad

    (raw * 1.7).sum().backward()
    jg_rgb, jg_alpha = jax.grad(
        lambda pr, pa: jnp.sum(jfield(pr, pa)(pts, dirs) * 1.7),
        argnums=(0, 1))(p_rgb, p_alpha)
    assert all(float(jnp.abs(g).max()) == 0.0
               for g in jax.tree_util.tree_leaves(jg_alpha))
    assert all(p.grad is None for p in t_alpha.parameters())
    got = convert.params_to_jax({"f": {k: p.grad for k, p in
                                       t_rgb.named_parameters()}})["f"]
    _tree_close(got, jg_rgb, rtol=1e-6, atol_frac=1e-6)
    # the σ head feeds σ alone: it gets no gradient
    assert float(t_rgb.sigma.weight.grad.abs().max()) == 0.0


def _alpha_pair(cfg, seed):
    """A frozen fine CP field in both packages (the JAX package's alpha is
    (model, params), its params threaded as ``aparams``)."""
    _, tc, tf = tstate.create_train_state(cfg, torch.Generator().manual_seed(
        seed))
    tf.requires_grad_(False)
    ap = convert.params_to_jax({"fine": tf.state_dict()})["fine"]
    return (jstate.build_field(cfg, fine=True),
            jax.tree_util.tree_map(jnp.asarray, ap)), tf


def _sigma_columns_unchanged(fields):
    for f in fields:
        assert float(f.ws1.grad[:, 0].abs().max()) == 0.0
        assert float(f.ws1.grad[:, 1:].abs().max()) > 0.0


def test_stage1_loss_with_alpha_matches_jax(rng):
    """Every stage-1 term with σ from a frozen field: the loss and its
    terms, every gradient; the alpha field gets none, the trainable
    fields' σ columns of ws1 get exact zeros."""
    cfg = _cp_cfg()
    jst1, jc, jf, params, st, tc, tf = _cp_setup(cfg)
    (ja, ap), ta = _alpha_pair(cfg, 5)
    b = _batches64(rng, 24)
    batches = {k: {kk: vv.astype(np.float32) for kk, vv in v.items()}
               for k, v in b.items()}
    jsf = jstep.make_train_step_stage1(cfg, jc, jf, 0.5, 4.0,
                                       alpha=(ja, None))
    (ref, jm), jg = jax.jit(jax.value_and_grad(jsf.loss_fn, has_aux=True))(
        jst1.params, jax.tree_util.tree_map(jnp.asarray, batches),
        jax.random.PRNGKey(0), ap)
    tb = {k: {kk: torch.from_numpy(vv) for kk, vv in v.items()}
          for k, v in batches.items()}
    loss, m = tstep.make_train_step_stage1(cfg, tc, tf, 0.5, 4.0,
                                           alpha=ta).loss_fn(tb)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(ref), rtol=1e-3)
    for k in ("img_loss", "depth_loss", "col_loss", "sigma_loss"):
        assert float(jm[k]) != 0.0, k
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-3,
                                   err_msg=k)
    _tree_close(_grads_to_jax({"coarse": tc, "fine": tf}),
                jax.tree_util.tree_map(np.asarray, jg), rtol=3e-2,
                atol_frac=5e-3)
    assert all(p.grad is None for p in ta.parameters())
    _sigma_columns_unchanged((tc, tf))


def test_stage2_loss_with_alpha_matches_jax(rng):
    """Stage 2 with σ from a frozen field and RGB SDS on the composite (a
    cached masked-latents entry): the loss, its terms and every
    gradient."""
    import chip_smoke
    from gbnerf_tpu_torch.data.rays_bank import build_ray_banks
    from test_torch_stage2 import _batch, _cfg, _to_torch

    scene, depth_gts = chip_smoke.spinnerf_scene(3, 36, 48, n_test=1, seed=2)
    cfg = _cfg(is_normal_guidance=False)
    jm, tm = make_stack()["mods"]()
    banks = build_ray_banks(scene.images, scene.masks, scene.inpainted_depths,
                            scene.poses, scene.hwf[2], depth_gts)
    b = _batch(scene, banks, rng)
    b["masked_latents"] = np.asarray(jst.precompute_masked_latents(
        jm, scene.images[1:2], scene.masks[1:2], rng=jax.random.PRNGKey(1)))
    _, tc, tf = tstate.create_train_state(cfg, torch.Generator().manual_seed(
        3))
    (ja, ap), ta = _alpha_pair(cfg, 6)
    params = jax.tree_util.tree_map(jnp.asarray, convert.params_to_jax(
        {"coarse": tc.state_dict(), "fine": tf.state_dict()}))
    jc, jf = jstate.build_field(cfg, fine=False), jstate.build_field(
        cfg, fine=True)
    step_i, key = 7, jax.random.PRNGKey(4)
    jsf = jstep.make_train_step_stage2(
        cfg, jc, jf, scene.near, scene.far, scene.hwf,
        guidance_fn=jst.make_guidance_fn(jm, cfg.guidance), alpha=(ja, None))
    jb = jstep.Stage2Batch(**jax.tree_util.tree_map(jnp.asarray, b))
    (ref, jmet), jg = jax.jit(jax.value_and_grad(jsf.loss_fn, has_aux=True))(
        params, jb, step_i, key, None, ap)
    k_g = jax.random.split(key, 6)[5]
    tsf = tstep.make_train_step_stage2(
        cfg, tc, tf, scene.near, scene.far, scene.hwf,
        guidance_fn=tst.make_guidance_fn(tm, cfg.guidance), alpha=ta)
    loss, m = tsf.loss_fn(tstep.Stage2Batch(**_to_torch(b)), step_i,
                          draws={"rgb": draws(jax.random.split(k_g, 3)[0],
                                              8)})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-3)
    for k in ("img_loss", "depth_loss", "sds_loss", "sigma_loss"):
        assert float(jmet[k]) != 0.0, k
        np.testing.assert_allclose(m[k].item(), float(jmet[k]), rtol=1e-3,
                                   err_msg=k)
    _tree_close(_grads_to_jax({"coarse": tc, "fine": tf}),
                jax.tree_util.tree_map(np.asarray, jg), rtol=3e-2,
                atol_frac=5e-3)
    _sigma_columns_unchanged((tc, tf))


def test_train_and_render_only_with_alpha_model_path(tmp_path):
    """A stage-1 run, then a second one with its checkpoint as
    alpha_model_path: the σ columns of ws1 keep their initial values bit
    for bit while the rest trains; render_only renders with the frozen
    σ; a directory without a checkpoint is refused."""
    scene = _scene()
    src = _loop_cfg(tmp_path, N_iters=4, i_weights=4, expname="alpha")
    tloop.train(src, scene=scene, device="cpu", log_fn=lambda i, m: None)
    cfg = _loop_cfg(tmp_path, N_iters=4, i_weights=4, expname="rgb")
    cfg = cfg.replace(field=dataclasses.replace(
        cfg.field, alpha_model_path=str(tmp_path / "alpha" / "ckpt")))
    init = tstate.create_train_state(cfg, torch.Generator().manual_seed(
        cfg.train.seed))[0]
    out = tloop.train(cfg, scene=scene, device="cpu",
                      log_fn=lambda i, m: None)
    for a, b in zip(init.fields(), out["state"].fields()):
        assert torch.equal(a.ws1[:, 0], b.ws1[:, 0])
        assert not torch.equal(a.ws1[:, 1:], b.ws1[:, 1:])
        assert not torch.equal(a.wc2, b.wc2)
    alpha = tloop.load_alpha_model(cfg, "cpu")
    assert not any(p.requires_grad for p in alpha.parameters())
    # render_test: the path's depth.npy is of the test poses
    got = tloop.render_only(cfg.replace(train=dataclasses.replace(
        cfg.train, render_test=True)), scene=scene, device="cpu")
    depth = np.load(f"{got['outdir']}/depth.npy")
    assert np.isfinite(depth).all()
    # the depth is the alpha field's: σ of both passes from it (the same
    # as a render with the alpha field as coarse and fine), not the run's
    from gbnerf_tpu_torch.train.eval import render_pose_path

    def depth_of(coarse, fine):
        return render_pose_path(
            tstep.make_render_fn(cfg, coarse, fine, scene.near, scene.far),
            scene.poses_test, scene.hwf, block=512, device="cpu")["depth"]

    assert np.array_equal(depth, depth_of(alpha, alpha))
    st = out["state"]
    assert not np.array_equal(depth, depth_of(st.coarse, st.fine))
    bad = cfg.replace(field=dataclasses.replace(
        cfg.field, alpha_model_path=str(tmp_path / "none")))
    with pytest.raises(SystemExit, match="no checkpoint"):
        tloop.load_alpha_model(bad, "cpu")
