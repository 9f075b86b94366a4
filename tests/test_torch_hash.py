"""Port vs JAX: the hash-grid field (``hash_encode``, ``HashGridField``),
its gradients, one stage-1 step, the train-state converter, and the hash
field through the loop, the frozen-σ field and the mesh export.

Tolerances, with their reasons:
- ``hash_encode``: rtol 1e-6. Both sides form the positions with the same
  f32 ops in the same order, so the cells, corners and fractions are
  equal bit for bit; the eight corner terms are summed in another order.
  Tables of distinct positive values make any index mismatch show and keep
  the sums free of cancellation;
- the field forward: atol 1e-5 in f32; in bf16 the bf16 tolerances of
  tests/test_torch_field.py (rtol 3e-2, atol 5e-3 · max): both sides round
  every head operand to bf16 and sum in another order;
- the gradients: atol 1e-5 on the table's, and on the points' in f64 (the
  positions stay f32 in both packages, as the encode's cell arithmetic);
- one stage-1 step in f64, as tests/test_torch_train.py runs the MLP's:
  the loss to rtol 1e-5, the parameters after one Adam step to atol 1e-5.
  Adam's first update is lr·g/(|g| + eps): in f32 a gradient error of
  2e-10 near g = 0 already moves it by 1e-5.
"""
import contextlib
import dataclasses
import os
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from gbnerf_tpu.config import (Config, DataConfig, FieldConfig, RenderConfig,
                               TrainConfig)
from gbnerf_tpu.core.fields import HashGridField as JHashGridField
from gbnerf_tpu.core.fields import hash_encode as j_hash_encode
from gbnerf_tpu.train import state as jstate
from gbnerf_tpu.train import step as jstep
from gbnerf_tpu_torch import convert
from gbnerf_tpu_torch.core.normals import field_normals
from gbnerf_tpu_torch.core.fields import HashGridField, hash_encode
from gbnerf_tpu_torch.core.fields import (level_resolutions, make_field_fn,
                                          make_frozen_sigma_field_fn)
from gbnerf_tpu_torch.train import loop as tloop
from gbnerf_tpu_torch.train import state as tstate
from gbnerf_tpu_torch.train import step as tstep
from gbnerf_tpu_torch.train.checkpoint import CheckpointManager

torch.set_num_threads(1)

# a small field: 4 levels at 4, 16, 64, 256 (bound 2: 2048·2/4 = 1024 =
# 4^5 → scale 4^(5/3) ≈ 10.08 gives 4, 40, 406, 4096), T = 2^10
SMALL = dict(bound=2.0, n_levels=4, n_features=2, log2_hashmap_size=10,
             base_res=4)


class x64:
    """JAX float64 for the duration of a with-block."""

    def __enter__(self):
        jax.config.update("jax_enable_x64", True)

    def __exit__(self, *exc):
        jax.config.update("jax_enable_x64", False)


def _distinct_table(L, T, F):
    """Distinct positive values, so that any wrong index shows."""
    return (1.0 + np.arange(L * T * F, dtype=np.float64).reshape(L, T, F)
            / (L * T * F)).astype(np.float32)


def _points(rng, n, node_res):
    """Points inside [0, 1]³, past it on both sides (outside ±bound) and
    on the nodes of a grid of ``node_res`` cells a side (frac = 0)."""
    inside = rng.uniform(0.0, 1.0, (n, 3))
    outside = rng.uniform(-0.4, 1.4, (n, 3))
    nodes = rng.integers(-2, node_res + 3, (n, 3)) / node_res
    return np.concatenate([inside, outside, nodes]).astype(np.float32)


@pytest.mark.parametrize("L,T,F", [(4, 2 ** 10, 2), (3, 2 ** 8, 4)])
@pytest.mark.parametrize("scale", [2.0, 1.5])
def test_hash_encode_matches_jax(L, T, F, scale, rng):
    res = level_resolutions(L, 4, scale)
    dense = [(r + 1) ** 3 <= T for r in res]
    assert any(dense) and not all(dense)          # both kinds of level
    table = _distinct_table(L, T, F)
    x = _points(rng, 300, 32)      # nodes of every level when scale is 2
    ref = np.asarray(j_hash_encode(jnp.asarray(x), jnp.asarray(table),
                                   base_res=4, per_level_scale=scale))
    got = hash_encode(torch.from_numpy(x), torch.from_numpy(table),
                      base_res=4, per_level_scale=scale)
    assert got.shape == (len(x), L * F) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=0)
    ref0 = np.asarray(j_hash_encode(jnp.asarray(x), jnp.asarray(table),
                                    base_res=4, per_level_scale=scale,
                                    interpolate=False))
    got0 = hash_encode(torch.from_numpy(x), torch.from_numpy(table),
                       base_res=4, per_level_scale=scale, interpolate=False)
    np.testing.assert_array_equal(got0.numpy(), ref0)


def test_full_width_scale_and_resolutions_match_jax():
    """The config default: L 16, T 2^19, base 16, bound 100 → scale
    12800^(1/15); levels 0–2 dense, 3–15 hashed."""
    jf, tf = JHashGridField(), HashGridField(log2_hashmap_size=4)
    assert tf.per_level_scale == jf.per_level_scale
    np.testing.assert_allclose(tf.per_level_scale, 12800 ** (1 / 15),
                               rtol=1e-12)
    res = level_resolutions(16, 16, tf.per_level_scale)
    ref = [int(np.floor(16 * jf.per_level_scale ** lvl)) for lvl in range(16)]
    assert res == ref
    # 16·scale^15 is 204800 less one rounding in float64: floor → 204799
    assert res[:4] == [16, 30, 56, 106] and res[-1] == 204799
    assert [(r + 1) ** 3 <= 2 ** 19 for r in res] == [True] * 3 + [False] * 13


@pytest.mark.cuda
def test_hash_field_positions_on_the_card_equal_the_cpus(monkeypatch):
    """The field's x01 = (pts + bound) / (2·bound) on the card is the
    CPU's (and so the JAX package's) bit for bit: a Python-scalar divisor
    would make CUDA multiply by its reciprocal, one ulp off, which moves a
    finest-level cell fraction by ≈ 0.01."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA's division by a scalar)")
    from gbnerf_tpu_torch.core import fields as tfields

    seen = []
    encode = tfields.hash_encode
    monkeypatch.setattr(tfields, "hash_encode",
                        lambda x01, *a, **k: seen.append(x01.cpu())
                        or encode(x01, *a, **k))
    g = torch.Generator().manual_seed(0)
    field = HashGridField(log2_hashmap_size=12, generator=g)
    pts = torch.rand(1 << 16, 3, generator=g) * 4 - 2
    field(pts, None, sigma_only=True)
    field.to("cuda")(pts.cuda(), None, sigma_only=True)
    assert torch.equal(seen[0], seen[1])


@pytest.fixture(scope="module")
def flax_params():
    """The flax module's own init of the small field (f32 numpy leaves)."""
    jm = JHashGridField(**SMALL)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((2, 3)),
                              jnp.ones((2, 3)) / np.sqrt(3.0))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _jax_field(params, rng, compute_dtype=jnp.float32, table_scale=None):
    """The flax module in compute_dtype and a copy of the params, with a
    table of N(0, table_scale²) values if asked: features that move the
    heads visibly."""
    params = dict(params)
    if table_scale is not None:
        params["hash_table"] = (table_scale * rng.standard_normal(
            params["hash_table"].shape)).astype(np.float32)
    return JHashGridField(compute_dtype=compute_dtype, **SMALL), params


def _field_inputs(rng, n=64, s=5):
    pts = rng.uniform(-2.4, 2.4, (n, s, 3)).astype(np.float32)
    d = rng.standard_normal((n, 1, 3))
    return pts, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(
        np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hash_field_forward_matches_jax(dtype, flax_params, rng):
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jm, params = _jax_field(flax_params, rng, jdt, table_scale=0.5)
    tm = HashGridField(compute_dtype=tdt, **SMALL)
    own = tm.state_dict()
    sd = convert.field_state_dict(params)
    assert set(sd) == set(own) and "sigma_out.bias" not in own
    for k, v in own.items():
        assert tuple(v.shape) == tuple(sd[k].shape), k
    convert.load_jax_params(tm, params)
    pts, vd = _field_inputs(rng)
    ref = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(pts),
                                       jnp.asarray(vd)))
    got = tm(torch.from_numpy(pts), torch.from_numpy(vd))
    assert got.shape == (64, 5, 4) and got.dtype == torch.float32
    if dtype == "float32":
        np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0,
                                   atol=1e-5)
    else:
        np.testing.assert_allclose(got.detach().numpy(), ref, rtol=3e-2,
                                   atol=5e-3 * np.abs(ref).max())
    # σ-only: σ of the full call, bit for bit, and rgb zero (the CP field's
    # convention); the directions are not read
    sig = tm(torch.from_numpy(pts), None, sigma_only=True)
    assert torch.equal(sig[..., 3], got[..., 3])
    assert not sig[..., :3].any()
    # back to the flax tree unchanged
    back = convert.params_to_jax({"f": tm.state_dict()})["f"]
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))


@pytest.mark.parametrize("case", ["init-f32", "scaled-f64"])
def test_hash_field_grads_match_jax(case, flax_params, rng):
    """d⟨raw, c⟩ with respect to the table (the scatter-add) and to the
    points (through the interpolation weights), against jax.grad: at the
    flax init (table U(±1e-4)) in f32, and with a table of N(0, 0.5²)
    values in f64. The points' gradient is then O(100) (the finest level
    has 4096 cells over 2·bound = 4) and carries the f32 rounding of the
    position arithmetic, which both packages keep in f32: 1e-6 relative."""
    pts, vd = _field_inputs(rng)
    cot = rng.standard_normal(pts.shape[:-1] + (4,))
    f64 = case == "scaled-f64"
    cast = np.float64 if f64 else np.float32
    with x64() if f64 else contextlib.nullcontext():
        jm, params = _jax_field(flax_params, rng,
                                jnp.float64 if f64 else jnp.float32,
                                table_scale=0.5 if f64 else None)
        params = jax.tree_util.tree_map(lambda a: a.astype(cast), params)

        def loss(p, x):
            return jnp.sum(jm.apply({"params": p}, x, jnp.asarray(vd))
                           * jnp.asarray(cot.astype(cast)))

        gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(
            params, jnp.asarray(pts.astype(cast)))
        gp, gx = np.asarray(gp["hash_table"]), np.asarray(gx)
    tm = HashGridField(compute_dtype=torch.float64 if f64 else torch.float32,
                       **SMALL)
    if f64:
        tm = tm.double()
    convert.load_jax_params(tm, params)
    x = torch.from_numpy(pts.astype(cast)).requires_grad_(True)
    out = tm(x, torch.from_numpy(vd))
    (out * torch.from_numpy(cot).to(out.dtype)).sum().backward()
    assert np.abs(gp).max() > 1e-2
    np.testing.assert_allclose(tm.hash_table.grad.numpy(), gp, rtol=0,
                               atol=1e-5)
    if f64:
        assert np.abs(gx).max() > 10.0
        np.testing.assert_allclose(x.grad.numpy(), gx, rtol=0,
                                   atol=1e-6 * np.abs(gx).max())
    else:
        assert np.abs(gx).max() > 1e-3
        np.testing.assert_allclose(x.grad.numpy(), gx, rtol=0, atol=1e-5)


# the step's fields: a dense level at 4 and a hashed one at 1024 (the JAX
# step compiles each level's gathers once per field call)
STEP = dict(SMALL, n_levels=2)


def _hash_cfg(field=SMALL, **train):
    return Config(
        field=FieldConfig(no_tcnn=False, field_type="hash", **field),
        render=RenderConfig(N_samples=9, N_importance=5, perturb=0.0,
                            raw_noise_std=0.0, lindisp=True, white_bkgd=True),
        data=DataConfig(depth_lambda=0.1, sdepth_lambda=0.05),
        train=TrainConfig(sigma_loss_weight=0.2, first_stage=True, **train))


def _batches(rng, n=20):
    out = {}
    for name, width in (("clf", 3), ("inp", 1), ("depth", 2)):
        ro = rng.standard_normal((n, 3)) * 0.3
        rd = rng.standard_normal((n, 3)) * rng.uniform(0.5, 1.5, (n, 1))
        tgt = rng.random((n, width))
        if name == "depth":
            tgt[:, 0] = rng.uniform(1.5, 3.5, n)
        out[name] = {"o": ro, "d": rd, "target": tgt}
    return out


def test_hash_stage1_step_matches_jax_f64(rng):
    """One stage-1 step on hash fields, every loss term on, with the batch
    injected, against the JAX step: loss_fn under jax.value_and_grad, then
    optax.adam; the port's loss_fn, backward and adam_step."""
    cfg = _hash_cfg(STEP)
    batches = _batches(rng)
    with x64():
        jm = JHashGridField(compute_dtype=jnp.float64, **STEP)
        # the port's init carried across (no flax init: it compiles)
        trees = convert.params_to_jax({
            name: tstate.build_field(cfg, generator=torch.Generator()
                                     .manual_seed(seed)).state_dict()
            for name, seed in (("coarse", 1), ("fine", 2))})
        for p in trees.values():
            p["hash_table"] = 0.5 * rng.standard_normal(
                p["hash_table"].shape)
        trees = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                       trees)
        jsf = jstep.make_train_step_stage1(cfg, jm, jm, 0.5, 4.0)
        jb = jax.tree_util.tree_map(jnp.asarray, batches)
        jp = jax.tree_util.tree_map(jnp.asarray, trees)
        (ref, jm_metrics), jg = jax.jit(jax.value_and_grad(
            jsf.loss_fn, has_aux=True))(
            jp, jb, jax.random.PRNGKey(0))
        tx = jstate.make_optimizer(cfg)
        after = jax.tree_util.tree_map(np.asarray, jax.jit(
            lambda g, p: optax.apply_updates(p, tx.update(g, tx.init(p),
                                                          p)[0]))(jg, jp))
    fields = {}
    for name in ("coarse", "fine"):
        m = HashGridField(compute_dtype=torch.float64, **STEP).double()
        convert.load_jax_params(m, trees[name])
        fields[name] = m
    state = tstate.TrainState(0, fields["coarse"], fields["fine"],
                              tstate.make_optimizer(
                                  cfg, [p for m in fields.values()
                                        for p in m.parameters()]))
    tb = {k: {kk: torch.from_numpy(vv) for kk, vv in v.items()}
          for k, v in batches.items()}
    step = tstep.make_train_step_stage1(cfg, fields["coarse"],
                                        fields["fine"], 0.5, 4.0)
    loss, m = step.loss_fn(tb)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=1e-5)
    for k in ("img_loss", "depth_loss", "col_loss", "sigma_loss"):
        assert float(jm_metrics[k]) != 0.0, k
        np.testing.assert_allclose(float(m[k]), float(jm_metrics[k]),
                                   rtol=1e-5, err_msg=k)
    tstate.adam_step(state, tstate.lr_schedule(cfg))
    got = convert.params_to_jax({n: f.state_dict() for n, f in fields.items()})
    moved = 0
    for path, a in jax.tree_util.tree_leaves_with_path(got):
        b = after
        for k in path:
            b = b[k.key]
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))
    for name in ("coarse", "fine"):
        moved += int(np.count_nonzero(
            got[name]["hash_table"] != trees[name]["hash_table"]))
    assert moved > 0


def test_hash_train_state_round_trip_through_jax(rng):
    """A hash state after one optax update (table moments included) →
    the port and back, unchanged; build_field makes HashGridFields."""
    cfg = _hash_cfg()
    st, tc, tf = tstate.create_train_state(cfg, torch.Generator().manual_seed(
        0))
    assert isinstance(tc, HashGridField) and isinstance(tf, HashGridField)
    assert tc.hash_table.shape == (4, 2 ** 10, 2)
    params = convert.params_to_jax({"coarse": tc.state_dict(),
                                    "fine": tf.state_dict()})
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tx = jstate.make_optimizer(cfg)
    g = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape), p.dtype), jp)

    @jax.jit
    def update(g, p):
        upd, opt = tx.update(g, tx.init(p), p)
        return optax.apply_updates(p, upd), opt

    host = jax.device_get(update(g, jp))
    state = convert.train_state_from_jax(host[0], host[1], 1, cfg=cfg)
    assert state.step == 1
    assert torch.count_nonzero(
        state.optimizer.state[state.fine.hash_table]["exp_avg_sq"]) > 0
    back_p, back_o, back_step = convert.train_state_to_jax(state)
    assert int(back_step) == 1
    for got, ref in ((back_p, host[0]), (back_o[0]["mu"], host[1][0].mu),
                     (back_o[0]["nu"], host[1][0].nu)):
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(ref)):
            np.testing.assert_array_equal(a, np.asarray(b))


def _scene():
    from gbnerf_tpu_torch.data.llff import LLFFScene
    from gbnerf_tpu_torch.tools import make_synthetic_scene as syn

    H, W, n = 24, 32, 4
    focal = 1.2 * W
    imgs, poses, disps = [], [], []
    for k in range(n + 1):
        th = (k / n - 0.5) * 0.8
        c2w = syn.look_at(np.array([2.5 * np.sin(th), 0.2,
                                    2.5 * np.cos(th)]))
        img, depth, _ = syn.render_scene(H, W, focal, c2w)
        imgs.append(img.astype(np.float32))
        disps.append((1.0 / np.maximum(depth, 1e-3)).astype(np.float32))
        poses.append(np.concatenate(
            [c2w, np.array([[H], [W], [focal]], np.float32)], 1))
    imgs, poses, disps = np.stack(imgs), np.stack(poses), np.stack(disps)
    train = [0, 1, 3, 4]
    masks = np.zeros((n, H, W), np.float32)
    masks[:, 8:12, 10:16] = 1.0
    return LLFFScene(images=imgs[train], masks=masks,
                     inpainted_depths=disps[train] / disps.max(),
                     poses=poses[train], poses_test=poses[2:3],
                     bds=np.array([[1.0, 4.0]], np.float32),
                     render_poses=poses[:2], hwf=(H, W, focal), near=1.0,
                     far=4.0, images_test=imgs[2:3])


def _loop_cfg(tmp_path, expname="hash", **train):
    kw = dict(N_iters=30, N_rand=64, lrate=1e-2, i_print=10, i_weights=30,
              i_video=10 ** 9, i_evaluate=30, i_testset=10 ** 9,
              first_stage=True, basedir=str(tmp_path), expname=expname,
              render_factor=0)
    kw.update(train)
    return Config(
        field=FieldConfig(no_tcnn=False, field_type="hash", bound=2.0,
                          n_levels=4, log2_hashmap_size=12, base_res=4),
        render=RenderConfig(N_samples=16, N_importance=16, perturb=1.0,
                            raw_noise_std=1.0, render_block=512),
        data=DataConfig(colmap_depth=False), train=TrainConfig(**kw))


def test_hash_fields_train_checkpoint_freeze_sigma_and_mesh(tmp_path):
    """Stage 1 on hash fields through train() (img_loss falls, the
    checkpoint restores equal, the eval is finite); then the frozen σ of
    that run's fine hash field in a short stage-1 run (σ of the composed
    field bit-equal to the alpha field's), and the mesh of its fine field
    by the export_mesh CLI."""
    from gbnerf_tpu_torch.config import save_config
    from gbnerf_tpu_torch.tools import export_mesh

    scene = _scene()
    cfg = _loop_cfg(tmp_path)
    out = tloop.train(cfg, scene=scene, device="cpu",
                      log_fn=lambda i, m: None)
    hist = [m["img_loss"] for _, m in out["history"]]
    assert len(hist) == 3 and all(np.isfinite(hist)) and hist[-1] < hist[0]
    fresh, _, _ = tstate.create_train_state(cfg, torch.Generator()
                                            .manual_seed(5))
    CheckpointManager(str(tmp_path / "hash" / "ckpt")).restore(fresh)
    for f, g in zip(fresh.fields(), out["state"].fields()):
        for (k, a), b in zip(f.state_dict().items(), g.state_dict().values()):
            assert torch.equal(a, b), k
    assert np.isfinite(out["last_eval"]["eval_psnr"])

    # frozen σ from the run's fine field; the colour trains
    fcfg = _loop_cfg(tmp_path, "frozen", N_iters=4, i_print=2, i_weights=4,
                     i_evaluate=10 ** 9)
    fcfg = fcfg.replace(field=dataclasses.replace(
        fcfg.field, alpha_model_path=str(tmp_path / "hash" / "ckpt")))
    alpha = tloop.load_alpha_model(fcfg, "cpu")
    assert isinstance(alpha, HashGridField) and not any(
        p.requires_grad for p in alpha.parameters())
    fout = tloop.train(fcfg, scene=scene, device="cpu",
                       log_fn=lambda i, m: None)
    assert fout["state"].step == 4
    assert all(np.isfinite(v) for _, m in fout["history"] for v in m.values())
    pts = torch.rand((32, 4, 3)) * 2 - 1
    vd = torch.nn.functional.normalize(torch.randn(32, 3), dim=-1)
    fn = make_frozen_sigma_field_fn(make_field_fn(fout["state"].fine),
                                    make_field_fn(alpha))
    with torch.no_grad():
        assert torch.equal(fn(pts, vd)[..., 3],
                           make_field_fn(alpha)(pts, vd, sigma_only=True)
                           [..., 3])

    # the fine field's mesh, at an iso between its σ quantiles on the grid
    with torch.no_grad():
        grid = torch.rand((4096, 1, 3)) * 3.0 - 1.5
        sig = out["state"].fine(grid, None, sigma_only=True)[..., 3]
    iso = float(torch.quantile(sig, 0.5))
    save_config(cfg, str(tmp_path / "cfg.txt"))
    res = export_mesh.main(["--config", str(tmp_path / "cfg.txt"),
                            "--res", "24", "--bound", "1.5", "--iso",
                            repr(iso), "--device", "cpu", "--color"])
    assert len(res["faces"]) > 0 and Path(res["out"]).suffix == ".ply"
    assert np.isfinite(res["colors"]).all()
    assert os.path.getsize(res["out"]) > 0
    # field_normals through the hash field's autograd: −∇σ/|∇σ| at the
    # mesh's vertices, each σ a function of its own point only
    fine = out["state"].fine
    verts = torch.as_tensor(res["verts"][:256], dtype=torch.float32)
    n = field_normals(
        lambda p: fine(p[:, None], None, sigma_only=True)[:, 0, 3], verts)
    with torch.enable_grad():
        p = verts[:4].clone().requires_grad_(True)
        (g,) = torch.autograd.grad(fine(p[:, None], None, sigma_only=True)
                                   [:, 0, 3].sum(), p)
    assert torch.isfinite(n).all()
    np.testing.assert_allclose(n.norm(dim=-1).numpy(), 1.0, rtol=1e-5)
    torch.testing.assert_close(n[:4], -g / g.norm(dim=-1, keepdim=True))
