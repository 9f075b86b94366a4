"""Port vs JAX: data and tensor parallelism (gbnerf_tpu_torch/parallel/).

The port's ranks run as gloo processes on the CPU under torchrun
(gbnerf_tpu_torch/tools/parallel_check.py, which imports no JAX, so the
spawned ranks stay light); the JAX package runs on the eight virtual
devices of tests/conftest.py. Both sides get the same seeded numpy inputs
and the same draws (the JAX package's batch indices, recomputed from its
keys, are injected into the port; jitter and σ noise are off where JAX is
compared).

Cases: the rank slices against JAX's ``shard_batch`` shards; the 4-rank
stage-1 step against JAX's step on Mesh(devs[:4]) and against the port's
one-process step (NeRF MLP in float64, and the CP field); the CP step on a
2 × 2 ``make_mesh_2d`` against the 1-D mesh; stage 2 with the toy
guidance of tests/test_parallel.py; tensor parallelism of the tiny SD
stack (the sharded leaves, the bytes a rank holds, the SDS loss and its
image gradient); the 2-rank LoRA step; run.py under torchrun on two ranks
and the resume of its checkpoint in one process (and back).

Tolerances, with their reasons:
- N ranks against one process of the port: the same arithmetic in
  another order of summation. Float64 MLP: rtol 1e-10 (atol 1e-10·max for
  entries that cancel); the bf16 CP field: the loss to rtol 1e-6, the
  gradients to rtol 3e-2, atol 5e-3·max (tests/test_field_bwd.py:41-61:
  a gradient summed over other row sets rounds its bf16 operands
  otherwise); the 2 × 2 mesh against the 1-D one: bit-equal (the same rows
  on the same ranks);
- the port against the JAX package: float64 MLP, rtol 1e-6 with atol
  1e-6·max, as tests/test_torch_train.py (flax's NeRFMLP returns f32 even
  under x64, so every term carries an f32 rounding); the CP field as
  above with the loss to rtol 1e-3; the gradients are read from optax's
  first moment (μ = 0.1·g after one step);
- SDS on the tiny stack, tensor-parallel against one process: the loss
  to rtol 1e-4 and the image gradient to atol 3e-4·max
  (tests/test_torch_sds.py's port-vs-JAX tolerances: the sharded layers
  sum the input's cotangent over the ranks in another order);
- LoRA, N ranks against one process: the loss to rtol 1e-6, the adapter
  gradients to rtol 1e-3 with atol 3e-3·max over all adapters: f32
  throughout, and each rank's sum over its samples, then the sum over the
  ranks, reassociates a gradient that the UNet's backward (random tiny
  weights) builds from terms far larger than their sum.
The JAX package's SDS and LoRA steps are held against the port's
one-process steps by tests/test_torch_sds.py and tests/test_torch_lora.py
(the same stacks and draws); their jit here would double this file's time.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh

from gbnerf_tpu.config import Config as JConfig
from gbnerf_tpu.config import (DataConfig, FieldConfig, GuidanceConfig,
                               RenderConfig, TrainConfig)
from gbnerf_tpu.core.fields import NeRFMLP as JNeRFMLP
from gbnerf_tpu.parallel.mesh import make_mesh_2d as j_make_mesh_2d
from gbnerf_tpu.parallel.mesh import shard_batch as j_shard_batch
from gbnerf_tpu.parallel.tp import tp_param_specs as j_tp_param_specs
from gbnerf_tpu.train import state as jstate
from gbnerf_tpu.train import step as jstep
from gbnerf_tpu_torch import config as tconfig
from gbnerf_tpu_torch import convert
from gbnerf_tpu_torch.core.fields import NeRFMLP as TNeRFMLP
from gbnerf_tpu_torch.parallel.mesh import RowShard
from gbnerf_tpu_torch.parallel.tp import tp_param_specs
from gbnerf_tpu_torch.tools import parallel_check as pc
from gbnerf_tpu_torch.train import state as tstate

from _sd_pair import draws as sd_draws

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
NEAR, FAR = 0.5, 4.0
N_RAND = 24
LR_S = 64                       # the tiny SD stack's image side


class x64:
    """JAX float64 for the duration of a with-block."""

    def __enter__(self):
        jax.config.update("jax_enable_x64", True)

    def __exit__(self, *exc):
        jax.config.update("jax_enable_x64", False)


def port_cfg(jcfg):
    """The port's Config of the same fields (the two packages' configs are
    copies: tests/test_torch_config.py)."""
    return tconfig.Config(**{
        f.name: getattr(tconfig, type(getattr(jcfg, f.name)).__name__)(
            **dataclasses.asdict(getattr(jcfg, f.name)))
        for f in dataclasses.fields(jcfg)})


def torchrun(cases, tmp: Path, nproc: int):
    """Run parallel_check's cases on nproc CPU ranks → their results."""
    spec, out = tmp / "spec.pt", tmp / "out.pt"
    torch.save({"cases": cases, "out": str(out)}, spec)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc_per_node={nproc}", "-m",
         "gbnerf_tpu_torch.tools.parallel_check", str(spec), "--device",
         "cpu"], env=env, cwd=tmp, capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    return torch.load(out, weights_only=False)


def close_tree(got: dict, ref: dict, rtol: float, atol_frac: float,
               what: str = "") -> None:
    assert got.keys() == ref.keys(), (what, got.keys() ^ ref.keys())
    for k in ref:
        g = got[k].double().numpy() if hasattr(got[k], "numpy") else got[k]
        r = ref[k].double().numpy() if hasattr(ref[k], "numpy") else ref[k]
        r = np.asarray(r, np.float64)
        np.testing.assert_allclose(
            g, r, rtol=rtol, atol=atol_frac * max(np.abs(r).max(), 1e-30),
            err_msg=f"{what}{k}")


# ---------------- inputs ----------------

def _stream(rng, n, width):
    o = rng.standard_normal((n, 3)) * 0.3
    d = rng.standard_normal((n, 3)) * rng.uniform(0.5, 1.5, (n, 1))
    tgt = rng.random((n, width))
    if width == 2:
        tgt[:, 0] = rng.uniform(1.5, 3.5, n)
    return {"o": o, "d": d, "target": tgt}


def _banks(rng, n=64):
    return {"rgb_clf": _stream(rng, n, 3), "inp": _stream(rng, n, 1),
            "depth": _stream(rng, n, 2)}


def _torch_tree(tree, dtype):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _torch_tree(v, dtype) for k, v in tree.items()}
    a = np.asarray(tree)
    return torch.from_numpy(a.astype(dtype) if a.dtype.kind == "f" else a)


def _stage1_idx(key, banks):
    """The JAX stage-1 step's batch indices from its key."""
    k_batch, _ = jax.random.split(key)
    ks = jax.random.split(k_batch, 3)
    return {name: torch.from_numpy(np.asarray(jax.random.randint(
        k, (N_RAND,), 0, banks[b]["o"].shape[0]))).long()
        for name, b, k in zip(("clf", "inp", "depth"),
                              ("rgb_clf", "inp", "depth"), ks)}


MLP = dict(depth=2, width=32, multires=4, multires_views=2)


def _mlp_fields(seed_c, seed_f):
    """The NeRF MLP pair in float64: flax params and the port's state
    dicts of the same weights."""
    out = {}
    for name, seed in (("coarse", seed_c), ("fine", seed_f)):
        jm = JNeRFMLP(compute_dtype=jnp.float64, **MLP)
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                jnp.zeros((2, 3)), jnp.zeros((2, 3)))
        rng = np.random.default_rng(seed)
        p = jax.tree_util.tree_map(
            lambda s: rng.standard_normal(s.shape) / np.sqrt(
                s.shape[0] if len(s.shape) == 2 else 10.0),
            shapes["params"])
        tm = TNeRFMLP(compute_dtype=torch.float64, **MLP).double()
        convert.load_jax_params(tm, p)
        out[name] = (jm, p, tm.state_dict())
    return out


def _mlp_cfg(**train):
    return JConfig(
        field=FieldConfig(no_tcnn=True, netdepth=2, netwidth=32,
                          netdepth_fine=2, netwidth_fine=32, multires=4,
                          multires_views=2),
        render=RenderConfig(N_samples=9, N_importance=5, perturb=0.0,
                            raw_noise_std=0.0, lindisp=False,
                            white_bkgd=True),
        data=DataConfig(depth_lambda=0.1, sdepth_lambda=0.05),
        train=TrainConfig(N_rand=N_RAND, first_stage=True, **train))


def _cp_cfg():
    return JConfig(
        field=FieldConfig(cp_resolutions=(5, 9, 17), cp_rank=4, cp_bound=3.0),
        render=RenderConfig(N_samples=16, N_importance=16, lindisp=True,
                            white_bkgd=True, perturb=0.0, raw_noise_std=0.0),
        data=DataConfig(depth_lambda=0.1, sdepth_lambda=0.1),
        train=TrainConfig(N_rand=N_RAND, sigma_loss_weight=0.05,
                          tv_loss_weight=1e-3, first_stage=True))


def _jax_mu_grads(opt_state):
    """g = μ / (1 − β1) after optax.adam's first update."""
    mu = opt_state[0].mu
    return {n: {k: np.asarray(v) / 0.1 for k, v in
                convert.field_state_dict(mu[n]).items()} for n in mu}


def _stage1_mlp_inputs():
    rng = np.random.default_rng(1)
    banks = _banks(rng)
    cfg = _mlp_cfg(sigma_loss_weight=0.2)
    key = jax.random.PRNGKey(5)
    with x64():
        pair = _mlp_fields(1, 2)
        params = {n: p for n, (_, p, _) in pair.items()}
        tx = jstate.make_optimizer(cfg)
        state = jstate.TrainState(jnp.zeros((), jnp.int32), params,
                                  tx.init(params))
        step = jstep.make_train_step_stage1(
            cfg, pair["coarse"][0], pair["fine"][0], NEAR, FAR,
            mesh=Mesh(np.asarray(jax.devices()[:4]), ("data",)))
        s1, m = step(state, jax.tree_util.tree_map(jnp.asarray, banks), key)
        ref = {"loss": float(m["loss"]),
               "metrics": {k: float(v) for k, v in m.items()},
               "grads": _jax_mu_grads(s1.opt_state)}
        idx = _stage1_idx(key, banks)      # x64: int64 draws
    case = {"kind": "stage1", "cfg": port_cfg(cfg), "near": NEAR,
            "far": FAR, "banks": _torch_tree(banks, np.float64),
            "idx": idx, "float64": True,
            "fields": {n: sd for n, (_, _, sd) in pair.items()}}
    return case, ref


def _stage1_cp_inputs():
    rng = np.random.default_rng(2)
    banks = _banks(rng)
    cfg = _cp_cfg()
    st, tc, tf = tstate.create_train_state(port_cfg(cfg),
                                           torch.Generator().manual_seed(0))
    params = jax.tree_util.tree_map(jnp.asarray, convert.params_to_jax(
        {"coarse": tc.state_dict(), "fine": tf.state_dict()}))
    tx = jstate.make_optimizer(cfg)
    state = jstate.TrainState(jnp.zeros((), jnp.int32), params,
                              tx.init(params))
    key = jax.random.PRNGKey(6)
    step = jstep.make_train_step_stage1(
        cfg, jstate.build_field(cfg, fine=False),
        jstate.build_field(cfg, fine=True), NEAR, FAR,
        mesh=Mesh(np.asarray(jax.devices()[:4]), ("data",)))
    s1, m = step(state, jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float32), banks), key)
    ref = {"loss": float(m["loss"]),
           "metrics": {k: float(v) for k, v in m.items()},
           "grads": _jax_mu_grads(s1.opt_state)}
    case = {"kind": "stage1", "cfg": port_cfg(cfg), "near": NEAR,
            "far": FAR, "banks": _torch_tree(banks, np.float32),
            "idx": _stage1_idx(key, banks), "repeat": True,
            "fields": {"coarse": tc.state_dict(), "fine": tf.state_dict()}}
    return case, ref


STAGE2_HWF = (12, 16, 14.0)


def _stage2_inputs():
    """tests/test_parallel.py::test_stage2_step_sharded_matches_unsharded's
    problem (toy guidance on the composite and the normal map), MLP in
    float64, the selection draws of the JAX step's key injected."""
    H, W, focal = STAGE2_HWF
    rng = np.random.default_rng(3)
    n_img, K = 2, 16
    cfg = dataclasses.replace(
        _mlp_cfg(), train=TrainConfig(N_rand=N_RAND),
        guidance=GuidanceConfig(is_rgb_guidance=True,
                                is_normal_guidance=True,
                                normal_start_iter=0,
                                normalmap_render_factor=4))
    scene = {
        "images": rng.random((n_img, H, W, 3)),
        "masks": (rng.random((n_img, H, W)) < 0.3).astype(np.float64),
        "mask_coords": np.stack([rng.integers(0, W, (n_img, K)),
                                 rng.integers(0, H, (n_img, K))], -1),
        "mask_valid": np.ones((n_img, K), bool),
        "poses": np.tile(np.eye(4)[None, :3, :4], (n_img, 1, 1))}
    banks = _banks(rng)

    def toy(step_i, combin, normal_map, mask, rng, **kw):
        loss = jnp.mean(combin ** 2)
        if normal_map is not None:
            loss = loss + jnp.mean(normal_map ** 2)
        return loss

    key = jax.random.PRNGKey(8)
    with x64():
        pair = _mlp_fields(3, 4)
        params = {n: p for n, (_, p, _) in pair.items()}
        tx = jstate.make_optimizer(cfg)
        state = jstate.TrainState(jnp.zeros((), jnp.int32), params,
                                  tx.init(params))
        step = jstep.make_train_step_stage2(
            cfg, pair["coarse"][0], pair["fine"][0], NEAR, FAR,
            hwf=STAGE2_HWF, guidance_fn=toy,
            mesh=Mesh(np.asarray(jax.devices()[:4]), ("data",)))
        s1, m = step(state, jax.tree_util.tree_map(jnp.asarray, scene),
                     jax.tree_util.tree_map(jnp.asarray, banks), key)
        ref = {"loss": float(m["loss"]),
               "metrics": {k: float(v) for k, v in m.items()},
               "grads": _jax_mu_grads(s1.opt_state)}
        k_sel, _ = jax.random.split(key)
        k_img, k_clf, k_inp, k_dep, _ = jax.random.split(k_sel, 5)
        idx = {"img": int(jax.random.randint(k_img, (), 0, n_img))}
        for name, b, k in (("clf", "rgb_clf", k_clf), ("inp", "inp", k_inp),
                           ("depth", "depth", k_dep)):
            idx[name] = torch.from_numpy(np.asarray(jax.random.randint(
                k, (N_RAND,), 0, banks[b]["o"].shape[0]))).long()
    case = {"kind": "stage2", "cfg": port_cfg(cfg), "near": NEAR,
            "far": FAR, "hwf": STAGE2_HWF, "guidance": "toy",
            "scene_dev": _torch_tree(scene, np.float64),
            "banks": _torch_tree(banks, np.float64), "idx": idx,
            "float64": True,
            "fields": {n: sd for n, (_, _, sd) in pair.items()}}
    return case, ref


TINY_SD = {"sd": "tiny", "seed": 4, "latent_size": LR_S}


def _sd_step_case():
    """The SDS step of tests/test_parallel.py:240-288 (csd at step 700,
    64², the draws of PRNGKey(5)) on the port's tiny stack."""
    rng = np.random.default_rng(5)
    return {"kind": "sd_step", "guidance": dict(TINY_SD, tp=True),
            "step_i": 700,
            "rgb": torch.from_numpy(rng.random((LR_S, LR_S, 3),
                                               dtype=np.float32)),
            "mask": torch.from_numpy((rng.random((LR_S, LR_S)) > 0.6
                                      ).astype(np.float32)),
            "draws": sd_draws(jax.random.PRNGKey(5), LR_S // 8)}


def _lora_case(B, prior):
    g = torch.Generator().manual_seed(B)
    lr_res = LR_S // 8
    batch = {"image": torch.randint(0, 256, (B, LR_S, LR_S, 3), generator=g,
                                    dtype=torch.uint8),
             "mask": (torch.rand((B, LR_S, LR_S), generator=g) > 0.5
                      ).to(torch.uint8),
             "instance_mask": (torch.rand((B, LR_S, LR_S), generator=g)
                               > 0.5).to(torch.uint8),
             "embeds": torch.randn((B, 77, 32), generator=g)}
    shape = (B, lr_res, lr_res, 4)
    draws = {"t": torch.randint(0, 1000, (B,), generator=g),
             "noise": torch.randn(shape, generator=g),
             "enc_eps": torch.randn(shape, generator=g),
             "enc_masked_eps": torch.randn(shape, generator=g)}
    return {"kind": "lora", "guidance": TINY_SD, "seed": 7, "batch": batch,
            "draws": draws,
            "lora_kw": dict(rank=4, lr=1e-3, masked_loss=True,
                            prior_preservation=prior, prior_loss_weight=0.7)}


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The 4-rank cases in one torchrun, with their JAX references."""
    made = {"mlp": _stage1_mlp_inputs(), "cp": _stage1_cp_inputs(),
            "stage2": _stage2_inputs()}
    sd, lora2, lora4 = _sd_step_case(), _lora_case(4, False), \
        _lora_case(6, True)
    grid = dict(mesh=(2, 2), mesh_axes=("data", "model"))
    cases = [dict(made["mlp"][0], mesh=(4,)), dict(made["cp"][0], mesh=(4,)),
             dict(made["cp"][0], mesh=(2, 2), mesh_axes=("dcn", "data"),
                  axis=("dcn", "data"), repeat=False),
             dict(made["stage2"][0], mesh=(4,)),
             dict(sd, **grid), dict(lora2, **grid),
             dict(lora4, mesh=(4,))]
    res = torchrun(cases, tmp_path_factory.mktemp("four"), 4)
    return {"mlp": (made["mlp"], res[0]), "cp": (made["cp"], res[1]),
            "cp2d": res[2], "stage2": (made["stage2"], res[3]),
            "sd": (sd, res[4]), "lora2": (lora2, res[5]),
            "lora4": (lora4, res[6])}


# ---------------- the rank slices ----------------

@pytest.mark.parametrize("shape,axes", [((4,), ("data",)),
                                        ((2, 2), ("dcn", "data"))])
def test_rank_slices_are_jax_shard_batch_shards(shape, axes):
    """RowShard's rows of rank r (row-major over a 2-D mesh) are the shard
    JAX's shard_batch places on device r of the same mesh."""
    n = 24
    x = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    devs = np.asarray(jax.devices()[:4]).reshape(shape)
    jmesh = (Mesh(devs, axes) if len(shape) == 1
             else j_make_mesh_2d(shape[0], shape[1], axes=axes))
    arr = j_shard_batch(jmesh, x, axis=axes if len(shape) > 1 else axes[0])
    shards = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
    for r, dev in enumerate(jmesh.devices.flat):
        got = RowShard(n, r, 4).take(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, shards[dev])
    # ragged: every rank holds the same count, the tail padded with the
    # last row
    parts = [RowShard(10, r, 4).take(torch.arange(10)) for r in range(4)]
    assert [p.tolist() for p in parts] == [[0, 1, 2], [3, 4, 5], [6, 7, 8],
                                          [9, 9, 9]]


# ---------------- stage 1 ----------------

def test_stage1_four_ranks_match_jax_mesh_step_mlp_f64(four_ranks):
    (case, ref), got = four_ranks["mlp"]
    assert got["world"] == 4
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-6)
    for k in ("img_loss", "depth_loss", "col_loss", "sigma_loss"):
        assert ref["metrics"][k] != 0.0, k
        np.testing.assert_allclose(got["metrics"][k], ref["metrics"][k],
                                   rtol=1e-6, err_msg=k)
    for n in ref["grads"]:
        close_tree(got["grads"][n], ref["grads"][n], 1e-6, 1e-6, f"{n}.")
    one = pc.run_case(case, "cpu")
    np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-10)
    for n in one["grads"]:
        close_tree(got["grads"][n], one["grads"][n], 1e-10, 1e-10, f"{n}.")
        close_tree(got["params"][n], one["params"][n], 1e-10, 1e-10, f"{n}.")


def test_stage1_four_ranks_match_jax_mesh_step_cp(four_ranks):
    (case, ref), got = four_ranks["cp"]
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-3)
    for k in ("img_loss", "depth_loss", "col_loss", "sigma_loss"):
        np.testing.assert_allclose(got["metrics"][k], ref["metrics"][k],
                                   rtol=1e-3, err_msg=k)
    for n in ref["grads"]:
        close_tree(got["grads"][n], ref["grads"][n], 3e-2, 5e-3, f"{n}.")
    one = pc.run_case(case, "cpu")
    np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-6)
    for n in one["grads"]:
        close_tree(got["grads"][n], one["grads"][n], 3e-2, 5e-3, f"{n}.")
    assert got["repeat_equal"] and one["repeat_equal"]


def test_stage1_on_a_2x2_mesh_equals_the_1d_mesh(four_ranks):
    """make_mesh_2d(2, 2) with the batch over ("dcn", "data") puts the
    rows of the 1-D mesh on the same ranks: the same step, bit for bit."""
    (_, _), flat = four_ranks["cp"]
    grid = four_ranks["cp2d"]
    assert grid["loss"] == flat["loss"]
    for n in flat["grads"]:
        for k, v in flat["grads"][n].items():
            assert torch.equal(grid["grads"][n][k], v), (n, k)


def test_stage2_four_ranks_match_jax_mesh_step_toy_guidance(four_ranks):
    (case, ref), got = four_ranks["stage2"]
    assert ref["metrics"]["sds_loss"] > 0
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-6)
    for k in ("img_loss", "depth_loss", "sds_loss"):
        np.testing.assert_allclose(got["metrics"][k], ref["metrics"][k],
                                   rtol=1e-6, err_msg=k)
    for n in ref["grads"]:
        close_tree(got["grads"][n], ref["grads"][n], 1e-6, 1e-6, f"{n}.")
    one = pc.run_case(case, "cpu")
    np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-10)
    for n in one["grads"]:
        close_tree(got["grads"][n], one["grads"][n], 1e-10, 1e-10, f"{n}.")


# ---------------- tensor-parallel guidance ----------------

def test_tp_shards_the_jax_packages_leaves():
    """tp_param_specs shards exactly the leaves the JAX package's does (by
    convert.tp_names_from_jax), on the UNet and the VAE, at n 2 and 4."""
    from gbnerf_tpu.guidance import unet as junet, vae as jvae
    from gbnerf_tpu_torch.guidance.unet import UNet2DCondition, UNetConfig
    from gbnerf_tpu_torch.guidance.vae import AutoencoderKL, VAEConfig

    pairs = (
        (junet.UNet2DCondition(junet.UNetConfig.tiny()),
         (jnp.zeros((1, 8, 8, 9)), jnp.zeros((1,)), jnp.zeros((1, 77, 32))),
         UNet2DCondition(UNetConfig.tiny())),
        (jvae.AutoencoderKL(jvae.VAEConfig.tiny()),
         (jnp.zeros((1, 64, 64, 3)),), AutoencoderKL(VAEConfig.tiny())))
    for jm, args, tm in pairs:
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                *args)["params"]
        for n in (2, 4):
            want = convert.tp_names_from_jax(j_tp_param_specs(shapes, n))
            got = {k for k, v in tp_param_specs(tm, n).items()
                   if v is not None}
            assert want and got == want, (n, got ^ want)


def test_tp_guidance_step_matches_unsharded(four_ranks):
    """The SDS step with the UNet and VAE out-channel-sharded over the
    model axis of a (data, model) = 2 × 2 mesh: the unsharded loss and
    image gradient, and each rank holds less than 0.9 of the UNet."""
    case, got = four_ranks["sd"]
    one = pc.run_case(case, "cpu")
    assert np.isfinite(got["loss"]) and float(got["grad"].abs().max()) > 0
    np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-4)
    close_tree({"g": got["grad"]}, {"g": one["grad"]}, 1e-4, 3e-4)
    assert got["unet_bytes_max"] < 0.9 * one["unet_bytes_max"], (
        got["unet_bytes_max"], one["unet_bytes_max"])


# ---------------- LoRA ----------------

@pytest.mark.parametrize("which", ["lora2", "lora4"])
def test_lora_data_parallel_matches_one_process(four_ranks, which):
    """2-way (the data axis of a 2 × 2 mesh; 4 samples) and 4-way (6
    samples under prior preservation: ragged rows, a rank across the
    instance/class halves) against one process. The one-process step is
    held against the JAX package by tests/test_torch_lora.py."""
    case, got = four_ranks[which]
    one = pc.run_case(case, "cpu")
    np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-6)
    gmax = max(float(v.abs().max()) for v in one["grads"].values())
    assert gmax > 0
    for k, v in one["grads"].items():
        np.testing.assert_allclose(got["grads"][k].numpy(), v.numpy(),
                                   rtol=1e-3, atol=3e-3 * gmax, err_msg=k)


# ---------------- run.py under torchrun ----------------

def test_run_py_under_torchrun_two_ranks_and_resume_across_world_sizes(
        tmp_path):
    """One process trains 2 steps; two CPU ranks under torchrun resume its
    checkpoint to step 4 (the [mesh] line, rank 0 alone writing metrics
    and checkpoints); one process resumes theirs to step 6."""
    from gbnerf_tpu_torch import run as trun

    scene = tmp_path / "scene"
    subprocess.run([sys.executable, str(ROOT / "tools" /
                                        "make_synthetic_scene.py"),
                    str(scene), "--n_train", "3", "--n_test", "1", "--H",
                    "16", "--W", "20"], check=True, capture_output=True,
                   timeout=120)
    cfg = tmp_path / "cfg.txt"
    cfg.write_text("\n".join([
        "expname = dp", f"basedir = {tmp_path / 'logs'}",
        f"datadir = {scene}", "dataset_type = llff", "factor = 4",
        "cp_resolutions = 5,9,17", "cp_rank = 4", "cp_bound = 3.0",
        "N_rand = 32", "N_samples = 8", "N_importance = 8",
        "no_ndc = True", "white_bkgd = True", "first_stage = True",
        "colmap_depth = False", "i_print = 1", "i_weights = 2",
        "i_video = 100", "i_evaluate = 100", "i_testset = 100"]) + "\n")
    exp = tmp_path / "logs" / "dp"

    def args(n):
        return ["--config", str(cfg), "--device", "cpu", "--set",
                "data.test_split_count=1", "--set", f"train.N_iters={n}"]

    assert trun.main(args(2)) == 0
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "torch.distributed.run",
                        "--standalone", "--nproc_per_node=2", "-m",
                        "gbnerf_tpu_torch.run", *args(4)], env=env,
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    assert r.stdout.count("[mesh] data-parallel over 2 devices") == 1
    assert r.stdout.count("[ckpt] resumed at iter 2") == 1
    assert "rank 1 of 2 (gloo)" in r.stdout
    iters = [json.loads(line)["iter"] for line in
             open(exp / "metrics.jsonl")]
    assert iters == [1, 2, 3, 4], iters          # one writer
    assert sorted(os.listdir(exp / "ckpt")) == ["2.pt", "4.pt"]
    assert trun.main(args(6)) == 0
    assert sorted(os.listdir(exp / "ckpt")) == ["2.pt", "4.pt", "6.pt"]
    iters = [json.loads(line)["iter"] for line in
             open(exp / "metrics.jsonl")]
    assert iters == [1, 2, 3, 4, 5, 6], iters


def _halves_step(make_step):
    """make_lora_train_step whose step takes its batch as two ranks do: the
    whole batch's draws, then each half's loss and gradient, averaged. A
    UNet forward at 2 rows rounds otherwise than at 4 (CPU GEMMs block by
    row count), so one process at 4 rows differs from the ranks by
    round-off, which the tiny random UNet's cancellations amplify."""
    from gbnerf_tpu_torch.train import lora_trainer as lt

    def make(mods, **kw):
        init_fn, step = make_step(mods, **kw)

        def split_step(adapters, optimizer, batch, generator=None,
                       draws=None):
            img = batch["image"]
            B = img.shape[0]
            draws = lt.draw_step(generator, B, img.shape[1] // 8, img.device,
                                 mods.schedule.num_train_timesteps,
                                 mods.vae.quant_conv.weight.dtype)
            optimizer.zero_grad(set_to_none=True)
            total = 0.0
            for rows in (slice(0, B // 2), slice(B // 2, B)):
                half = {k: None if v is None else v[rows]
                        for k, v in batch.items()}
                loss = step.loss_fn(adapters, half, {k: v[rows] for k, v
                                                     in draws.items()}) / 2
                loss.backward()
                total = total + loss.detach()
            optimizer.step()
            return {"loss": total}

        return init_fn, split_step

    return make


def test_train_lora_under_torchrun_splits_the_batch(tmp_path, monkeypatch):
    """The LoRA CLI on two CPU ranks against one process: the [lora] mesh
    line once, the adapter file and the checkpoint written once, by rank 0.
    The one process takes its batch of 4 as the ranks do, in halves of 2
    whose gradients it averages (_halves_step), so both sides round alike
    and the check is of the sharding and the averaging. Step 1 from the
    same init: the adapters entry by entry. Step 2 resumed from one
    process's checkpoint-1 (across world sizes, so both ranks and the one
    process step from the same adapters, with B ≠ 0 and so a nonzero
    gradient of A): the all-reduced adapter gradients, read from AdamW's
    first moment, leaf by leaf, and the adapters entry by entry."""
    import shutil

    from gbnerf_tpu_torch import train_lora
    from gbnerf_tpu_torch.guidance.weights import read_safetensors
    from gbnerf_tpu_torch.train import lora_trainer as lt
    from gbnerf_tpu_torch.train.lora_trainer import _flat
    from gbnerf_tpu_torch.utils import msgpack
    from gbnerf_tpu_torch.utils.png import write_png

    data = tmp_path / "imgs"
    data.mkdir()
    rng = np.random.default_rng(0)
    for i in range(3):
        write_png(str(data / f"{i}.png"),
                  rng.integers(0, 256, (48, 48, 3), dtype=np.uint8))
        (data / f"{i}.txt").write_text(f"a thing {i}")

    def args(out, steps):
        return ["--instance_data_dir", str(data), "--output_dir", str(out),
                "--tiny", "--max_train_steps", str(steps),
                "--train_batch_size", "4", "--checkpointing_steps", "1",
                "--rank", "4", "--device", "cpu"]

    def two_ranks(out, steps, *extra):
        env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
        r = subprocess.run([sys.executable, "-m", "torch.distributed.run",
                            "--standalone", "--nproc_per_node=2", "-m",
                            "gbnerf_tpu_torch.train_lora",
                            *args(out, steps), *extra], env=env,
                           cwd=tmp_path, capture_output=True, text=True,
                           timeout=300)
        assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
        assert r.stdout.count("[lora] data-parallel over 2 devices") == 1
        assert r.stdout.count("[lora] saved") == 1
        return r.stdout

    one, dp1, dp2 = tmp_path / "one", tmp_path / "dp1", tmp_path / "dp2"
    monkeypatch.setattr(lt, "make_lora_train_step",
                        _halves_step(lt.make_lora_train_step))
    train_lora.main(args(one, 2))
    monkeypatch.undo()
    two_ranks(dp1, 1)
    assert sorted(os.listdir(dp1)) == ["checkpoint-1",
                                       "lora_000001.safetensors"]
    shutil.copytree(one / "checkpoint-1", dp2 / "checkpoint-1")
    out = two_ranks(dp2, 2, "--resume_from_checkpoint", "latest")
    assert out.count("[lora] resumed from") == 1
    assert "checkpoint-1 at step 1" in out
    assert sorted(os.listdir(dp2)) == [
        "checkpoint-1", "checkpoint-2", "lora_000002.safetensors"]

    def diff(got_dir, step):
        name = f"lora_{step:06d}.safetensors"
        got = read_safetensors(str(got_dir / name))
        ref = read_safetensors(str(one / name))
        assert got.keys() == ref.keys()
        return np.concatenate([np.abs(got[k].numpy()
                                      - ref[k].numpy()).ravel()
                               for k in ref])

    # each AdamW step moves an entry by about ±lr = 1e-4 times its
    # gradient's sign, so an entry whose gradient is near 0 and whose sign
    # the reassociation across ranks flips (see the LoRA tolerance above)
    # can end 2·lr apart a step; all others agree closely
    for d in (diff(dp1, 1), diff(dp2, 2)):
        assert d.max() <= 2e-4 * (1 + 1e-3), d.max()
        assert np.mean(d <= 1e-5) >= 0.99, np.mean(d <= 1e-5)

    # step 2's gradient g2 = (μ2 − 0.9·μ1) / 0.1, from the same μ1: the
    # LoRA tolerance above entry by entry, and cosine ≥ 0.999 a leaf
    def mu(path):
        return _flat(msgpack.load(str(path / "state.msgpack"))
                     ["opt"]["0"]["mu"])

    mu1 = mu(one / "checkpoint-1")
    g_one, g_dp = [{k: (np.float64(v) - 0.9 * np.float64(mu1[k])) / 0.1
                    for k, v in mu(d / "checkpoint-2").items()}
                   for d in (one, dp2)]
    assert g_dp.keys() == g_one.keys()
    gmax = max(np.abs(v).max() for v in g_one.values())
    assert gmax > 0 and any(np.abs(v).max() > 0 for k, v in g_one.items()
                            if k.endswith("lora_A"))
    for k, ref in g_one.items():
        got = g_dp[k]
        np.testing.assert_allclose(got, ref, rtol=1e-3, atol=3e-3 * gmax,
                                   err_msg=k)
        norms = np.linalg.norm(got) * np.linalg.norm(ref)
        if norms == 0:
            assert not got.any() and not ref.any(), k
        else:
            assert np.sum(got * ref) / norms >= 0.999, k
