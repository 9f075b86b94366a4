"""Whole runs of the port against the JAX package from the same seed, with
the JAX package's draws replayed (utils/jax_random.py) and its initial
parameters recomputed (utils/jax_init.py): stage 1's train step, stage 2's
loop with the tiny random prior (score distillation, the LPIPS patch
loss), and the tiny-prior trainer. Each case also runs with the port's
own torch draws, which must fail the same check: that shows the check sees
the draws.

Tolerances, with their reasons:
- stage 1, f64 ``NeRFMLP`` (the pipeline: draws, render, losses, Adam),
  5 steps: each step's loss at rtol 1e-6 and the parameters after the
  last step at 1e-5 · max |leaf|. The initial values agree within 4 f32
  ulp (test_torch_jax_random.py), and the field's output is f32 in both
  packages (tests/test_torch_train.py); the f64 rest keeps that below
  these bounds;
- stage 2, bf16 CP fields and the tiny SD stack in f32, 3 steps through
  both loops: each step's loss at rtol 1e-3, and the parameters' updates
  (after − before) at cosine 0.999 per leaf, the step bound of
  chip_smoke.py. Both sides round every field matmul operand to bf16 and
  sum in other orders (tests/test_field_bwd.py's bf16 tolerances, rtol
  3e-2 and atol 5e-3 · max, hold per element on ≥ 98 % of them);
- the tiny-prior trainer, 5 VAE and 5 UNet steps (chunk 1: a logged loss
  after each): the logged losses at rtol 1e-2, the written prior's VAE
  reconstruction of fixed images at 1e-2 · max and its UNet's prediction
  on fixed inputs at 0.2 · max. Adam's first steps move every element by
  ± lr whatever the size of its gradient, and in the UNet the gradients
  of the biases and time projections ahead of a GroupNorm are f32
  rounding noise (≤ 4e-9 against 0.1 elsewhere): those elements take
  random signs in each package, which moves the prediction by ≈ 8 % of
  its range after 5 steps (the VAE phase's losses agree to the 4 printed
  decimals). With torch's draws the same checks miss by 0.7, 1.8 and 1.5.

The stage-2 and prior cases run a UNet cut below ``UNetConfig.tiny()``
(``_micro_unet``: two levels of one layer, the tiny widths, every block
kind of the tiny one), in both packages alike: they hold the wiring of the
loops, and the JAX package's trace and compile of the tiny UNet's
backward alone would take most of a minute. The tiny UNet's init is held
to flax's by test_torch_jax_random.py, its forward to the JAX UNet's by
test_torch_guidance.py.
"""
import glob
import os
import shutil
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gbnerf_tpu import config as jcfg
from gbnerf_tpu.core.fields import NeRFMLP as JNeRFMLP
from gbnerf_tpu.train import state as jstate
from gbnerf_tpu.train import step as jstep
from gbnerf_tpu_torch import config as tcfg
from gbnerf_tpu_torch import convert
from gbnerf_tpu_torch.core.fields import NeRFMLP as TNeRFMLP
from gbnerf_tpu_torch.train import state as tstate
from gbnerf_tpu_torch.train import step as tstep
from gbnerf_tpu_torch.utils import jax_init as ji
from gbnerf_tpu_torch.utils import jax_random as jr

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class x64:
    """JAX float64 for the duration of a with-block."""

    def __enter__(self):
        jax.config.update("jax_enable_x64", True)

    def __exit__(self, *exc):
        jax.config.update("jax_enable_x64", False)


def _micro_unet(in_channels: int = 9):
    return dict(in_channels=in_channels, block_out_channels=(32, 64),
                layers_per_block=1, attention_head_dim=2,
                cross_attention_dim=32,
                down_types=("CrossAttnDownBlock2D", "DownBlock2D"))


@pytest.fixture(scope="module", autouse=True)
def micro_unet():
    """``UNetConfig.tiny()`` gives ``_micro_unet`` in both packages for this
    module's runs (see the module's docstring)."""
    from gbnerf_tpu.guidance import unet as junet
    from gbnerf_tpu_torch.guidance import unet as tunet

    mp = pytest.MonkeyPatch()
    for mod in (junet, tunet):
        cls = mod.UNetConfig
        mp.setattr(cls, "tiny", staticmethod(
            lambda in_channels=9, cls=cls: cls(**_micro_unet(in_channels))))
    yield
    mp.undo()


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(v, np.float64)


def _worst(ref, got):
    """max over leaves of max |got − ref| / max |ref|."""
    g = dict(_flat(got))
    return max(np.abs(g[k] - r).max() / max(np.abs(r).max(), 1e-30)
               for k, r in _flat(ref))


# ---- stage 1: the train step, f64 NeRF MLP --------------------------------

MLP_KW = dict(depth=2, width=32, skips=(1,), multires=4, multires_views=2)
S1_CFG = jcfg.Config(
    field=jcfg.FieldConfig(no_tcnn=True),
    render=jcfg.RenderConfig(N_samples=16, N_importance=16, perturb=1.0,
                             raw_noise_std=0.0, lindisp=True,
                             white_bkgd=True),
    data=jcfg.DataConfig(depth_lambda=0.1, sdepth_lambda=0.05),
    train=jcfg.TrainConfig(sigma_loss_weight=0.2, first_stage=True,
                           N_rand=32, lrate=5e-3))
INIT_SEED, RUN_SEED, S1_STEPS = 3, 11, 5


def _banks():
    rng = np.random.default_rng(0)

    def stream(n, width):
        o = rng.normal(size=(n, 3)) * 0.1
        d = rng.normal(size=(n, 3))
        d[:, 2] = -np.abs(d[:, 2]) - 1.0
        tgt = rng.random((n, width))
        if width == 2:
            tgt[:, 0] = rng.uniform(1.5, 3.5, n)
        return {"o": o, "d": d, "target": tgt}

    return {"rgb_clf": stream(200, 3), "inp": stream(150, 1),
            "depth": stream(120, 2)}


@pytest.fixture(scope="module")
def jax_stage1():
    """The JAX package's 5 steps: init from PRNGKey(3) (split: coarse,
    fine), one split of PRNGKey(11) a step, as its loop makes them."""
    banks = _banks()
    with x64():
        k1, k2 = jax.random.split(jax.random.PRNGKey(INIT_SEED))
        jc = JNeRFMLP(compute_dtype=jnp.float64, **MLP_KW)
        jf = JNeRFMLP(compute_dtype=jnp.float64, **MLP_KW)
        z = jnp.zeros((2, 3))
        params = {"coarse": jc.init(k1, z, z)["params"],
                  "fine": jf.init(k2, z, z)["params"]}
        params = jax.tree_util.tree_map(
            lambda x: jnp.asarray(x, jnp.float64), params)
        tx = jstate.make_optimizer(S1_CFG)
        st = jstate.TrainState(jnp.zeros((), jnp.int32), params,
                               tx.init(params))
        step = jstep.make_train_step_stage1(S1_CFG, jc, jf, 0.5, 4.0)
        jb = jax.tree_util.tree_map(jnp.asarray, banks)
        key, losses = jax.random.PRNGKey(RUN_SEED), []
        for _ in range(S1_STEPS):
            key, sk = jax.random.split(key)
            st, m = step(st, jb, sk)
            losses.append(float(m["loss"]))
        return banks, losses, jax.tree_util.tree_map(np.asarray, st.params)


def _port_stage1(banks, draws):
    port_cfg = tcfg.Config(
        field=tcfg.FieldConfig(**vars(S1_CFG.field)),
        render=tcfg.RenderConfig(**vars(S1_CFG.render)),
        data=tcfg.DataConfig(**vars(S1_CFG.data)),
        train=tcfg.TrainConfig(**vars(S1_CFG.train)))
    tc = TNeRFMLP(compute_dtype=torch.float64, **MLP_KW)
    tf = TNeRFMLP(compute_dtype=torch.float64, **MLP_KW)
    kc, kf = jr.key_split(jr.PRNGKey(INIT_SEED, x64=True))
    ji.init_field(tc, kc).double()
    ji.init_field(tf, kf).double()
    st = tstate.TrainState(0, tc, tf, tstate.make_optimizer(
        port_cfg, list(tc.parameters()) + list(tf.parameters())))
    step = tstep.make_train_step_stage1(port_cfg, tc, tf, 0.5, 4.0)
    tb = {k: {kk: torch.from_numpy(vv) for kk, vv in v.items()}
          for k, v in banks.items()}
    key, gen, losses = jr.PRNGKey(RUN_SEED, x64=True), \
        torch.Generator().manual_seed(RUN_SEED), []
    for _ in range(S1_STEPS):
        if draws == "jax":
            key, sk = jr.split(key)
        else:
            sk = gen
        st, m = step(st, tb, sk)
        losses.append(float(m["loss"]))
    return losses, convert.params_to_jax({"coarse": tc.state_dict(),
                                          "fine": tf.state_dict()})


def _stage1_close(ref, got) -> bool:
    (rl, rp), (gl, gp) = ref, got
    return (np.allclose(gl, rl, rtol=1e-6, atol=0)
            and _worst(rp, gp) <= 1e-5)


def test_stage1_run_matches_jax_with_its_draws(jax_stage1):
    banks, losses, params = jax_stage1
    got = _port_stage1(banks, "jax")
    np.testing.assert_allclose(got[0], losses, rtol=1e-6)
    assert _worst(params, got[1]) <= 1e-5
    assert _stage1_close((losses, params), got)


def test_stage1_run_with_torch_draws_fails_the_check(jax_stage1):
    banks, losses, params = jax_stage1
    assert not _stage1_close((losses, params), _port_stage1(banks, "torch"))


# ---- stage 2: both loops, the tiny random prior ---------------------------

def _s2_cfg(mod, basedir, name):
    return mod.Config(
        field=mod.FieldConfig(cp_resolutions=(5, 9, 17), cp_rank=4,
                              cp_bound=1.5),
        render=mod.RenderConfig(N_samples=16, N_importance=16,
                                lindisp=False, white_bkgd=False, perturb=1.0,
                                raw_noise_std=1.0, render_block=512),
        data=mod.DataConfig(colmap_depth=False),
        guidance=mod.GuidanceConfig(
            sd_tiny=True, sd_latent_size=16, is_rgb_guidance=True,
            is_normal_guidance=False, cache_masked_latents=True,
            sds_loss_weight=1e-2, use_csd=False),
        train=mod.TrainConfig(
            N_iters=3, N_rand=32, first_stage=False, lpips=True,
            patch_len=32, n_patches=2, lpips_weight=0.01, i_print=1,
            i_weights=1000, i_video=1000, i_evaluate=1000, i_testset=1000,
            basedir=str(basedir), expname=name, render_factor=0, seed=5),
        # one device: the tests' virtual 8-device CPU would shard the JAX
        # loop's step over 8 (the same draws, 8 times the compile)
        mesh=mod.MeshConfig(num_devices=1))


def _twin_sd_modules(gcfg, rng, weights_dir=None, *, unet_config,
                     vae_config, text_config, latent_size, dtype):
    """The JAX package's build_sd_modules for the tiny stack, its towers'
    init from the twin (held to flax's init by test_torch_jax_random.py;
    flax's init compile of the tiny UNet alone takes ~40 s), the prompt
    embeddings by the JAX text tower."""
    from gbnerf_tpu.guidance import schedule as jsch
    from gbnerf_tpu.guidance import stable as jst
    from gbnerf_tpu.guidance import text as jtext
    from gbnerf_tpu.guidance import unet as junet
    from gbnerf_tpu.guidance import vae as jvae
    from gbnerf_tpu_torch.guidance import text as ttext
    from gbnerf_tpu_torch.guidance import unet as tunet
    from gbnerf_tpu_torch.guidance import vae as tvae

    assert weights_dir is None and dtype == jnp.float32
    tu = tunet.UNet2DCondition(tunet.UNetConfig.tiny())
    tv = tvae.AutoencoderKL(tvae.VAEConfig.tiny())
    tt = ttext.CLIPTextEncoder(ttext.CLIPTextConfig(
        **{k: getattr(text_config, k)
           for k in ("vocab_size", "width", "layers", "heads")}))
    k0, k1 = (int(x) for x in np.asarray(rng))
    ji.init_sd(tu, tv, tt, jr.JaxKey(k0, k1))
    up, vp, tp = convert.sd_params_to_jax(tu, tv, tt)
    jt = jtext.CLIPTextEncoder(text_config, dtype=jnp.float32)
    tok = jtext.Tokenizer(None, text_config.max_length,
                          text_config.vocab_size)
    apply = jax.jit(jt.apply)

    def triple(prompt):
        return apply({"params": tp}, tok(["", gcfg.negative_prompt, prompt]))

    return jst.SDModules(
        unet=junet.UNet2DCondition(unet_config, dtype=dtype),
        unet_params=up, vae=jvae.AutoencoderKL(vae_config, dtype=dtype),
        vae_params=vp, schedule=jsch.DiffusionSchedule.sd_v1(),
        embeds_rgb=triple(gcfg.prompt),
        embeds_normal=triple(gcfg.prompt_normal or gcfg.prompt),
        latent_size=latent_size, text_model=jt, text_params=tp,
        tokenizer=tok)


@pytest.fixture(scope="module")
def jax_stage2(tmp_path_factory):
    """The JAX package's loop: stage 2 from its own init, 3 steps, the SD
    stack from the loop's key split, the masked-latents cache and the
    LPIPS network from the next two."""
    import gbnerf_tpu.guidance as jguidance
    from gbnerf_tpu.train import loop as jloop

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_torch_train import _scene

    scene = _scene()
    base = tmp_path_factory.mktemp("s2")
    # the fields before the steps: the twin's init of the loop's k_init
    # (held to flax's within 4 ulp by test_torch_jax_random.py; flax's
    # eager init of the CP fields takes seconds)
    _, tc, tf = tstate.create_train_state(
        _s2_cfg(tcfg, base, "init"), jr.split(jr.PRNGKey(5))[1])
    init = convert.params_to_jax({"coarse": tc.state_dict(),
                                  "fine": tf.state_dict()})

    def twin_train_state(cfg, rng):
        assert [int(x) for x in np.asarray(rng)] == list(
            jr.split(jr.PRNGKey(5))[1].words())
        params = jax.tree_util.tree_map(jnp.asarray, init)
        return (jstate.TrainState(jnp.zeros((), jnp.int32), params,
                                  jstate.make_optimizer(cfg).init(params)),
                jstate.build_field(cfg, fine=False),
                jstate.build_field(cfg, fine=True))

    mp = pytest.MonkeyPatch()
    mp.setattr(jguidance, "build_sd_modules", _twin_sd_modules)
    mp.setattr(jloop, "create_train_state", twin_train_state)
    try:
        res = jloop.train(_s2_cfg(jcfg, base, "jax"), scene=scene)
    finally:
        mp.undo()
    return (scene, base, [h[1]["loss"] for h in res["history"]], init,
            jax.tree_util.tree_map(np.asarray, res["state"].params))


def _port_stage2(jax_run, draws):
    from gbnerf_tpu_torch.train import loop as tloop

    scene, base, *_ = jax_run
    res = tloop.train(_s2_cfg(tcfg, base, f"port_{draws}"), scene=scene,
                      device="cpu", draws=draws)
    st = res["state"]
    return ([h[1]["loss"] for h in res["history"]],
            convert.params_to_jax({"coarse": st.coarse.state_dict(),
                                   "fine": st.fine.state_dict()}))


def _update_cosines(p0, ref, got):
    g = dict(_flat(got))
    p = dict(_flat(p0))
    out = {}
    for k, r in _flat(ref):
        a, b = r - p[k], g[k] - p[k]
        out[k] = float((a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b)
                                        + 1e-300))
    return out


def _stage2_close(jax_run, got) -> bool:
    _, _, losses, p0, params = jax_run
    cos = _update_cosines(p0, params, got[1])
    return (np.allclose(got[0], losses, rtol=1e-3, atol=0)
            and min(cos.values()) >= 0.999)


def test_stage2_loop_matches_jax_with_its_draws(jax_stage2):
    _, _, losses, p0, params = jax_stage2
    got = _port_stage2(jax_stage2, "jax")
    np.testing.assert_allclose(got[0], losses, rtol=1e-3)
    cos = _update_cosines(p0, params, got[1])
    assert min(cos.values()) >= 0.999, cos
    # test_field_bwd.py's bf16 tolerance, element by element
    g = dict(_flat(got[1]))
    p = dict(_flat(p0))
    outside = []
    for k, r in _flat(params):
        a, b = r - p[k], g[k] - p[k]
        outside.append(np.mean(np.abs(b - a) >
                               5e-3 * np.abs(a).max() + 3e-2 * np.abs(a)))
    assert max(outside) <= 0.02, outside
    assert _stage2_close(jax_stage2, got)


def test_stage2_loop_with_torch_draws_fails_the_check(jax_stage2):
    assert not _stage2_close(jax_stage2, _port_stage2(jax_stage2, "torch"))


# ---- the tiny-prior trainer -------------------------------------------------

PRIOR_ARGS = ["--res", "64", "--n_domain", "4", "--steps_vae", "5",
              "--steps_unet", "5", "--batch", "2", "--chunk", "1",
              "--seed", "2"]


def _losses(text):
    return [float(line.split("loss=")[1].split()[0])
            for line in text.splitlines()
            if line.startswith(("[vae ", "[unet ")) and "loss=" in line]


@pytest.fixture(scope="module")
def jax_prior(tmp_path_factory):
    """tools/train_tiny_prior.py's main at 5 + 5 steps (chunk 1: a logged
    loss after every step), the stack's init from the twin (as stage 2)."""
    import importlib.util

    import gbnerf_tpu.guidance.stable as jst

    base = tmp_path_factory.mktemp("prior")
    out = str(base / "jax.msgpack")
    spec = importlib.util.spec_from_file_location(
        "jax_train_tiny_prior", os.path.join(ROOT, "tools",
                                             "train_tiny_prior.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    mp = pytest.MonkeyPatch()
    mp.setattr(jst, "build_sd_modules", _twin_sd_modules)
    mp.setattr(sys, "argv", ["train_tiny_prior.py", out] + PRIOR_ARGS)
    import contextlib
    import io

    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            tool.main()
    finally:
        mp.undo()
    return base, out, _losses(buf.getvalue())


def _port_prior(jax_run, draws):
    import contextlib
    import io

    from gbnerf_tpu_torch.tools import train_tiny_prior as ttool
    from gbnerf_tpu_torch.utils import msgpack as tmsgpack

    base, jout, _ = jax_run
    out = str(base / f"port_{draws}.msgpack")
    # the same domain pool (both tools cache it beside their output)
    for src in glob.glob(jout + ".domain_*.npz"):
        shutil.copy(src, out + src[len(jout):])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ttool.main([out] + PRIOR_ARGS + ["--device", "cpu", "--draws",
                                         draws])
    return _losses(buf.getvalue()), tmsgpack.load(out)


def _prior_outputs(prior):
    """The prior's VAE reconstruction of fixed images and its UNet's
    prediction on fixed inputs."""
    from gbnerf_tpu_torch.guidance.unet import UNet2DCondition, UNetConfig
    from gbnerf_tpu_torch.guidance.vae import AutoencoderKL, VAEConfig

    unet = UNet2DCondition(UNetConfig.tiny())
    unet.load_state_dict(convert.flax_to_state_dict(prior["unet"]))
    vae = AutoencoderKL(VAEConfig.tiny())
    vae.load_state_dict(convert.flax_to_state_dict(prior["vae"]))
    g = torch.Generator().manual_seed(0)
    x = torch.rand((2, 64, 64, 3), generator=g) * 2.0 - 1.0
    lat = torch.randn((2, 8, 8, 9), generator=g)
    with torch.no_grad():
        rec = vae.decode(vae.encode(x, None))
        pred = unet(lat, torch.tensor([100, 700]),
                    torch.from_numpy(np.asarray(prior["embeds_rgb"][:2])))
    return rec.numpy(), pred.numpy()


def _prior_misses(jax_run, got):
    """(loss, reconstruction, prediction) misses, each relative."""
    from gbnerf_tpu_torch.utils import msgpack as tmsgpack

    assert len(got[0]) == len(jax_run[2]) == 10
    ref_l = np.asarray(jax_run[2])
    ref = _prior_outputs(tmsgpack.load(jax_run[1]))
    out = _prior_outputs(got[1])
    return (np.max(np.abs(np.asarray(got[0]) - ref_l) / np.abs(ref_l)),
            *(np.abs(b - a).max() / np.abs(a).max()
              for a, b in zip(ref, out)))


def _prior_close(jax_run, got) -> bool:
    loss, rec, pred = _prior_misses(jax_run, got)
    return loss <= 1e-2 and rec <= 1e-2 and pred <= 0.2


def test_prior_trainer_matches_jax_with_its_draws(jax_prior):
    got = _port_prior(jax_prior, "jax")
    np.testing.assert_allclose(got[0][:5], jax_prior[2][:5], rtol=0,
                               atol=2e-4)          # the VAE phase
    assert _prior_close(jax_prior, got), _prior_misses(jax_prior, got)


def test_prior_trainer_with_torch_draws_fails_the_check(jax_prior):
    assert not _prior_close(jax_prior, _port_prior(jax_prior, "torch"))


def test_unmirrored_paths_raise_under_jax_draws(tmp_path):
    """No path is left unmirrored: the configs that refused draws='jax'
    (Perp-Neg, colla, steps_per_dispatch > 1, the bf16 SD stack) pass the
    draws' check and reach their scene load, and the ablation accepts its
    LoRA arms; an unknown kind of draws still raises before any work."""
    from gbnerf_tpu_torch.tools import run_ablation
    from gbnerf_tpu_torch.train import loop as tloop

    rgb = {"guidance": "SD", "is_rgb_guidance": True}
    for g, t in (({"perpneg": True}, {"first_stage": False}),
                 ({"is_colla_guidance": True}, {"first_stage": False}),
                 ({}, {"first_stage": True, "steps_per_dispatch": 4}),
                 (dict(rgb, sd_allow_random=True), {"first_stage": False}),
                 (dict(rgb, sd_weights_dir=str(tmp_path / "sd")),
                  {"first_stage": False})):
        cfg = tcfg.Config(
            guidance=tcfg.GuidanceConfig(**g),
            data=tcfg.DataConfig(datadir=str(tmp_path / "no_scene")),
            train=tcfg.TrainConfig(basedir=str(tmp_path / "logs"), **t))
        with pytest.raises(FileNotFoundError):
            tloop.train(cfg, device="cpu", draws="jax")
    cfg = tcfg.Config(train=tcfg.TrainConfig(basedir=str(tmp_path / "x")))
    with pytest.raises(ValueError, match="draws"):
        tloop.train(cfg, device="cpu", draws="numpy")
    assert not (tmp_path / "x").exists()   # refused before any work
    run_ablation.main([str(tmp_path / "abl"), "--production", "--colmap",
                       "--lindisp", "--combine", "sds", "--arms",
                       "s1,priorNL", "--draws", "jax", "--device", "cpu",
                       "--check"])
