"""The paths whose draws the port replays from the JAX package's key tree
since the bf16 draws and the last key trees were mirrored: bf16 bits,
uniforms and normals (utils/jax_random.py), the LoRA trainer, colla,
Perp-Neg, ``steps_per_dispatch`` > 1, the data-parallel mesh, the DDIM
inpaint and CLIP guidance's init. Each whole run is held against the JAX
package from the same seed, and each has a control with the port's own
torch draws, which must fail the same check.

Tolerances, with their reasons:
- bf16 bits and uniforms: bit for bit, in both threefry layouts (integer
  arithmetic and one bf16 rounding a step, which the twin makes as XLA's
  CPU makes it). bf16 normals: the same, and held to the acceptance bound
  (equal on > 99.9 % of draws, ≤ 1 bf16 ulp on all): a bf16 uniform takes
  one of 128 values, and the twin's f32 ``erf_inv`` rounded to bf16 equals
  jax's on each of them;
- the LoRA trainer (f32 tiny stack, the UNet cut as in
  test_torch_run_parity.py), 2 steps: the adapters' A at init within 4 f32
  ulp (test_torch_jax_random.py's bound for normals); each step's printed
  loss at rtol 1e-3 and the B adapters' AdamW first moments (the two
  steps' gradients) at cosine 0.999 per leaf, test_torch_run_parity.py's
  step bounds. A's gradient is 0 at the first step (B = 0) and at the
  second follows B's first update, which Adam makes ± lr wherever B's
  gradient is f32 rounding noise, so that two runs' A moments part
  (cosine 0.83 on one leaf); the second step is therefore also run from
  the JAX trainer's own checkpoint-1, and its gradient of every adapter,
  A's too, held at cosine 0.999 per leaf;
- stage 2 with colla, with Perp-Neg, and stage 1 with steps_per_dispatch
  2: test_torch_run_parity.py's stage-2 bounds (each step's loss at rtol
  1e-3, the parameters' updates at cosine 0.999 per leaf), 2 steps;
- the mesh: 2 gloo ranks against the JAX package's one-device step from
  the same key, at the same bounds;
- the DDIM inpaint at strength 1 and 0.6 and CLIP guidance: the draws
  (the latents' noise, the posterior ε; CLIP's towers and projection)
  within 4 f32 ulp, the outputs at rtol 1e-4 and atol 1e-5 · max
  (_sd_pair.py's bound for the tiny stack's forward).
"""
import contextlib
import dataclasses
import io
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gbnerf_tpu_torch import convert
from gbnerf_tpu_torch.utils import jax_random as jr

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))


class threefry_mode:
    def __init__(self, partitionable: bool):
        self.want = partitionable

    def __enter__(self):
        self.old = jax.config.jax_threefry_partitionable
        jax.config.update("jax_threefry_partitionable", self.want)

    def __exit__(self, *exc):
        jax.config.update("jax_threefry_partitionable", self.old)


def ulp(a, b) -> np.ndarray:
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


def bf16_ulp(a, b) -> np.ndarray:
    def ordered(x):
        i = np.asarray(x).view(np.uint16).astype(np.int64)
        return np.where(i >= 0x8000, -(i & 0x7FFF), i)
    return np.abs(ordered(a) - ordered(b))


def u16(x: torch.Tensor) -> np.ndarray:
    return x.view(torch.int16).numpy().view(np.uint16)


# ---- bf16 draws ---------------------------------------------------------

@pytest.mark.parametrize("partitionable", [True, False])
def test_bf16_bits_uniform_normal_match_jax(partitionable):
    """8-bit words (jax's bits for a bf16 uniform), bf16 uniforms over
    several bounds and bf16 normals, from several keys and shapes."""
    eq, n_all = 0, 0
    with threefry_mode(partitionable):
        for seed in (0, 7, -3, 2 ** 31 - 1):
            key = jax.random.PRNGKey(seed)
            tk = jr.PRNGKey(seed, partitionable=partitionable)
            for shape in ((), (7,), (3, 5, 2), (1001,)):
                np.testing.assert_array_equal(
                    jr.random_bits(tk, shape, bit_width=8).numpy(),
                    np.asarray(jax.random.bits(key, shape, jnp.uint8)))
                for lo, hi in ((0.0, 1.0), (-2.5, 3.7)):
                    np.testing.assert_array_equal(
                        u16(jr.uniform(tk, shape, torch.bfloat16, None, lo,
                                       hi)),
                        np.asarray(jax.random.uniform(
                            key, shape, jnp.bfloat16, lo, hi)).view(
                                np.uint16))
                ref = np.asarray(jax.random.normal(key, shape, jnp.bfloat16))
                got = u16(jr.normal(tk, shape, torch.bfloat16))
                assert bf16_ulp(got, ref).max() <= 1
                eq += int((got == ref.view(np.uint16)).sum())
                n_all += got.size
        # every one of the 128 values a bf16 normal can take
        key = jax.random.PRNGKey(11)
        ref = np.asarray(jax.random.normal(key, (20000,), jnp.bfloat16))
        got = u16(jr.normal(jr.PRNGKey(11, partitionable=partitionable),
                            (20000,), torch.bfloat16))
        assert len(np.unique(ref)) == 128
        eq += int((got == ref.view(np.uint16)).sum())
        n_all += got.size
    assert eq / n_all > 0.999


# ---- the LoRA trainer ----------------------------------------------------

MICRO_UNET = dict(in_channels=9, block_out_channels=(32, 64),
                  layers_per_block=1, attention_head_dim=2,
                  cross_attention_dim=32,
                  down_types=("CrossAttnDownBlock2D", "DownBlock2D"))
TEXT_CFG = dict(vocab_size=49408, width=32, layers=2, heads=2)


def _stacks(key_seed: int, latent: int):
    """The micro stack in both packages with the same weights: the port's
    build_sd_modules from PRNGKey(key_seed) (the JAX package's init,
    utils/jax_init.py), carried into the JAX modules; the prompt
    embeddings of the port's text tower in both."""
    from gbnerf_tpu.guidance import schedule as jsch
    from gbnerf_tpu.guidance import stable as jst
    from gbnerf_tpu.guidance import unet as junet
    from gbnerf_tpu.guidance import vae as jvae
    from gbnerf_tpu_torch.config import GuidanceConfig
    from gbnerf_tpu_torch.guidance import stable as tst
    from gbnerf_tpu_torch.guidance.text import CLIPTextConfig
    from gbnerf_tpu_torch.guidance.unet import UNetConfig
    from gbnerf_tpu_torch.guidance.vae import VAEConfig

    tm = tst.build_sd_modules(
        GuidanceConfig(prompt="a thing"), jr.PRNGKey(key_seed),
        unet_config=UNetConfig(**MICRO_UNET), vae_config=VAEConfig.tiny(),
        text_config=CLIPTextConfig(**TEXT_CFG), latent_size=latent,
        dtype=torch.float32)
    # tree_map: the dicts' keys sorted, as the JAX package's jitted init
    # and its prior load return them
    up, vp, _ = jax.tree_util.tree_map(jnp.asarray, convert.sd_params_to_jax(
        tm.unet, tm.vae, tm.text_model))
    jm = jst.SDModules(
        unet=junet.UNet2DCondition(junet.UNetConfig(**MICRO_UNET)),
        unet_params=up, vae=jvae.AutoencoderKL(jvae.VAEConfig.tiny()),
        vae_params=vp, schedule=jsch.DiffusionSchedule.sd_v1(),
        embeds_rgb=jnp.asarray(tm.embeds_rgb.numpy()),
        embeds_normal=jnp.asarray(tm.embeds_normal.numpy()),
        latent_size=latent)
    return jm, tm


@pytest.fixture(scope="module")
def stacks():
    """The micro stack of _stacks(3, 32), shared by the LoRA, A-order and
    DDIM cases."""
    return _stacks(3, 32)


def test_lora_a_init_follows_the_jax_tree_order(stacks):
    """init_lora from a JaxKey: A of each target from split(key, 4096) in
    the order of the JAX tree's sorted leaves (not the port's module
    order, which differs), within 4 ulp."""
    from gbnerf_tpu.guidance import lora as jlora
    from gbnerf_tpu_torch.guidance import lora as tlora

    jm, tm = stacks
    ref = jlora.init_lora(jax.random.PRNGKey(9), jm.unet_params, rank=4)
    got = tlora.init_lora(tm.unet, rank=4, generator=jr.PRNGKey(9))
    flat = {"/".join(p): np.asarray(v) for p, v in
            jlora._iter_leaves(ref)}
    assert len(flat) == len(got)
    for k, v in got.items():
        assert ulp(v.numpy(), flat[k.replace(".", "/")]).max() <= 4, k
    order = [tuple(path.split(".")) for _, path, _ in
             tlora._kernel_params(tm.unet)
             if tlora._match(path, tlora.DEFAULT_TARGETS)]
    assert order != sorted(order)       # the module order is not the tree's


def _instance_dir(root, n=3, H=24, W=32):
    from gbnerf_tpu_torch.utils.png import write_png

    rng = np.random.default_rng(4)
    img, lab = root / "img", root / "label"
    img.mkdir()
    lab.mkdir()
    for k in range(n):
        write_png(str(img / f"img_{k:03d}.png"),
                  rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
        m = np.zeros((H, W), np.uint8)
        m[4 + k:12 + k, 6:20] = 255
        write_png(str(lab / f"img_{k:03d}.png"), m)
    return img, lab


LORA_KW = dict(steps=2, batch_size=2, rank=4, lr=1e-3, seed=5,
               masked_loss=True, checkpointing_steps=1, log_every=1)


def _logged_losses(text):
    return [float(line.split("loss=")[1].split()[0])
            for line in text.splitlines() if line.startswith("[lora ")
            and "loss=" in line]


@pytest.fixture(scope="module")
def lora_runs(tmp_path_factory, stacks):
    """The JAX package's train_lora (2 steps, the prior flow's prompt
    draw) on the micro stack → (the stacks, the dirs, its losses, its
    AdamW first moments)."""
    from gbnerf_tpu.train import lora_trainer as jtrainer
    from gbnerf_tpu_torch.utils import msgpack as tmsgpack

    root = tmp_path_factory.mktemp("lora")
    img, lab = _instance_dir(root)
    jm, tm = stacks
    emb3 = np.asarray(jm.embeds_rgb)

    def encode(captions, rng=None):
        return jnp.asarray(emb3[rng.integers(0, 3, len(captions))])

    ds = jtrainer.DreamBoothInpaintDataset(str(img), mask_dir=str(lab),
                                           resolution=32)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jtrainer.train_lora(jm, ds, encode, output_dir=str(root / "jax"),
                            **LORA_KW)
    st = tmsgpack.load(str(root / "jax" / "checkpoint-2" / "state.msgpack"))
    return tm, img, lab, root, _logged_losses(buf.getvalue()), st


def _port_lora(runs, draws, resume=None):
    """The port's train_lora as the fixture's, from scratch or resumed from
    a checkpoint dir (copied into its output dir) → (its losses, its
    checkpoint-2 state, its output dir)."""
    import shutil

    from gbnerf_tpu_torch.train import lora_trainer as ttrainer
    from gbnerf_tpu_torch.utils import msgpack as tmsgpack

    tm, img, lab, root, *_ = runs
    emb3 = tm.embeds_rgb

    def encode(captions, rng=None):
        return emb3[torch.as_tensor(rng.integers(0, 3, len(captions)))]

    ds = ttrainer.DreamBoothInpaintDataset(str(img), mask_dir=str(lab),
                                           resolution=32)
    out = root / f"port_{draws}{'_resumed' if resume else ''}"
    if resume:
        shutil.copytree(resume, out / os.path.basename(resume))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ttrainer.train_lora(tm, ds, encode, output_dir=str(out),
                            device="cpu", draws=draws,
                            resume_from="latest" if resume else None,
                            **LORA_KW)
    st = tmsgpack.load(str(out / "checkpoint-2" / "state.msgpack"))
    return _logged_losses(buf.getvalue()), st, out


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(v, np.float64)


def _cosines(ref, got):
    g = dict(_leaves(got))
    return {k: float((g[k] * r).sum() / (np.linalg.norm(g[k])
                                         * np.linalg.norm(r) + 1e-300))
            for k, r in _leaves(ref)}


def _lora_close(runs, got) -> bool:
    """Both steps' losses, and the B adapters' first moments (the two
    steps' gradients: A's is 0 at the first step, with B = 0)."""
    ref_l, ref_st = runs[4], runs[5]
    cos = _cosines(ref_st["opt"]["0"]["mu"], got[1]["opt"]["0"]["mu"])
    return (np.allclose(got[0], ref_l, rtol=1e-3, atol=0)
            and min(c for k, c in cos.items() if k.endswith("lora_B"))
            >= 0.999)


def _step2_grads(st, st1):
    """The second step's gradients from AdamW's first moments, μ2 = 0.9·μ1
    + 0.1·g2, μ1 from the checkpoint-1 state ``st1``."""
    mu1 = dict(_leaves(st1["opt"]["0"]["mu"]))
    return {k: (v - 0.9 * mu1[k]) / 0.1
            for k, v in _leaves(st["opt"]["0"]["mu"])}


def test_lora_trainer_matches_jax_with_its_draws(lora_runs):
    """From scratch: both losses and the B moments. Resumed from the JAX
    trainer's checkpoint-1 (so that both step from the same adapters, B
    ≠ 0, and A's gradient is not 0): the second step's loss, and its
    gradient of every adapter, A's too, at cosine 0.999 a leaf."""
    import json

    from gbnerf_tpu_torch.utils import msgpack as tmsgpack

    got = _port_lora(lora_runs, "jax")
    assert len(got[0]) == len(lora_runs[4]) == 2
    assert _lora_close(lora_runs, got)
    jdir = lora_runs[3] / "jax"
    st1 = tmsgpack.load(str(jdir / "checkpoint-1" / "state.msgpack"))
    resumed = _port_lora(lora_runs, "jax", resume=jdir / "checkpoint-1")
    np.testing.assert_allclose(resumed[0], lora_runs[4][1:], rtol=1e-3)
    g_ref, g_got = (_step2_grads(st, st1) for st in (lora_runs[5],
                                                      resumed[1]))
    assert any(k.endswith("lora_A") and np.abs(v).max() > 0
               for k, v in g_ref.items())
    for k, r in g_ref.items():
        c = float((g_got[k] * r).sum()
                  / (np.linalg.norm(g_got[k]) * np.linalg.norm(r) + 1e-300))
        assert c >= 0.999, (k, c)
    # the key state the JAX trainer writes, and a resume that reads it
    meta = json.loads((got[2] / "checkpoint-2" / "meta.json").read_text())
    ref = json.loads((lora_runs[3] / "jax" / "checkpoint-2" / "meta.json")
                     .read_text())
    assert meta["jax_rng"] == ref["jax_rng"] and "torch_rng" not in meta


def test_lora_trainer_with_torch_draws_fails_the_check(lora_runs):
    assert not _lora_close(lora_runs, _port_lora(lora_runs, "torch"))


def test_lora_resume_with_jax_draws_is_bit_exact(lora_runs, tmp_path):
    """train(2) against train(1) then resume('latest') to 2 with the JAX
    draws: the same adapters, bit for bit (the key restored from
    jax_rng); a checkpoint of torch's draws refuses a JAX-draw resume."""
    from gbnerf_tpu_torch.train import lora_trainer as ttrainer

    tm, img, lab = lora_runs[:3]
    emb3 = tm.embeds_rgb
    ds = ttrainer.DreamBoothInpaintDataset(str(img), mask_dir=str(lab),
                                           resolution=32)

    def encode(captions, rng=None):
        return emb3[torch.as_tensor(rng.integers(0, 3, len(captions)))]

    kw = dict(LORA_KW, checkpointing_steps=1, log_every=100, device="cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        full = ttrainer.train_lora(tm, ds, encode, output_dir=str(
            tmp_path / "a"), draws="jax", **kw)
        ttrainer.train_lora(tm, ds, encode, output_dir=str(tmp_path / "b"),
                            draws="jax", **dict(kw, steps=1))
        resumed = ttrainer.train_lora(
            tm, ds, encode, output_dir=str(tmp_path / "b"), draws="jax",
            resume_from="latest", **kw)
        ttrainer.train_lora(tm, ds, encode, output_dir=str(tmp_path / "c"),
                            draws="torch", **dict(kw, steps=1))
        with pytest.raises(ValueError, match="torch draws"):
            ttrainer.train_lora(tm, ds, encode,
                                output_dir=str(tmp_path / "c"), draws="jax",
                                resume_from="latest", **kw)
    for k in full:
        assert torch.equal(full[k], resumed[k]), k


# ---- stage 2 with colla and Perp-Neg; stage 1 with chunks and the mesh ----

@pytest.fixture(scope="module")
def micro_unet():
    """``UNetConfig.tiny()`` gives the cut UNet in both packages for the
    loops' runs (test_torch_run_parity.py's)."""
    from gbnerf_tpu.guidance import unet as junet
    from gbnerf_tpu_torch.guidance import unet as tunet

    mp = pytest.MonkeyPatch()
    for mod in (junet, tunet):
        cls = mod.UNetConfig
        mp.setattr(cls, "tiny", staticmethod(
            lambda in_channels=9, cls=cls: cls(**dict(
                MICRO_UNET, in_channels=in_channels))))
    yield
    mp.undo()


def _loop_cfg(mod, basedir, name, *, stage2, **train):
    """A small CP-field run of either package's loop: stage 2 with the
    tiny prior, Perp-Neg and colla (no LPIPS), or stage 1."""
    t = dict(N_iters=2, N_rand=32, first_stage=not stage2, lpips=False,
             i_print=1, i_weights=1000, i_video=1000, i_evaluate=1000,
             i_testset=1000, basedir=str(basedir), expname=name,
             render_factor=0, seed=5)
    t.update(train)
    return mod.Config(
        field=mod.FieldConfig(cp_resolutions=(5, 9, 17), cp_rank=4,
                              cp_bound=1.5),
        render=mod.RenderConfig(N_samples=16, N_importance=16,
                                lindisp=False, white_bkgd=False, perturb=1.0,
                                raw_noise_std=1.0, render_block=512),
        data=mod.DataConfig(colmap_depth=False),
        guidance=mod.GuidanceConfig(
            sd_tiny=True, sd_latent_size=16, is_rgb_guidance=stage2,
            is_normal_guidance=False, cache_masked_latents=True,
            sds_loss_weight=1e-2, use_csd=False, perpneg=stage2,
            progressive_view=stage2, is_colla_guidance=stage2,
            normalmap_render_factor=4),
        train=mod.TrainConfig(**t),
        mesh=mod.MeshConfig(num_devices=1))


def _twin_sd_modules_perpneg(gcfg, rng, weights_dir=None, **kw):
    """test_torch_run_parity.py's build of the JAX package's tiny stack
    (the towers' init from the twin), with Perp-Neg's direction-suffixed
    prompt embeddings by the JAX text tower, as its build_sd_modules."""
    import dataclasses

    from test_torch_run_parity import _twin_sd_modules

    mods = _twin_sd_modules(gcfg, rng, weights_dir, **kw)
    ids = mods.tokenizer([f"{gcfg.prompt}, {d} view"
                          for d in ("front", "side", "back")])
    z = mods.text_model.apply({"params": mods.text_params},
                              jnp.asarray(ids))
    return dataclasses.replace(mods, embeds_dir={
        "front": z[0], "side": z[1], "back": z[2]})


def _jax_loop(cfg, scene, init_seed):
    """The JAX package's train() on ``scene``, its fields' init from the
    twin (flax's eager init of the CP fields takes seconds) → (losses,
    initial params, final params)."""
    import gbnerf_tpu.guidance as jguidance
    from gbnerf_tpu.train import loop as jloop
    from gbnerf_tpu.train import state as jstate
    from gbnerf_tpu_torch import config as tcfg
    from gbnerf_tpu_torch.train import state as tstate

    k_init = jr.split(jr.PRNGKey(init_seed))[1]
    _, tc, tf = tstate.create_train_state(
        tcfg.Config(field=tcfg.FieldConfig(**vars(cfg.field))), k_init)
    init = convert.params_to_jax({"coarse": tc.state_dict(),
                                  "fine": tf.state_dict()})

    def twin_train_state(c, rng):
        assert [int(x) for x in np.asarray(rng)] == list(k_init.words())
        params = jax.tree_util.tree_map(jnp.asarray, init)
        return (jstate.TrainState(jnp.zeros((), jnp.int32), params,
                                  jstate.make_optimizer(c).init(params)),
                jstate.build_field(c, fine=False),
                jstate.build_field(c, fine=True))

    mp = pytest.MonkeyPatch()
    mp.setattr(jguidance, "build_sd_modules", _twin_sd_modules_perpneg)
    mp.setattr(jloop, "create_train_state", twin_train_state)
    try:
        res = jloop.train(cfg, scene=scene)
    finally:
        mp.undo()
    return ([h[1]["loss"] for h in res["history"]], init,
            jax.tree_util.tree_map(np.asarray, res["state"].params))


def _port_loop(cfg, scene, draws):
    from gbnerf_tpu_torch.train import loop as tloop

    res = tloop.train(cfg, scene=scene, device="cpu", draws=draws)
    st = res["state"]
    return ([h[1]["loss"] for h in res["history"]],
            convert.params_to_jax({"coarse": st.coarse.state_dict(),
                                   "fine": st.fine.state_dict()}))


def _run_close(ref, got) -> bool:
    """test_torch_run_parity.py's stage-2 bounds: each logged loss at
    rtol 1e-3, every leaf's update at cosine 0.999."""
    from test_torch_run_parity import _update_cosines

    losses, p0, params = ref
    cos = _update_cosines(p0, params, got[1])
    return (len(got[0]) == len(losses)
            and np.allclose(got[0], losses, rtol=1e-3, atol=0)
            and min(cos.values()) >= 0.999)


@pytest.fixture(scope="module")
def scene_small():
    from test_torch_train import _scene

    return _scene()


@pytest.fixture(scope="module")
def jax_colla_perpneg(tmp_path_factory, scene_small, micro_unet):
    from gbnerf_tpu import config as jcfg

    base = tmp_path_factory.mktemp("cp")
    return base, _jax_loop(_loop_cfg(jcfg, base, "jax", stage2=True),
                           scene_small, 5)


def test_colla_perpneg_steps_match_jax_with_its_draws(jax_colla_perpneg,
                                                      scene_small):
    """Two stage-2 steps with Perp-Neg on the RGB modality (the orbit's
    three bounded uniforms under progressive_view, then its SDS step) and
    colla's four views (the SDS step's three-way split over K views)."""
    from gbnerf_tpu_torch import config as tcfg

    base, ref = jax_colla_perpneg
    got = _port_loop(_loop_cfg(tcfg, base, "port_jax", stage2=True),
                     scene_small, "jax")
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-3)
    assert _run_close(ref, got)


def test_colla_perpneg_steps_with_torch_draws_fail_the_check(
        jax_colla_perpneg, scene_small):
    from gbnerf_tpu_torch import config as tcfg

    base, ref = jax_colla_perpneg
    assert not _run_close(ref, _port_loop(
        _loop_cfg(tcfg, base, "port_torch", stage2=True), scene_small,
        "torch"))


S1_CHUNKED = dict(N_iters=4, i_print=2, steps_per_dispatch=2)


@pytest.fixture(scope="module")
def jax_stage1_runs(tmp_path_factory, scene_small):
    """The JAX loop's stage 1, 2 steps one a dispatch and 4 in chunks of
    2 (the cadence i_print 2 ends each chunk)."""
    from gbnerf_tpu import config as jcfg

    base = tmp_path_factory.mktemp("s1")
    return base, {
        "plain": _jax_loop(_loop_cfg(jcfg, base, "jax", stage2=False),
                           scene_small, 5),
        "chunked": _jax_loop(_loop_cfg(jcfg, base, "jaxc", stage2=False,
                                       **S1_CHUNKED), scene_small, 5)}


def test_steps_per_dispatch_keys_match_jax(jax_stage1_runs, scene_small):
    """steps_per_dispatch 2: the port runs the chunk's steps one by one on
    the chunk's keys, split(split(rng)[1], 2); the torch-draw control and
    the one-a-dispatch key tree both miss."""
    from gbnerf_tpu_torch import config as tcfg

    base, runs = jax_stage1_runs
    ref = runs["chunked"]
    got = _port_loop(_loop_cfg(tcfg, base, "portc", stage2=False,
                               **S1_CHUNKED), scene_small, "jax")
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-3)
    assert _run_close(ref, got)
    for draws, spd in (("torch", 2), ("jax", 1)):
        other = _port_loop(_loop_cfg(tcfg, base, f"portc_{draws}{spd}",
                                     stage2=False, **dict(
                                         S1_CHUNKED, steps_per_dispatch=spd)),
                           scene_small, draws)
        assert not _run_close(ref, other), (draws, spd)


MESH_SCRIPT = '''
import pickle, sys
import torch
from gbnerf_tpu_torch import convert
from gbnerf_tpu_torch.parallel import mesh as pmesh
from gbnerf_tpu_torch.train import loop as tloop

cfg, scene, draws, out = pickle.load(open(sys.argv[1], "rb"))
dev = pmesh.init_distributed(torch.device("cpu"), "gloo")
res = tloop.train(cfg, scene=scene, device=dev, draws=draws)
if pmesh.rank() == 0:
    st = res["state"]
    pickle.dump(([h[1]["loss"] for h in res["history"]],
                 convert.params_to_jax({"coarse": st.coarse.state_dict(),
                                        "fine": st.fine.state_dict()})),
                open(out, "wb"))
torch.distributed.destroy_process_group()
'''


def _mesh_runs(base, scene, runs):
    """Each (name, cfg, draws) of ``runs`` on 2 gloo ranks (one torchrun
    a run, started together) → {name: (losses, params)} of rank 0."""
    import pickle
    import subprocess

    script = base / "mesh_run.py"
    script.write_text(MESH_SCRIPT)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = {}
    for port, (name, cfg, draws) in enumerate(runs):
        arg = base / f"{name}.pkl"
        with open(arg, "wb") as fh:
            pickle.dump((cfg, scene, draws, str(base / f"{name}.out")), fh)
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
             "--nproc_per_node", "2", "--master_port",
             str(29611 + 7 * port), str(script), str(arg)],
            env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    out = {}
    for name, p in procs.items():
        log = p.communicate(timeout=240)[0]
        assert p.returncode == 0, log[-3000:]
        with open(base / f"{name}.out", "rb") as fh:
            out[name] = pickle.load(fh)
    return out


def test_mesh_two_ranks_match_jax_with_its_draws(jax_stage1_runs,
                                                 scene_small):
    """Two gloo ranks, each drawing the global batch's draws from the
    JaxKey and keeping its rows, against the JAX package's one-device
    loop; the same two ranks with torch's draws miss."""
    from gbnerf_tpu_torch import config as tcfg

    base, runs = jax_stage1_runs
    ref = runs["plain"]
    got = _mesh_runs(base, scene_small, [
        (f"mesh_{d}", dataclasses.replace(
            _loop_cfg(tcfg, base, f"mesh_{d}", stage2=False),
            mesh=tcfg.MeshConfig(num_devices=0)), d)
        for d in ("jax", "torch")])
    np.testing.assert_allclose(got["mesh_jax"][0], ref[0], rtol=1e-3)
    assert _run_close(ref, got["mesh_jax"])
    assert not _run_close(ref, got["mesh_torch"])


# ---- the DDIM inpaint and CLIP guidance ---------------------------------

def _image_and_mask(S):
    rng = np.random.default_rng(6)
    img = rng.random((S, S, 3)).astype(np.float32)
    mask = np.zeros((S, S), np.float32)
    mask[S // 4:3 * S // 4, S // 3:2 * S // 3] = 1.0
    return img, mask


@pytest.mark.parametrize("strength", [1.0, 0.6])
def test_ddim_inpaint_matches_jax_with_its_draws(stacks, strength):
    """Both strength branches: the latents' noise from k_lat, the masked
    image's posterior ε from k_enc1 and (below strength 1) the image's
    from k_enc2; 5 DDIM steps (3 at strength 0.6)."""
    from gbnerf_tpu.guidance import pipeline as jpipe
    from gbnerf_tpu_torch.guidance import pipeline as tpipe

    jm, tm = stacks
    img, mask = _image_and_mask(32)
    kw = dict(num_inference_steps=5, strength=strength)
    ref = np.asarray(jpipe.inpaint(jm, jm.embeds_rgb, jnp.asarray(img),
                                   jnp.asarray(mask),
                                   jax.random.PRNGKey(8), **kw))

    def port(gen):
        return tpipe.inpaint(tm, tm.embeds_rgb, torch.from_numpy(img),
                             torch.from_numpy(mask), gen, **kw).numpy()

    def close(got):
        return np.allclose(got, ref, rtol=1e-4,
                           atol=1e-5 * np.abs(ref).max())

    got = port(jr.PRNGKey(8))
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-5 * np.abs(ref).max())
    assert not close(port(torch.Generator().manual_seed(8)))


def test_clip_guidance_init_and_projection_match_jax():
    """CLIPGuidance from PRNGKey(5): the vision tower (k1) within 4 ulp of
    flax's init, the text tower (k2) and the random projection (k3) held
    through the prompt's embedding, the loss on a fixed image; the
    torch-draw control misses."""
    from gbnerf_tpu.guidance import clip_guidance as jclip
    from gbnerf_tpu.guidance.text import CLIPTextConfig as JText
    from gbnerf_tpu_torch.guidance import clip_guidance as tclip
    from gbnerf_tpu_torch.guidance.text import CLIPTextConfig as TText

    prompt = "a wooden bench"
    jg = jclip.CLIPGuidance(jax.random.PRNGKey(5), prompt,
                            vision_config=jclip.CLIPVisionConfig.tiny(),
                            text_config=JText(**TEXT_CFG))
    image = np.random.default_rng(2).random((40, 40, 3)).astype(np.float32)
    ref_loss = float(jg.loss(jnp.asarray(image)))
    ref_embed = np.asarray(jg.text_embed)

    def port(gen):
        return tclip.CLIPGuidance(
            prompt, gen, vision_config=tclip.CLIPVisionConfig.tiny(),
            text_config=TText(**TEXT_CFG))

    tg = port(jr.PRNGKey(5))
    vis = convert.clip_vision_params_to_jax(tg.vision)
    for path, r in jax.tree_util.tree_leaves_with_path(jg.vision_params):
        g = vis
        for part in path:
            g = g[part.key]
        assert ulp(g, np.asarray(r)).max() <= 4, path
    np.testing.assert_allclose(tg.text_embed.numpy(), ref_embed, rtol=1e-4,
                               atol=1e-5)
    loss = float(tg.loss(torch.from_numpy(image)))
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-4)
    other = port(torch.Generator().manual_seed(5))
    assert not np.allclose(other.text_embed.numpy(), ref_embed, atol=1e-3)
