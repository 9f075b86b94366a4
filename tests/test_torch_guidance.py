"""Port vs JAX: the SD1.5-inpainting guidance stack at tiny widths — the
blocks, the UNet's ε, the VAE's moments and its differentiable encode and
decode, the CLIP text tower and the tokenizer, the schedule, the combines
and the gradient injection, the resizes, the stack's build and the weights
loaders (the score-distillation step and hook: tests/test_torch_sds.py).

The weights: random flax trees at the shapes of the JAX modules, carried
into the port with ``convert.sd_params_from_jax`` (tests/_sd_pair.py); or
one ``tools/make_fake_sd_ckpt.py --tiny`` checkpoint loaded by both
packages.

Tolerances, with their reasons: everything runs in f32 on both sides, and
the two frameworks sum convolutions, matmuls and GroupNorm statistics in
other orders (flax takes the variance as E[x²] − E[x]²), so values agree to
≈ 1e-6 of their scale: rtol 1e-4 with atol 1e-5·max|ref| on activations
and latents; gradients through the VAE encoder's backward (a dozen
convolutions and GroupNorms, each summed in another order) get atol
1e-4·max|ref|. The schedule and the combines are a few f32 operations:
rtol 1e-6 (1e-5 where a division by √ᾱ amplifies). Exact (ids, integer
timesteps, the injected gradient): equality.
"""
import dataclasses
import importlib.util
import json
import math
import struct
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gbnerf_tpu.guidance import blocks as jb
from gbnerf_tpu.guidance import schedule as jsch
from gbnerf_tpu.guidance import sds as jsds
from gbnerf_tpu.guidance import stable as jst
from gbnerf_tpu.guidance import text as jtext
from gbnerf_tpu.guidance import unet as junet
from gbnerf_tpu.guidance import vae as jvae
from gbnerf_tpu.guidance.weights import load_sd_weights as jload
from gbnerf_tpu_torch.guidance import blocks as tb
from gbnerf_tpu_torch.guidance import schedule as tsch
from gbnerf_tpu_torch.guidance import sds as tsds
from gbnerf_tpu_torch.guidance import stable as tst
from gbnerf_tpu_torch.guidance import text as ttext
from gbnerf_tpu_torch.guidance import unet as tunet
from gbnerf_tpu_torch.guidance import vae as tvae
from gbnerf_tpu_torch.guidance import weights as tweights

from _sd_pair import TEXT_CFG, close as _close, flax_params as _flax_params
from _sd_pair import load as _load, make_stack, t as _t

torch.set_num_threads(1)
GRAD_ATOL_FRAC = 1e-4          # gradients through the VAE encoder's backward


@pytest.fixture(scope="module")
def stack():
    return make_stack()


# ---------- blocks ----------

@pytest.mark.parametrize("cin,cout,temb", [(16, 16, None), (16, 32, 24),
                                           (12, 12, 8)])
def test_resnet_block_matches_flax(rng, cin, cout, temb):
    """12 channels: the group count clamps to 12 (tiny widths)."""
    jm = jb.ResnetBlock2D(cout)
    x = rng.standard_normal((2, 8, 8, cin)).astype(np.float32)
    te = (rng.standard_normal((2, temb)).astype(np.float32)
          if temb else None)
    p = _flax_params(jm, rng, jnp.zeros((2, 8, 8, cin)),
                     None if te is None else jnp.zeros((2, temb)))
    ref = jm.apply({"params": p}, x, te)
    tm = _load(tb.ResnetBlock2D(cin, cout, temb), p)
    got = tm(_t(x).permute(0, 3, 1, 2), None if te is None else _t(te))
    _close(got.permute(0, 2, 3, 1), ref)


@pytest.mark.parametrize("n_tokens", [16, 1024])
def test_transformer2d_matches_flax(rng, n_tokens):
    """Self + cross attention, GEGLU feed-forward, LayerNorm ε 1e-6; at
    1024 tokens the self-attention takes the autograd Function's branch."""
    side = int(math.sqrt(n_tokens))
    jm = jb.Transformer2D(heads=2, dim_head=8)
    x = rng.standard_normal((1, side, side, 16)).astype(np.float32)
    ctx = rng.standard_normal((1, 7, 12)).astype(np.float32)
    p = _flax_params(jm, rng, jnp.zeros(x.shape), jnp.zeros(ctx.shape))
    ref = jax.jit(jm.apply)({"params": p}, x, ctx)
    tm = _load(tb.Transformer2D(16, 2, 8, 12), p)
    got = tm(_t(x).permute(0, 3, 1, 2), _t(ctx)).permute(0, 2, 3, 1)
    _close(got, ref)


@pytest.mark.parametrize("asymmetric", [True, False])
def test_down_and_upsample_match_flax(rng, asymmetric):
    x = rng.standard_normal((1, 9, 10, 6)).astype(np.float32)
    jd = jb.Downsample2D(6, asymmetric=asymmetric)
    pd = _flax_params(jd, rng, jnp.zeros(x.shape))
    got = _load(tb.Downsample2D(6, 6, asymmetric=asymmetric), pd)(
        _t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(got, jd.apply({"params": pd}, x))
    ju = jb.Upsample2D(5)
    pu = _flax_params(ju, rng, jnp.zeros(x.shape))
    got = _load(tb.Upsample2D(6, 5), pu)(
        _t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(got, ju.apply({"params": pu}, x))


def test_time_embedding_and_feed_forward_match_flax(rng):
    t = np.array([0.0, 17.0, 981.0], np.float32)
    _close(tb.timestep_embedding(_t(t), 32), jb.timestep_embedding(t, 32))
    emb = rng.standard_normal((3, 32)).astype(np.float32)
    jm = jb.TimestepEmbedding(48)
    p = _flax_params(jm, rng, jnp.zeros(emb.shape))
    _close(_load(tb.TimestepEmbedding(32, 48), p)(_t(emb)),
           jm.apply({"params": p}, emb))
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    jf = jb.FeedForward()
    pf = _flax_params(jf, rng, jnp.zeros(x.shape))
    _close(_load(tb.FeedForward(16), pf)(_t(x)), jf.apply({"params": pf}, x))


def test_masked_attention_takes_the_einsum(rng):
    x = rng.standard_normal((1, 6, 8)).astype(np.float32)
    mask = np.where(rng.random((1, 1, 6, 6)) > 0.3, 0.0, -1e9
                    ).astype(np.float32)
    jm = jb.Attention(heads=2, dim_head=4)
    p = _flax_params(jm, rng, jnp.zeros(x.shape))
    got = _load(tb.Attention(8, 2, 4), p)(_t(x), mask=_t(mask))
    _close(got, jm.apply({"params": p}, x, mask=mask))


# ---------- the models ----------

def test_unet_epsilon_matches_flax(stack, rng):
    jm, tm = stack["mods"]()
    x = rng.standard_normal((2, 16, 16, 9)).astype(np.float32)
    ctx = stack["emb"]["rgb"][1:]
    ref = jax.jit(jm.unet.apply)({"params": jm.unet_params}, x, 500, ctx)
    with torch.no_grad():
        got = tm.unet(_t(x), 500, _t(ctx))
    assert got.dtype == torch.float32 and got.shape == (2, 16, 16, 4)
    _close(got, ref)


def test_vae_moments_encode_grad_and_decode_match_flax(stack, rng):
    jm, tm = stack["mods"]()
    img = rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    eps = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    vp = jm.vae_params
    A = jvae.AutoencoderKL
    rm, rl = jax.jit(lambda x: jm.vae.apply(
        {"params": vp}, x, method=A.encode_moments))(img)
    with torch.no_grad():
        gm, gl = tm.vae.encode_moments(_t(img))
    _close(gm, rm)
    _close(gl, rl)

    # the differentiable encode, with the posterior ε of a JAX key
    key = jax.random.PRNGKey(3)
    cot = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)

    def jenc(x):
        z = jm.vae.apply({"params": vp}, x, key, method=A.encode)
        return jnp.sum(z * cot), z

    (_, rz), rg = jax.jit(jax.value_and_grad(jenc, has_aux=True))(img)
    e = np.asarray(jax.random.normal(key, (1, 8, 8, 4), jnp.float32))
    x = _t(img).requires_grad_(True)
    z = tm.vae.encode(x, _t(e))
    torch.sum(z * _t(cot)).backward()
    _close(z, rz)
    _close(x.grad, rg, atol_frac=GRAD_ATOL_FRAC)
    with torch.no_grad():
        _close(tm.vae.encode(_t(img)),
               jm.vae.apply({"params": vp}, img, method=A.encode))
        _close(tm.vae.decode(_t(eps)),
               jax.jit(lambda z: jm.vae.apply({"params": vp}, z,
                                              method=A.decode))(eps))


def test_text_encoder_and_tokenizer_fallback_match(stack):
    texts = ["", "bad", "a stone park bench", "A  Stone park BENCH!"]
    jt = jtext.Tokenizer(None, 77, 49408)
    tt = ttext.Tokenizer(None, 77, 49408)
    np.testing.assert_array_equal(tt(texts), jt(texts))   # ids identical
    small_j, small_t = (T(None, 77, 1000) for T in (jtext.Tokenizer,
                                                     ttext.Tokenizer))
    np.testing.assert_array_equal(small_t(texts), small_j(texts))
    ids = jt(["", "bad", "a thing"])
    ref = jax.jit(stack["jt"].apply)({"params": stack["tp"]}, ids)
    with torch.no_grad():
        _close(stack["tt"](ids), ref)


# ---------- schedule, combines, injection, resizes ----------

def test_schedule_matches_jax():
    js, ts = jsch.DiffusionSchedule.sd_v1(), tsch.DiffusionSchedule.sd_v1()
    np.testing.assert_array_equal(ts.alphas_cumprod, js.alphas_cumprod)
    t_range = (0.02, 0.98)
    assert ts.step_range(t_range) == js.step_range(t_range)
    for i in (0, 1, 7, 499, 500, 1234, 19999, 20000, 25000):
        assert ts.annealed_t(i, t_range) == int(js.annealed_t(i, t_range)), i
    rng = np.random.default_rng(1)
    x0, n = (rng.standard_normal((2, 4, 4, 4)).astype(np.float32)
             for _ in range(2))
    for t in (20, 517, 980):
        _close(ts.add_noise(_t(x0), _t(n), t), js.add_noise(x0, n, t),
               rtol=1e-6, atol_frac=1e-7)
        _close(ts.sds_weight(t), js.sds_weight(t), rtol=1e-7)
        _close(ts.ddim_step(_t(x0), _t(n), t, t - 20),
               js.ddim_step(x0, n, t, t - 20), rtol=1e-5, atol_frac=1e-6)
    _close(ts.ddim_step(_t(x0), _t(n), 20, -1),
           js.ddim_step(x0, n, 20, -1), rtol=1e-5, atol_frac=1e-6)
    bf = torch.zeros(1, 2, dtype=torch.bfloat16)
    assert ts.add_noise(bf, torch.zeros(1, 2), 5).dtype == torch.float32


def test_combines_grad_modes_and_injection_match_jax(rng):
    e = [rng.standard_normal((1, 4, 4, 4)).astype(np.float32)
         for _ in range(3)]
    te = [_t(x) for x in e]
    _close(tsds.cfg_combine_sds(te[0], te[1], 7.5),
           jsds.cfg_combine_sds(e[0], e[1], 7.5), rtol=1e-6)
    _close(tsds.cfg_combine_bsd(*te, 8.5, 7.5, 0.5),
           jsds.cfg_combine_bsd(*e, 8.5, 7.5, 0.5), rtol=1e-6)
    _close(tsds.cfg_combine_colla(*te, 8.5, 7.5),
           jsds.cfg_combine_colla(*e, 8.5, 7.5), rtol=1e-6)
    for mode, std in (("sds", False), ("sds", True), ("csd", False)):
        _close(tsds.score_distillation_grad(te[0], te[1], 0.3, mode=mode,
                                            standard_sds=std),
               jsds.score_distillation_grad(e[0], e[1], 0.3, mode=mode,
                                            standard_sds=std), rtol=1e-6)
    grad = e[2].copy()
    grad[0, 0, 0, :2] = [np.nan, np.inf]
    mask = (rng.random((1, 4, 4, 1)) > 0.5).astype(np.float32)
    lat = _t(e[0]).requires_grad_(True)
    loss = tsds.inject_gradient(lat, _t(grad), _t(mask))
    loss.backward()
    ref, rg = jax.value_and_grad(lambda l: jsds.inject_gradient(
        l, grad, mask))(e[0])
    _close(loss, ref, rtol=1e-6)
    np.testing.assert_array_equal(lat.grad.numpy(), np.asarray(rg))


@pytest.mark.parametrize("src,size,method", [
    ((24, 32), 64, "bilinear"), ((27, 36), 512, "bilinear"),
    ((96, 80), 40, "bilinear"), ((64, 64), 8, "nearest"),
    ((512, 512), 64, "nearest")])
def test_resize_matches_jax_image_resize(rng, src, size, method):
    """Half-pixel centres: bilinear up, antialiased bilinear down,
    'nearest' as torch's nearest-exact."""
    x = rng.random((1, *src, 3)).astype(np.float32)
    ref = jst._resize(jnp.asarray(x), size, method=method)
    _close(tst._resize(_t(x), size, method=method), ref, rtol=1e-5,
           atol_frac=1e-6)


def test_unported_guidance_options_raise(stack):
    """Only sd_version 2.x is refused; Perp-Neg and colla build their hooks
    (held against the JAX package in tests/test_torch_perpneg.py and
    tests/test_torch_colla.py)."""
    _, tm = stack["mods"]()
    for kw in ({"perpneg": True}, {"is_colla_guidance": True}):
        assert callable(tst.make_guidance_fn(
            tm, dataclasses.replace(stack["gcfg"], **kw)))
    with pytest.raises(NotImplementedError, match="sd_version"):
        tst.build_sd_modules(dataclasses.replace(stack["gcfg"],
                                                 sd_version="2.1"))


def test_build_sd_modules_tiny_runs_and_is_seeded(stack):
    kw = dict(unet_config=tunet.UNetConfig.tiny(),
              vae_config=tvae.VAEConfig.tiny(),
              text_config=ttext.CLIPTextConfig(**TEXT_CFG), latent_size=64,
              dtype=torch.float32)
    a = tst.build_sd_modules(stack["gcfg"], torch.Generator().manual_seed(1),
                             **kw)
    b = tst.build_sd_modules(stack["gcfg"], torch.Generator().manual_seed(1),
                             **kw)
    assert a.embeds_rgb.shape == (3, 77, 32)
    assert torch.equal(a.embeds_rgb, b.embeds_rgb)
    assert all(torch.equal(x, y) for x, y in zip(
        a.unet.state_dict().values(), b.unet.state_dict().values()))
    assert not any(p.requires_grad for p in a.vae.parameters())
    assert tst.guidance_params(a)["unet"] is a.unet


# ---------- weights ----------

def _write_safetensors(path, tensors):
    """A .safetensors file by the format's definition (little-endian)."""
    header, blobs, off = {}, [], 0
    for name, a in tensors.items():
        raw = np.ascontiguousarray(a).tobytes()
        header[name] = {"dtype": {np.dtype(np.float32): "F32",
                                  np.dtype(np.float16): "F16",
                                  np.dtype(np.int64): "I64"}[a.dtype],
                        "shape": list(a.shape),
                        "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    h = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(h)) + h + b"".join(blobs))


def test_safetensors_reader_matches_the_package(tmp_path, rng):
    from safetensors.numpy import load_file, save_file

    tensors = {"a": rng.standard_normal((3, 4)).astype(np.float32),
               "b": rng.standard_normal(5).astype(np.float16),
               "c": np.arange(6, dtype=np.int64).reshape(2, 3),
               "empty": np.zeros((0, 3), np.float32)}
    save_file(tensors, str(tmp_path / "x.safetensors"))
    ref = load_file(str(tmp_path / "x.safetensors"))
    got = tweights.read_safetensors(str(tmp_path / "x.safetensors"))
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].numpy().dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k].numpy(), ref[k], err_msg=k)
    _write_safetensors(tmp_path / "y.safetensors", {"a": tensors["a"]})
    np.testing.assert_array_equal(
        tweights.read_safetensors(str(tmp_path / "y.safetensors"))["a"],
        tensors["a"])


@pytest.mark.parametrize("legacy_attn", [False, True])
def test_fake_ckpt_loads_into_both_packages_alike(tmp_path, rng,
                                                  legacy_attn):
    """One tools/make_fake_sd_ckpt.py --tiny dir (diffusers key names;
    the original VAE's query/key/value/proj_attn when legacy) loaded by
    both packages' loaders: every key matches, and the models agree; with
    a PEFT adapter dir (lora_dir) merged by both, the UNets agree too."""
    spec = importlib.util.spec_from_file_location(
        "make_fake_sd_ckpt", Path(__file__).resolve().parents[1] / "tools"
        / "make_fake_sd_ckpt.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    tool.save_ckpt(str(tmp_path), tiny=True, seed=3, legacy_attn=legacy_attn)

    ju = junet.UNet2DCondition(junet.UNetConfig.tiny())
    jv = jvae.AutoencoderKL(jvae.VAEConfig.tiny())
    jt = jtext.CLIPTextEncoder(jtext.CLIPTextConfig(**TEXT_CFG))
    shp = [jax.eval_shape(m.init, jax.random.PRNGKey(0), *a)["params"]
           for m, a in ((ju, (jnp.zeros((1, 8, 8, 9)), jnp.zeros(()),
                              jnp.zeros((1, 77, 32)))),
                        (jv, (jnp.zeros((1, 64, 64, 3)),)),
                        (jt, (jnp.zeros((1, 77), jnp.int32),)))]
    zeros = [jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), t) for t in shp]
    up, vp, tp = jload(str(tmp_path), *zeros, strict=True)

    tu = tunet.UNet2DCondition(tunet.UNetConfig.tiny())
    tv = tvae.AutoencoderKL(tvae.VAEConfig.tiny())
    tt = ttext.CLIPTextEncoder(ttext.CLIPTextConfig(**TEXT_CFG))
    tweights.load_sd_weights(str(tmp_path), tu, tv, tt, strict=True)

    img = rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        _close(tv.encode_moments(_t(img))[0],
               jax.jit(lambda p, x: jv.apply(
                   {"params": p}, x,
                   method=jvae.AutoencoderKL.encode_moments)[0])(vp, img))
        if not legacy_attn:       # the UNet and text keys are the same
            x = rng.standard_normal((1, 8, 8, 9)).astype(np.float32)
            ctx = rng.standard_normal((1, 77, 32)).astype(np.float32)
            ids = jtext.Tokenizer(None, 77, 49408)(["a thing"])
            _close(tu(_t(x), 300, _t(ctx)),
                   jax.jit(ju.apply)({"params": up}, x, 300, ctx))
            _close(tt(ids), jax.jit(jt.apply)({"params": tp}, ids))
    # the PEFT merge (lora_dir, the config's model_path): one adapter file
    # merged by both loaders gives the same UNet
    from safetensors.numpy import save_file

    stem = "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q"
    o, i = tu.state_dict()[stem + ".weight"].shape
    peft = tmp_path / "peft"
    peft.mkdir()
    save_file({f"base_model.model.{stem}.lora_A.weight":
               rng.normal(0, 0.3, (4, i)).astype(np.float32),
               f"base_model.model.{stem}.lora_B.weight":
               rng.normal(0, 0.3, (o, 4)).astype(np.float32)},
              str(peft / "adapter_model.safetensors"))
    up, _, _ = jload(str(tmp_path), *zeros, strict=True, lora_dir=str(peft),
                     lora_rank=4)
    tweights.load_sd_weights(str(tmp_path), tu, tv, tt, strict=True,
                             lora_dir=str(peft), lora_rank=4)
    x = rng.standard_normal((1, 8, 8, 9)).astype(np.float32)
    ctx = rng.standard_normal((1, 77, 32)).astype(np.float32)
    with torch.no_grad():
        _close(tu(_t(x), 300, _t(ctx)),
               jax.jit(ju.apply)({"params": up}, x, 300, ctx))
