"""Port vs JAX: LoRA on the tiny SD1.5-inpainting stack, the files both
packages share, and the LoRA trainer.

- utils/msgpack.py: a prior written by the JAX package's save_prior_ckpt
  loads into the port with equal arrays, and one the port writes loads
  through the JAX package's load_prior_ckpt; the codec's bytes equal
  flax's; the refused forms raise.
- write_safetensors: read back by the safetensors package, equal arrays.
- guidance/lora.py: an adapter file written by either package merges in
  the other to the same UNet ε; the adapter count of UNetConfig.tiny(); a
  mismatched adapter raises in both; the PEFT merge (model_path).
- train/lora_trainer.py: one step's loss and adapter gradients against
  the JAX package's loss (its jitted step's loss_fn, with its t, ε and VAE
  ε injected), plain, instance-masked, with prior preservation and with
  text adapters; random_mask and the dataset's batches from one numpy
  seed; the resume (train(4) = train(2) + resume(2), bit for bit).

The weights: tests/_sd_pair.py (the same random flax weights in both
packages). Tolerances, with their reasons: f32 on both sides; ε and the
loss to rtol 1e-4 (the frameworks sum convolutions and GroupNorm in other
orders: ≈ 1e-6 of the scale, amplified by the ε-MSE); the adapter
gradients to rtol 1e-3 with atol 1e-4·max|ref| at latent 128: a backward
through the whole UNet, in which f32 sums alone move the down blocks'
gradients by up to 1.8e-5·max at latent 64 and 6.5e-6·max at 128 (the
port in f32 against the port in f64, the same weights and draws; the
JAX package sits as far from f64 as the port, and the two differ by up
to 4e-5·max), so 1e-6·max would test rounding. File round trips: exact.
"""
import copy
import dataclasses
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gbnerf_tpu.guidance import lora as jlora
from gbnerf_tpu.guidance import weights as jweights
from gbnerf_tpu.train import lora_trainer as jtrainer
from gbnerf_tpu_torch import convert
from gbnerf_tpu_torch.guidance import lora as tlora
from gbnerf_tpu_torch.guidance import weights as tweights
from gbnerf_tpu_torch.train import lora_trainer as ttrainer
from gbnerf_tpu_torch.utils import msgpack as tmsgpack
from gbnerf_tpu_torch.utils.png import write_png

from _sd_pair import close, make_stack, t

torch.set_num_threads(1)
GRAD_RTOL, GRAD_ATOL_FRAC = 1e-3, 1e-4


@pytest.fixture(scope="module")
def stack():
    st = make_stack()
    make = st["mods"]

    def fresh(latent_size=64):
        """The pair with the port's modules copied: the tests below merge
        and load into them in place."""
        jm, tm = make(latent_size)
        return jm, dataclasses.replace(tm, unet=copy.deepcopy(tm.unet),
                                       vae=copy.deepcopy(tm.vae))

    return dict(st, mods=fresh)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(v)


def _perturbed(tree, seed):
    """Another random tree of the same shapes (a 'trained' prior)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)
                   ).astype(np.float32), tree)


# ---------- msgpack and safetensors ----------

def test_prior_files_load_in_both_packages(tmp_path, stack):
    jm, tm = stack["mods"]()
    jm = dataclasses.replace(
        jm, unet_params=_perturbed(jm.unet_params, 1),
        vae_params=_perturbed(jm.vae_params, 2),
        embeds_rgb=jm.embeds_rgb + 1.0, embeds_normal=jm.embeds_normal - 1.0)
    jweights.save_prior_ckpt(str(tmp_path / "jax.msgpack"), jm)
    _, tm = stack["mods"]()
    tweights.load_prior_ckpt(str(tmp_path / "jax.msgpack"), tm)
    u, v, _ = convert.sd_params_to_jax(tm.unet, tm.vae, stack["tt"])
    for got, ref in ((u, jm.unet_params), (v, jm.vae_params)):
        g, r = dict(_flat(got)), dict(_flat(ref))
        assert g.keys() == r.keys()
        for k in r:
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)
    np.testing.assert_array_equal(tm.embeds_rgb.numpy(), jm.embeds_rgb)
    np.testing.assert_array_equal(tm.embeds_normal.numpy(), jm.embeds_normal)

    # the other way: the port writes, the JAX package loads
    with torch.no_grad():
        for p in tm.unet.parameters():
            p.mul_(0.5)
    tweights.save_prior_ckpt(str(tmp_path / "port.msgpack"), tm)
    j0, _ = stack["mods"]()
    jl = jweights.load_prior_ckpt(str(tmp_path / "port.msgpack"), j0)
    u, v, _ = convert.sd_params_to_jax(tm.unet, tm.vae, stack["tt"])
    for got, ref in ((jl.unet_params, u), (jl.vae_params, v)):
        g, r = dict(_flat(got)), dict(_flat(ref))
        assert g.keys() == r.keys()
        for k in r:
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)
    np.testing.assert_array_equal(np.asarray(jl.embeds_rgb),
                                  tm.embeds_rgb.numpy())


def test_prior_of_another_width_is_refused(tmp_path, stack):
    from gbnerf_tpu_torch.guidance import unet as tunet

    _, tm = stack["mods"]()
    tweights.save_prior_ckpt(str(tmp_path / "p.msgpack"), tm)
    _, other = stack["mods"]()
    other.unet = tunet.UNet2DCondition(dataclasses.replace(
        tunet.UNetConfig.tiny(), block_out_channels=(32, 64, 64, 96)))
    with pytest.raises(ValueError, match="does not fit"):
        tweights.load_prior_ckpt(str(tmp_path / "p.msgpack"), other)


def test_msgpack_bytes_equal_flax_and_read_back(rng):
    from flax import serialization

    tree = {"a": {"k": rng.standard_normal((3, 4)).astype(np.float32),
                  "e": np.zeros((0, 2), np.float16)},
            "opt": {"0": {"count": np.asarray(7, np.int32)}, "1": {}},
            "big": np.arange(70000, dtype=np.int64),
            "s": np.float32(2.5), "n": -5, "m": 70000, "f": 1.5,
            "w": "x" * 40, "b": True, "z": None}
    raw = tmsgpack.dumps(tree)
    assert raw == serialization.to_bytes(tree)
    back = tmsgpack.loads(raw)
    ref = serialization.msgpack_restore(raw)
    np.testing.assert_array_equal(back["a"]["k"], ref["a"]["k"])
    assert back["a"]["e"].shape == (0, 2)
    assert back["a"]["e"].dtype == np.float16
    assert back["opt"]["0"]["count"] == 7 and back["opt"]["1"] == {}
    np.testing.assert_array_equal(back["big"], tree["big"])
    assert back["s"] == np.float32(2.5) and back["s"].dtype == np.float32
    assert [back[k] for k in "nmfwbz"] == [-5, 70000, 1.5, "x" * 40, True,
                                           None]
    bf = serialization.to_bytes(
        {"x": np.asarray(jnp.asarray([1.5, -2.0], jnp.bfloat16))})
    np.testing.assert_array_equal(tmsgpack.loads(bf)["x"], [1.5, -2.0])


@pytest.mark.parametrize("case", ["chunked", "complex_scalar",
                                  "complex_array", "int_key"])
def test_msgpack_refuses_what_it_does_not_support(case):
    from flax import serialization

    if case == "chunked":
        raw = serialization.msgpack_serialize(
            {"x": {"__msgpack_chunked_array__": True, "shape": {}}})
        with pytest.raises(ValueError, match="chunked"):
            tmsgpack.loads(raw)
    elif case == "complex_scalar":
        raw = serialization.msgpack_serialize({"x": 1 + 2j})
        with pytest.raises(ValueError, match="complex"):
            tmsgpack.loads(raw)
        with pytest.raises(ValueError, match="complex"):
            tmsgpack.dumps({"x": 1 + 2j})
    elif case == "complex_array":
        a = np.ones(3, np.complex64)
        with pytest.raises(ValueError, match="complex"):
            tmsgpack.loads(serialization.msgpack_serialize({"x": a}))
        with pytest.raises(ValueError, match="complex"):
            tmsgpack.dumps({"x": a})
    else:
        with pytest.raises(ValueError, match="not a string"):
            tmsgpack.dumps({1: np.zeros(2)})


def test_write_safetensors_reads_back_in_the_package(tmp_path, rng):
    from safetensors.numpy import load_file

    tensors = {"b.x": rng.standard_normal((3, 4)).astype(np.float32),
               "a": rng.standard_normal(5).astype(np.float16),
               "c": np.arange(6, dtype=np.int64).reshape(2, 3),
               "empty": np.zeros((0, 3), np.float32)}
    tweights.write_safetensors(str(tmp_path / "x.safetensors"),
                               {k: torch.from_numpy(v)
                                for k, v in tensors.items()})
    ref = load_file(str(tmp_path / "x.safetensors"))
    assert set(ref) == set(tensors)
    for k, v in tensors.items():
        assert ref[k].dtype == v.dtype, k
        np.testing.assert_array_equal(ref[k], v, err_msg=k)
    bf = torch.tensor([1.5, -3.0], dtype=torch.bfloat16)
    tweights.write_safetensors(str(tmp_path / "b.safetensors"), {"w": bf})
    assert torch.equal(tweights.read_safetensors(
        str(tmp_path / "b.safetensors"))["w"], bf)


# ---------- adapters ----------

def _jax_adapters(up, seed, rank=4):
    """JAX init_lora with B drawn too (at init B = 0, the identity)."""
    lora = jlora.init_lora(jax.random.PRNGKey(seed), up, rank=rank)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, a: (np.asarray(a) if p[-1].key == "lora_A" else
                      0.03 * rng.standard_normal(a.shape)).astype(np.float32),
        lora)


def test_jax_adapter_file_merges_in_the_port(tmp_path, stack, rng):
    jm, tm = stack["mods"]()
    lora = _jax_adapters(jm.unet_params, 3)
    jlora.save_lora(lora, str(tmp_path / "a.safetensors"))
    x = rng.standard_normal((2, 8, 8, 9)).astype(np.float32)
    emb = np.asarray(jm.embeds_rgb[1:])
    merged = jlora.merge_lora_strict(jm.unet_params,
                                     jlora.load_lora(str(tmp_path /
                                                         "a.safetensors")))
    apply = jax.jit(lambda p: jm.unet.apply({"params": p}, x, 321, emb))
    ref = apply(merged)
    unet_ad, text_ad = tlora.split_adapters(str(tmp_path / "a.safetensors"))
    assert text_ad is None
    tlora.merge_lora_strict(tm.unet, unet_ad, source="a.safetensors")
    got = tm.unet(t(x), 321, t(emb))
    close(got, ref)
    base = apply(jm.unet_params)
    assert float(np.abs(np.asarray(ref) - np.asarray(base)).max()) > 1e-3


def test_port_adapter_file_merges_in_jax(tmp_path, stack, rng):
    jm, tm = stack["mods"]()
    ad = tlora.init_lora(tm.unet, rank=4,
                         generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    ad = {k: (v if k.endswith("lora_A") else
              0.03 * torch.randn(v.shape, generator=g))
          for k, v in ad.items()}
    tlora.save_lora(ad, str(tmp_path / "p.safetensors"))
    x = rng.standard_normal((2, 8, 8, 9)).astype(np.float32)
    emb = np.asarray(jm.embeds_rgb[1:])
    unet_ad, text_ad = jlora.split_adapters(str(tmp_path / "p.safetensors"))
    assert text_ad is None
    ref = jax.jit(lambda p: jm.unet.apply({"params": p}, x, 17, emb))(
        jlora.merge_lora_strict(jm.unet_params, unet_ad))
    eff = tlora.apply_lora(tm.unet, ad)
    got = torch.func.functional_call(tm.unet, eff, (t(x), 17, t(emb)))
    close(got, ref)


def test_adapter_count_and_layout_match_jax(stack):
    jm, tm = stack["mods"]()
    jl = jlora.init_lora(jax.random.PRNGKey(0), jm.unet_params, rank=32)
    flat = {k.replace("/", "."): a for k, a in _flat(jl)}
    tl = tlora.init_lora(tm.unet, rank=32, a_init=flat)
    assert tlora.lora_param_count(tl) == jlora.lora_param_count(jl)
    assert {k: tuple(v.shape) for k, v in tl.items()} == {
        k: a.shape for k, a in flat.items()}
    for k, a in flat.items():        # A injected, B zero as in JAX
        np.testing.assert_array_equal(tl[k].numpy(), a, err_msg=k)
    jt = jlora.init_lora(jax.random.PRNGKey(0), stack["tp"], rank=4,
                         targets=jlora.TEXT_TARGETS)
    tt = tlora.init_lora(stack["tt"], rank=4, targets=tlora.TEXT_TARGETS)
    assert {k: tuple(v.shape) for k, v in tt.items()} == {
        k.replace("/", "."): a.shape for k, a in _flat(jt)}


@pytest.mark.parametrize("fault", ["no_such_param", "rows", "b_shape"])
def test_mismatched_adapters_raise_in_both(tmp_path, stack, fault):
    jm, tm = stack["mods"]()
    lora = {k.replace("/", "."): a
            for k, a in _flat(_jax_adapters(jm.unet_params, 5))}
    key = next(k for k in lora if k.endswith("attn1.to_q.kernel.lora_A"))
    if fault == "no_such_param":
        lora["nowhere.kernel.lora_A"] = lora[key]
        lora["nowhere.kernel.lora_B"] = lora[key[:-1] + "B"]
    elif fault == "rows":
        lora[key] = lora[key][1:]
    else:
        lora[key[:-1] + "B"] = lora[key[:-1] + "B"][:, 1:]
    from safetensors.numpy import save_file

    save_file(lora, str(tmp_path / "bad.safetensors"))
    with pytest.raises(ValueError, match="does not fit"):
        jlora.merge_lora_strict(jm.unet_params, jlora.load_lora(
            str(tmp_path / "bad.safetensors")))
    with pytest.raises(ValueError, match="does not fit"):
        tlora.merge_lora_strict(tm.unet, tlora.load_lora(
            str(tmp_path / "bad.safetensors")))


def test_peft_lora_merges(tmp_path):
    """A PEFT-style LoRA dict merges into the base: W ← W + (α/r)·B@A on the
    targeted projections, as the JAX package's test of the same name."""
    from safetensors.numpy import save_file

    rng = np.random.default_rng(0)
    base = {
        "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q.weight":
            rng.normal(0, 0.02, (32, 32)).astype(np.float32),
        "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_k.weight":
            rng.normal(0, 0.02, (32, 32)).astype(np.float32),
        "down_blocks.0.attentions.0.proj_in.weight":
            rng.normal(0, 0.02, (32, 32, 1, 1)).astype(np.float32),
    }
    r = 4
    lora = {}
    for key, w in base.items():
        stem = key[: -len(".weight")]
        lora[f"base_model.model.{stem}.lora_A.weight"] = \
            rng.normal(0, 0.1, (r, *w.shape[1:])).astype(np.float32)
        lora[f"base_model.model.{stem}.lora_B.weight"] = \
            rng.normal(0, 0.1, (w.shape[0], r, *w.shape[2:])).astype(
                np.float32)
    d = tmp_path / "lora"
    d.mkdir()
    save_file(lora, str(d / "adapter_model.safetensors"))
    ref = jweights.merge_lora_state_dict(base, str(d), rank=r)
    got = tweights.merge_lora_state_dict(
        {k: torch.from_numpy(v) for k, v in base.items()}, str(d), rank=r)
    for key in base:
        np.testing.assert_allclose(got[key].numpy(), ref[key], rtol=1e-6,
                                   atol=1e-7, err_msg=key)
        stem = key[: -len(".weight")]
        A = lora[f"base_model.model.{stem}.lora_A.weight"].reshape(r, -1)
        B = lora[f"base_model.model.{stem}.lora_B.weight"].reshape(-1, r)
        np.testing.assert_allclose(got[key].numpy().reshape(32, -1),
                                   base[key].reshape(32, -1) + B @ A,
                                   rtol=1e-5, atol=1e-6)


# ---------- the train step ----------

def _jax_loss_fn(step):
    """The JAX step's loss_fn and frozen towers, out of its closures (the
    jitted _step wraps loss_fn)."""
    cells = dict(zip(step.__code__.co_freevars,
                     (c.cell_contents for c in step.__closure__)))
    inner = cells["_step"].__wrapped__
    inner_cells = dict(zip(inner.__code__.co_freevars,
                           (c.cell_contents for c in inner.__closure__)))
    return inner_cells["loss_fn"], cells["frozen"]


def _jax_draws(key, B, lr):
    k_noise, k_t, k_enc1, k_enc2 = jax.random.split(key, 4)
    shape = (B, lr, lr, 4)
    return {"t": torch.from_numpy(np.array(
                jax.random.randint(k_t, (B,), 0, 1000))).long(),
            "noise": t(jax.random.normal(k_noise, shape)),
            "enc_eps": t(jax.random.normal(k_enc1, shape, jnp.float32)),
            "enc_masked_eps": t(jax.random.normal(k_enc2, shape,
                                                  jnp.float32))}


def _jax_lora(tree, seed):
    """A JAX adapter tree with B drawn (so both A's and B's gradients are
    non-zero) and the same values as port tensors."""
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map_with_path(
        lambda p, a: (np.asarray(a) if p[-1].key == "lora_A" else
                      0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        tree)
    flat = {k.replace("/", "."): torch.from_numpy(a.copy()).requires_grad_()
            for k, a in _flat(tree)}
    return tree, flat


@pytest.mark.parametrize("variant", ["plain", "masked", "prior", "text"])
def test_lora_step_loss_and_grads_match_jax(stack, rng, variant):
    jm, tm = stack["mods"]()
    B, S = (4 if variant == "prior" else 2), 128
    text = variant == "text"
    kw = dict(rank=4, masked_loss=variant in ("masked", "prior"),
              prior_preservation=variant == "prior", prior_loss_weight=0.7)
    jinit, jstep = jtrainer.make_lora_train_step(
        jm, text_tower=(stack["jt"], stack["tp"]) if text else None, **kw)
    _, tstep = ttrainer.make_lora_train_step(
        tm, text_tower=stack["tt"] if text else None, **kw)
    jl, _ = jinit(jax.random.PRNGKey(2))
    jl, tl = _jax_lora(jl, 9)
    masks = np.stack([jtrainer.random_mask(np.random.default_rng(i), S, S)
                      for i in range(B)]).astype(np.uint8)
    imask = (rng.random((B, S, S)) > 0.5).astype(np.uint8)
    batch = {"image": rng.integers(0, 256, (B, S, S, 3), dtype=np.uint8),
             "mask": masks, "instance_mask": imask if kw["masked_loss"]
             else None}
    if text:
        batch["input_ids"] = np.stack(
            [(np.arange(77) * 7 + 31 * i) % 49000 for i in range(B)]
        ).astype(np.int32)
    else:
        batch["embeds"] = rng.standard_normal((B, 77, 32)).astype(np.float32)
    key = jax.random.PRNGKey(13)
    jloss_fn, frozen = _jax_loss_fn(jstep)
    jb = {k: (None if v is None else jnp.asarray(v)) for k, v in batch.items()}
    ref, rg = jax.jit(jax.value_and_grad(jloss_fn))(jl, frozen, jb, key)
    tb = {k: (None if v is None else torch.from_numpy(v))
          for k, v in batch.items()}
    got = tstep.loss_fn(tl, tb, _jax_draws(key, B, S // 8))
    got.backward()
    close(got, ref)
    rg = {k.replace("/", "."): a for k, a in _flat(rg)}
    assert rg.keys() == tl.keys()
    gmax = max(float(np.abs(a).max()) for a in rg.values())
    assert gmax > 0
    for k, a in rg.items():
        np.testing.assert_allclose(tl[k].grad.numpy(), a, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_FRAC * gmax, err_msg=k)
    if text:
        assert any(k.startswith("text.") and
                   float(np.abs(a).max()) > 0 for k, a in rg.items())


# ---------- host streams, the dataset, resume ----------

def test_random_mask_matches_jax():
    for seed in range(6):
        for shape in ((64, 64), (48, 80)):
            a = jtrainer.random_mask(np.random.default_rng(seed), *shape,
                                     ratio=(0.15, 0.6))
            b = ttrainer.random_mask(np.random.default_rng(seed), *shape,
                                     ratio=(0.15, 0.6))
            np.testing.assert_array_equal(a, b)


def _instance_dir(root, n=3, H=24, W=32):
    rng = np.random.default_rng(4)
    img, lab = root / "img", root / "label"
    img.mkdir()
    lab.mkdir()
    for k in range(n):
        write_png(str(img / f"img_{k:03d}.png"),
                  rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
        (img / f"img_{k:03d}.txt").write_text(f"caption {k}")
        m = np.zeros((H, W), np.uint8)
        m[4 + k:12 + k, 6:20] = 255
        write_png(str(lab / f"img_{k:03d}.png"), m)
    return img, lab


def test_dataset_batches_match_jax(tmp_path):
    """Batch indices, random masks and captions from one numpy seed are
    equal; the images (INTER_AREA, enlarging 24 × 32 → 40²) within one
    level of cv2; the instance masks (INTER_NEAREST) equal."""
    img, lab = _instance_dir(tmp_path)
    jd = jtrainer.DreamBoothInpaintDataset(str(img), mask_dir=str(lab),
                                           resolution=40)
    td = ttrainer.DreamBoothInpaintDataset(str(img), mask_dir=str(lab),
                                           resolution=40)
    ja, ta = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(3):
        ji, jm, jc, jk = jd.batch(ja, 4)
        ti, tm_, tc, tk = td.batch(ta, 4)
        assert jc == tc
        np.testing.assert_array_equal(jm, tm_)
        np.testing.assert_array_equal(jk, tk)
        assert np.abs(ji.astype(int) - ti.astype(int)).max() <= 1
    assert ja.bit_generator.state == ta.bit_generator.state


def _direct_batch(img, lab, res, default, rng, B):
    """The batch as read before the dataset held its items: each sample's
    PNG decoded and area-resized, its mask decoded, nearest-resized and
    thresholded, its caption read, all at the draw."""
    from gbnerf_tpu_torch.data.llff import (_imread, resize_area,
                                            resize_nearest)

    files = sorted(str(p) for p in img.iterdir() if p.suffix == ".png")
    idx = rng.integers(0, len(files), B)
    masks = np.stack([ttrainer.random_mask(rng, res, res)
                      for _ in range(B)]).astype(np.uint8)
    imgs, caps, imasks = [], [], []
    for i in idx:
        stem = os.path.splitext(os.path.basename(files[i]))[0]
        imgs.append(resize_area(_imread(files[i])[..., :3], res, res))
        txt = img / (stem + ".txt")
        caps.append(txt.read_text().strip() if txt.exists() else default)
        m = lab / (stem + ".png")
        imasks.append(
            (resize_nearest(_imread(str(m)).astype(np.float32), res, res)
             > 127).astype(np.uint8) if m.exists()
            else np.ones((res, res), np.uint8))
    return np.stack(imgs), masks, caps, np.stack(imasks)


@pytest.mark.parametrize("H,W,res", [(24, 32, 40), (32, 32, 32)])
def test_dataset_batches_equal_a_direct_decode(tmp_path, H, W, res):
    """The held items against a decode at every draw: over 3 seeds and 6
    batches the images, random masks, instance masks and captions are
    bit-equal and laid out alike in memory, with one image lacking its
    mask and another its caption, at an enlarging and at an identity
    size; the rng ends in the same state."""
    img, lab = _instance_dir(tmp_path, n=4, H=H, W=W)
    (lab / "img_001.png").unlink()
    (img / "img_002.txt").unlink()
    ds = ttrainer.DreamBoothInpaintDataset(str(img), mask_dir=str(lab),
                                           resolution=res,
                                           default_caption="a default")
    for seed in (0, 7, 2**31 + 5):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        for _ in range(6):
            got = ds.batch(a, 5)
            ref = _direct_batch(img, lab, res, "a default", b, 5)
            assert got[2] == ref[2]
            for g, r in zip(got[:2] + got[3:], ref[:2] + ref[3:]):
                assert g.dtype == r.dtype == np.uint8
                assert g.strides == r.strides    # the VAE's memory format
                np.testing.assert_array_equal(g, r)
        assert a.bit_generator.state == b.bit_generator.state


def test_dataset_decodes_once_and_again_for_a_changed_file(tmp_path):
    """Building decodes each item once; batches add no decode. An image
    rewritten with other pixels, a mask file removed, a caption rewritten
    and an mtime moved alone each cost exactly one decode, and the next
    batch serves what is on disk."""
    import copy as _copy

    from gbnerf_tpu_torch.utils.png import write_png

    img, lab = _instance_dir(tmp_path, n=3)
    ds = ttrainer.DreamBoothInpaintDataset(str(img), mask_dir=str(lab),
                                           resolution=40)
    assert ds.decodes == 3
    rng = np.random.default_rng(11)
    for _ in range(5):
        ds.batch(rng, 4)
    assert ds.decodes == 3

    def batch_with_item_1():
        probe = _copy.deepcopy(rng)
        assert 1 in probe.integers(0, 3, 12)
        ref = _direct_batch(img, lab, 40, "", _copy.deepcopy(rng), 12)
        got = ds.batch(rng, 12)
        assert got[2] == ref[2]
        for g, r in zip(got[:2] + got[3:], ref[:2] + ref[3:]):
            np.testing.assert_array_equal(g, r)
        return got

    write_png(str(img / "img_001.png"), np.random.default_rng(5).integers(
        0, 256, (30, 20, 3), dtype=np.uint8))
    batch_with_item_1()
    assert ds.decodes == 4
    (lab / "img_001.png").unlink()
    (img / "img_001.txt").write_text("a longer new caption")
    got = batch_with_item_1()
    assert ds.decodes == 5 and "a longer new caption" in got[2]
    st = os.stat(img / "img_001.png")
    os.utime(img / "img_001.png", ns=(st.st_atime_ns,
                                      st.st_mtime_ns + 10**9))
    batch_with_item_1()
    assert ds.decodes == 6
    for _ in range(3):
        ds.batch(rng, 4)
    assert ds.decodes == 6


def test_dataset_batches_are_copies_of_a_read_only_store(tmp_path):
    """A batch written in place leaves the next batch as it was; the held
    arrays refuse writes; image() and instance_mask() hand out writable
    copies (float32 masks, as before the store)."""
    img, lab = _instance_dir(tmp_path)
    ds = ttrainer.DreamBoothInpaintDataset(str(img), mask_dir=str(lab),
                                           resolution=40)
    first = ds.batch(np.random.default_rng(3), 4)
    kept = [a.copy() for a in (first[0], first[1], first[3])]
    for a in (first[0], first[1], first[3]):
        a[...] = 9
    again = ds.batch(np.random.default_rng(3), 4)
    for k, a in zip(kept, (again[0], again[1], again[3])):
        np.testing.assert_array_equal(k, a)
    held = ds._item(0)
    for a in (held.image, held.mask):
        assert not a.flags.writeable
        with pytest.raises(ValueError):
            a[0, 0] = 1
    im, m = ds.image(0), ds.instance_mask(0)
    assert im.flags.writeable and m.dtype == np.float32
    im[...] = 0
    m[...] = 5
    np.testing.assert_array_equal(ds.image(0), held.image)
    np.testing.assert_array_equal(ds.instance_mask(0), held.mask)


def _tiny_mods():
    from gbnerf_tpu_torch.config import GuidanceConfig
    from gbnerf_tpu_torch.guidance import stable as tst
    from gbnerf_tpu_torch.guidance.text import CLIPTextConfig
    from gbnerf_tpu_torch.guidance.unet import UNetConfig
    from gbnerf_tpu_torch.guidance.vae import VAEConfig

    return tst.build_sd_modules(
        GuidanceConfig(prompt="a thing"), torch.Generator().manual_seed(0),
        unet_config=UNetConfig.tiny(), vae_config=VAEConfig.tiny(),
        text_config=CLIPTextConfig(vocab_size=49408, width=32, layers=2,
                                   heads=2), latent_size=64,
        dtype=torch.float32)


def test_lora_resume_is_bit_exact(tmp_path):
    """train(4) against train(2) then resume('latest') to 4: the same
    adapters, AdamW moments and generator state, bit for bit; the files
    are the JAX package's layout (its restore reads the state)."""
    img, lab = _instance_dir(tmp_path)
    mods = _tiny_mods()
    ds = ttrainer.DreamBoothInpaintDataset(str(img), mask_dir=str(lab),
                                           resolution=64)
    emb3 = mods.embeds_rgb

    def encode(captions, rng=None):
        return emb3[torch.as_tensor(rng.integers(0, 3, len(captions)))]

    kw = dict(batch_size=2, rank=4, lr=1e-3, seed=5, masked_loss=True,
              checkpointing_steps=2, log_every=100)
    full = ttrainer.train_lora(mods, ds, encode, steps=4,
                               output_dir=str(tmp_path / "a"), **kw)
    ttrainer.train_lora(mods, ds, encode, steps=2,
                        output_dir=str(tmp_path / "b"), **kw)
    resumed = ttrainer.train_lora(mods, ds, encode, steps=4,
                                  output_dir=str(tmp_path / "b"),
                                  resume_from="latest", **kw)
    assert any(v.abs().max().item() > 0 for k, v in full.items()
               if k.endswith("lora_B"))
    for k in full:
        assert torch.equal(full[k], resumed[k]), k
    for name in ("state.msgpack", "meta.json"):
        a = (tmp_path / "a" / "checkpoint-4" / name).read_bytes()
        b = (tmp_path / "b" / "checkpoint-4" / name).read_bytes()
        assert a == b, name
    # the JAX package's restore reads the port's state file
    jl = {k: np.zeros(v.shape, np.float32) for k, v in full.items()}
    from flax import serialization

    state = serialization.msgpack_restore(
        (tmp_path / "a" / "checkpoint-4" / "state.msgpack").read_bytes())
    assert int(state["opt"]["0"]["count"]) == 4
    flat = {k.replace("/", "."): a for k, a in _flat(state["lora"])}
    assert flat.keys() == jl.keys()
    for k in full:
        np.testing.assert_array_equal(flat[k], full[k].detach().numpy())
    meta = json.loads((tmp_path / "a" / "checkpoint-4" / "meta.json")
                      .read_text())
    assert meta["step"] == 4 and os.path.isfile(
        tmp_path / "a" / "lora_000004.safetensors")
