"""The port's default initial parameters (drawn from a torch.Generator)
against the JAX package's Flax ``init`` of the same modules, in
distribution: every parameter of the tiny SD stack (UNet, VAE, CLIP text
tower, as ``build_sd_modules`` makes them), of CLIP guidance's vision
tower and its text tower (``blocks.init_weights_`` as ``CLIPGuidance``
calls it), of the random LPIPS VGG and of both fields (the CP grid and the
NeRF MLP). The values differ (other streams); the distributions may not.

Per leaf, in the flax tree's layout:
- a constant leaf (zero biases and shifts, unit scales) equals the JAX
  package's exactly;
- otherwise the two sample stds differ by at most 4/√n of their mean, n
  the leaf's size: the difference of two independent sample stds of n
  draws has a standard error of √(1/(2n) + 1/(2n)) = 1/√n of σ, so this
  is 4 of its standard errors, σ estimated by the two stds' mean (a
  truncated normal's sample std varies less);
- a Dense or Conv kernel (Flax's ``lecun_normal``, a normal truncated at
  ±2 of σ = (1/√fan_in) / 0.87962566) lies within ±2σ, as the JAX
  package's does.
"""
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gbnerf_tpu_torch import convert

torch.set_num_threads(1)
TEXT_CFG = dict(vocab_size=49408, width=32, layers=2, heads=2)
TRUNC = 0.87962566103423978


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v, np.float64)


def assert_same_distributions(ref_tree, got_tree):
    got = dict(_leaves(got_tree))
    ref = dict(_leaves(ref_tree))
    assert got.keys() == ref.keys()
    bad = []
    for path, r in ref.items():
        g = got[path]
        name = "/".join(path)
        assert g.shape == r.shape, name
        if r.std() == 0.0:
            if not np.array_equal(g, r):
                bad.append(f"{name}: not the constant {r.flat[0]}")
            continue
        n = r.size
        if abs(g.std() - r.std()) > 4.0 / math.sqrt(n) * 0.5 * (
                g.std() + r.std()):
            bad.append(f"{name}: std {g.std():.4g} vs {r.std():.4g} "
                       f"(n {n})")
        if path[-1] == "kernel":
            lim = 2.0 / math.sqrt(np.prod(r.shape[:-1])) / TRUNC
            assert np.abs(r).max() <= lim * (1 + 1e-6), name
            if np.abs(g).max() > lim * (1 + 1e-6):
                bad.append(f"{name}: max |w| {np.abs(g).max():.4g} beyond "
                           f"the truncation {lim:.4g}")
    assert not bad, "\n".join(bad)


@pytest.fixture(scope="module")
def port_sd():
    """The tiny stack as build_sd_modules makes it from a torch generator,
    in flax layout: {unet, vae, text}."""
    from gbnerf_tpu_torch.config import GuidanceConfig
    from gbnerf_tpu_torch.guidance import stable as tst
    from gbnerf_tpu_torch.guidance import text as ttext
    from gbnerf_tpu_torch.guidance import unet as tunet
    from gbnerf_tpu_torch.guidance import vae as tvae

    mods = tst.build_sd_modules(
        GuidanceConfig(prompt="a thing"), torch.Generator().manual_seed(1),
        unet_config=tunet.UNetConfig.tiny(),
        vae_config=tvae.VAEConfig.tiny(),
        text_config=ttext.CLIPTextConfig(**TEXT_CFG), latent_size=64,
        dtype=torch.float32)
    return dict(zip(("unet", "vae", "text"), convert.sd_params_to_jax(
        mods.unet, mods.vae, mods.text_model)))


@pytest.mark.parametrize("tower", ["unet", "vae", "text"])
def test_tiny_sd_stack_init_has_flax_distributions(port_sd, tower):
    from gbnerf_tpu.guidance.text import CLIPTextConfig, CLIPTextEncoder
    from gbnerf_tpu.guidance.unet import UNet2DCondition, UNetConfig
    from gbnerf_tpu.guidance.vae import AutoencoderKL, VAEConfig

    keys = dict(zip(("unet", "vae", "text"),
                    jax.random.split(jax.random.PRNGKey(1), 3)))
    tc = CLIPTextConfig(**TEXT_CFG)
    if tower == "unet":
        S = jax.ShapeDtypeStruct
        uc = UNetConfig.tiny()
        ref = UNet2DCondition(uc, dtype=jnp.float32).lazy_init(
            keys[tower], S((1, 8, 8, uc.in_channels), jnp.float32),
            S((), jnp.float32),
            S((1, tc.max_length, uc.cross_attention_dim), jnp.float32))
    elif tower == "vae":
        ref = jax.jit(AutoencoderKL(VAEConfig.tiny(),
                                    dtype=jnp.float32).init)(
            keys[tower], jnp.zeros((1, 8, 8, 3)))
    else:
        ref = jax.jit(CLIPTextEncoder(tc, dtype=jnp.float32).init)(
            keys[tower], jnp.zeros((1, tc.max_length), jnp.int32))
    assert_same_distributions(ref["params"], port_sd[tower])


@pytest.mark.parametrize("tower", ["vision", "text"])
def test_clip_guidance_towers_init_have_flax_distributions(tower):
    from gbnerf_tpu.guidance import clip_guidance as jclip
    from gbnerf_tpu.guidance.text import CLIPTextConfig, CLIPTextEncoder
    from gbnerf_tpu_torch.guidance import clip_guidance as tclip
    from gbnerf_tpu_torch.guidance import text as ttext
    from gbnerf_tpu_torch.guidance.blocks import init_weights_

    k1, k2, _ = jax.random.split(jax.random.PRNGKey(2), 3)
    if tower == "vision":
        vcfg = jclip.CLIPVisionConfig.tiny()
        tg = tclip.CLIPGuidance("a thing", torch.Generator().manual_seed(2),
                                vision_config=tclip.CLIPVisionConfig.tiny(),
                                text_config=ttext.CLIPTextConfig(**TEXT_CFG))
        ref = jax.jit(jclip.CLIPVisionEncoder(vcfg).init)(
            k1, jnp.zeros((1, vcfg.image_size, vcfg.image_size, 3)))
        # the vision tower's flax names (convert.clip_vision_params_to_jax's
        # rules, written here so that the check runs on any port version)
        rules = [(r"^layers\.(\d+)\.(self_attn|mlp)\.", r"layers_\1."),
                 (r"^layers\.(\d+)\.", r"layers_\1.")]
        assert_same_distributions(ref["params"], convert.state_dict_to_flax(
            tg.vision.state_dict(), rules))
        return
    # the text tower as CLIPGuidance builds it when none is given
    tt = ttext.CLIPTextEncoder(ttext.CLIPTextConfig(**TEXT_CFG))
    init_weights_(tt, torch.Generator().manual_seed(3))
    tc = CLIPTextConfig(**TEXT_CFG)
    ref = jax.jit(CLIPTextEncoder(tc).init)(
        k2, jnp.zeros((1, tc.max_length), jnp.int32))
    assert_same_distributions(ref["params"],
                              convert.sd_params_to_jax(tt, tt, tt)[2])


def test_random_vgg_init_has_flax_distributions():
    from gbnerf_tpu.utils.lpips import VGG16Features as JVGG
    from gbnerf_tpu_torch.utils.lpips import VGG16Features

    net = VGG16Features(torch.Generator().manual_seed(4))
    got = {}
    for name, v in net.state_dict().items():
        conv, kind = name.split(".")
        a = v.numpy()
        got.setdefault(conv, {})["kernel" if kind == "weight" else "bias"] = (
            a.transpose(2, 3, 1, 0) if kind == "weight" else a)
    ref = JVGG().lazy_init(jax.random.PRNGKey(4),
                           jax.ShapeDtypeStruct((1, 32, 32, 3), jnp.float32))
    assert_same_distributions(ref["params"], got)


def test_cp_and_mlp_fields_init_have_flax_distributions():
    from gbnerf_tpu.core.cp_field import CPGridField as JCP
    from gbnerf_tpu.core.fields import NeRFMLP as JMLP
    from gbnerf_tpu_torch.core.cp_field import CPGridField
    from gbnerf_tpu_torch.core.fields import NeRFMLP

    pts, dirs = jnp.zeros((8, 3)), jnp.ones((8, 3)) / jnp.sqrt(3.0)
    cp = dict(bound=2.0, resolutions=(17, 33, 65), rank=8)
    mlp = dict(depth=4, width=64, skips=(2,), multires=4, multires_views=2)
    for jmod, tmod in ((JCP(**cp), CPGridField(
            **cp, generator=torch.Generator().manual_seed(5))),
                       (JMLP(**mlp), NeRFMLP(
            **mlp, generator=torch.Generator().manual_seed(6)))):
        ref = jax.jit(jmod.init)(jax.random.PRNGKey(5), pts, dirs)
        assert_same_distributions(
            ref["params"],
            convert.params_to_jax({"f": tmod.state_dict()})["f"])
