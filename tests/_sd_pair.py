"""The tiny SD1.5-inpainting stack in both packages with the same weights,
for the port's guidance, score-distillation and stage-2 tests.

Random flax trees are made with numpy at the shapes of the JAX modules
(``jax.eval_shape``: no init compile) and carried into the port with
``convert.sd_params_from_jax`` (strict loads). The JAX package's random
draws (the noise ε, the VAE posterior ε) are recomputed from its keys with
``jax.random`` and handed to the port as tensors.
"""
import math

import numpy as np
import jax
import jax.numpy as jnp
import torch

from gbnerf_tpu.config import GuidanceConfig
from gbnerf_tpu.guidance import schedule as jsch
from gbnerf_tpu.guidance import stable as jst
from gbnerf_tpu.guidance import text as jtext
from gbnerf_tpu.guidance import unet as junet
from gbnerf_tpu.guidance import vae as jvae
from gbnerf_tpu_torch import convert
from gbnerf_tpu_torch.guidance import schedule as tsch
from gbnerf_tpu_torch.guidance import stable as tst
from gbnerf_tpu_torch.guidance import text as ttext
from gbnerf_tpu_torch.guidance import unet as tunet
from gbnerf_tpu_torch.guidance import vae as tvae

RTOL, ATOL_FRAC = 1e-4, 1e-5
TEXT_CFG = dict(vocab_size=49408, width=32, layers=2, heads=2)


def close(got, ref, rtol=RTOL, atol_frac=ATOL_FRAC, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=atol_frac * max(np.abs(ref).max(), 1e-30),
                               err_msg=msg)


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def fill(shapes, rng):
    """Random f32 values for a flax param tree of ShapeDtypeStructs: lecun
    normal kernels, scales 1 ± 0.1, biases ± 0.1, embeddings 0.02."""
    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            v = rng.standard_normal(s.shape) / math.sqrt(fan_in)
        elif name == "scale":
            v = 1.0 + 0.1 * rng.standard_normal(s.shape)
        elif name in ("embedding", "position_embedding"):
            v = 0.02 * rng.standard_normal(s.shape)
        else:
            v = 0.1 * rng.standard_normal(s.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def flax_params(module, rng, *args):
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    return fill(shapes["params"], rng)


def load(tmodule, tree):
    tmodule.load_state_dict(convert.flax_to_state_dict(tree), strict=True)
    return tmodule


def make_stack():
    """The tiny stack in both packages with the same weights (flax trees
    → ``sd_params_from_jax`` → strict loads) and the JAX text tower's
    prompt embeddings in both."""
    rng = np.random.default_rng(0)
    ju = junet.UNet2DCondition(junet.UNetConfig.tiny())
    jv = jvae.AutoencoderKL(jvae.VAEConfig.tiny())
    jt = jtext.CLIPTextEncoder(jtext.CLIPTextConfig(**TEXT_CFG))
    up = flax_params(ju, rng, jnp.zeros((1, 8, 8, 9)), jnp.zeros(()),
                      jnp.zeros((1, 77, 32)))
    vp = flax_params(jv, rng, jnp.zeros((1, 64, 64, 3)))
    tp = flax_params(jt, rng, jnp.zeros((1, 77), jnp.int32))
    usd, vsd, tsd = convert.sd_params_from_jax(up, vp, tp)
    tu = tunet.UNet2DCondition(tunet.UNetConfig.tiny())
    tv = tvae.AutoencoderKL(tvae.VAEConfig.tiny())
    tt = ttext.CLIPTextEncoder(ttext.CLIPTextConfig(**TEXT_CFG))
    for m, sd in ((tu, usd), (tv, vsd), (tt, tsd)):
        m.load_state_dict(sd, strict=True)
        m.requires_grad_(False)
    gcfg = GuidanceConfig(prompt="a thing", prompt_normal="a normal map",
                          negative_prompt="bad", normal_start_iter=500)
    tok = jtext.Tokenizer(None, 77, 49408)
    text_apply = jax.jit(jt.apply)
    emb = {k: np.asarray(text_apply({"params": tp}, tok(["", "bad", p])))
           for k, p in (("rgb", "a thing"), ("normal", "a normal map"))}

    def mods(latent_size=64):
        jm = jst.SDModules(unet=ju, unet_params=up, vae=jv, vae_params=vp,
                           schedule=jsch.DiffusionSchedule.sd_v1(),
                           embeds_rgb=jnp.asarray(emb["rgb"]),
                           embeds_normal=jnp.asarray(emb["normal"]),
                           latent_size=latent_size)
        tm = tst.SDModules(unet=tu, vae=tv,
                           schedule=tsch.DiffusionSchedule.sd_v1(),
                           embeds_rgb=t(emb["rgb"]),
                           embeds_normal=t(emb["normal"]),
                           latent_size=latent_size, text_model=tt,
                           tokenizer=ttext.Tokenizer(None, 77, 49408))
        return jm, tm

    return {"gcfg": gcfg, "mods": mods, "jt": jt, "tp": tp, "tt": tt,
            "emb": emb}


def draws(key, lr):
    """The three draws sd_train_step makes from its key, as the port takes
    them."""
    k_noise, k_enc1, k_enc2 = jax.random.split(key, 3)
    shape = (1, lr, lr, 4)
    return {"noise": t(jax.random.normal(k_noise, shape)),
            "enc_eps": t(jax.random.normal(k_enc1, shape, jnp.float32)),
            "enc_masked_eps": t(jax.random.normal(k_enc2, shape,
                                                   jnp.float32))}


def guidance_draws(key, lr):
    """The draws of make_guidance_fn's two modalities from its key."""
    k_rgb, k_n, _ = jax.random.split(key, 3)
    return {"rgb": draws(k_rgb, lr), "normal": draws(k_n, lr)}
