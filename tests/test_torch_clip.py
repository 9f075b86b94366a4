"""Port vs JAX: CLIP guidance — ``CLIPVisionEncoder`` (the text tower's
layers with a zero mask) and ``CLIPGuidance`` (the prompt's EOS embedding
through the random text projection, the loss −⟨z_image, z_text⟩·scale
and its gradient with respect to the image) at ``CLIPVisionConfig.tiny()``
and the tiny text tower, with the JAX package's weights carried across by
``convert.clip_vision_params_from_jax`` and the text rules of
``convert.sd_params_from_jax``, and its projection draw handed over.

Tolerances, with their reasons: f32 on both sides, the same formulas
(LayerNorms, attention, the resize to the tower's size) summed in another
order: the embeddings, the loss and its gradient to rtol 1e-4 with atol
1e-5·max|ref| (the gradient 1e-4·max|ref|: it passes back through the
layers and the resize's weights).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gbnerf_tpu.guidance import clip_guidance as jclip
from gbnerf_tpu.guidance import text as jtext
from gbnerf_tpu_torch import convert
from gbnerf_tpu_torch.guidance import clip_guidance as tclip
from gbnerf_tpu_torch.guidance import text as ttext

from _sd_pair import close, t

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    """The JAX package's CLIPGuidance at the tiny sizes, and the port's
    with the same towers and projection (the JAX text params and
    projection recomputed from its keys)."""
    key = jax.random.PRNGKey(3)
    vcfg, tcfg = jclip.CLIPVisionConfig.tiny(), jtext.CLIPTextConfig.tiny()
    j = jclip.CLIPGuidance(key, "a chair by the window", vision_config=vcfg,
                           text_config=tcfg)
    _, k2, k3 = jax.random.split(key, 3)
    text = jtext.CLIPTextEncoder(tcfg)
    tparams = jax.jit(text.init)(
        k2, jnp.zeros((1, tcfg.max_length), jnp.int32))["params"]
    proj = jax.random.normal(k3, (tcfg.width, vcfg.projection_dim)) \
        / jnp.sqrt(tcfg.width)
    np_tree = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    ttower = ttext.CLIPTextEncoder(ttext.CLIPTextConfig.tiny())
    ttower.load_state_dict(convert.sd_params_from_jax(
        {}, {}, np_tree(tparams))[2], strict=True)
    tg = tclip.CLIPGuidance(
        "a chair by the window", vision_config=tclip.CLIPVisionConfig.tiny(),
        text_config=ttext.CLIPTextConfig.tiny(), text_model=ttower,
        text_projection=t(proj))
    tg.vision.load_state_dict(convert.clip_vision_params_from_jax(
        np_tree(j.vision_params)), strict=True)
    return j, tg


def test_text_embedding_matches_jax(pair):
    j, tg = pair
    close(tg.text_embed, j.text_embed, rtol=1e-4, atol_frac=1e-5)
    np.testing.assert_allclose(float(torch.linalg.norm(tg.text_embed)), 1.0,
                               rtol=1e-6)


@pytest.mark.parametrize("hw", [(20, 28), (48, 40)])
def test_vision_tower_loss_and_grad_match_jax(pair, rng, hw):
    """Images resized up (20 × 28) and down (48 × 40, antialiased as
    jax.image.resize) to the tower's 32²."""
    j, tg = pair
    img = rng.random(hw + (3,)).astype(np.float32)
    z_ref = j.vision.apply({"params": j.vision_params}, img[None])
    close(tg.vision(t(img)[None]), z_ref, rtol=1e-4, atol_frac=1e-5)
    ref, rg = jax.jit(jax.value_and_grad(lambda x: j.loss(x, 2.5)))(img)
    x = t(img).requires_grad_(True)
    got = tg.loss(x, 2.5)
    got.backward()
    close(got, ref, rtol=1e-4, atol_frac=1e-5)
    close(x.grad, rg, rtol=1e-4, atol_frac=1e-4)
    assert float(np.abs(np.asarray(rg)).max()) > 0


def test_clip_guidance_builds_random_towers_from_a_generator():
    """Without towers given, the generator draws both towers and the
    projection: the same seed gives the same loss."""
    losses = []
    for _ in range(2):
        g = tclip.CLIPGuidance(
            "a prompt", torch.Generator().manual_seed(4),
            vision_config=tclip.CLIPVisionConfig.tiny(),
            text_config=ttext.CLIPTextConfig.tiny())
        losses.append(float(g.loss(torch.full((16, 16, 3), 0.5))))
    assert losses[0] == losses[1] and np.isfinite(losses[0])
    assert -1.0 <= losses[0] <= 1.0
