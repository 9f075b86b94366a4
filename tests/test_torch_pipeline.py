"""Port vs JAX: the offline DDIM inpainting pipeline on the tiny
SD1.5-inpainting stack (guidance/pipeline.py): ``get_timesteps``,
``inpaint`` with the JAX package's draws injected (2-way SDS from pure
noise, and the 3-way BSD combine at strength < 1 through ``add_noise``),
``prompt_to_img`` (inpaint under a full mask), and the LoRA trainer's
class images written through it.

The weights and the prompt embeddings: tests/_sd_pair.py. Tolerances,
with their reasons: f32 on both sides; the image after 3 DDIM steps and
the VAE decode to rtol 1e-4 with atol 1e-5·max|ref|, as every forward
activation of the stack (each step's ε enters the next step's input, and
the CFG scale amplifies the UNet's ≈ 1e-6 relative rounding). The
timesteps: equal.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gbnerf_tpu.guidance import pipeline as jpipe
from gbnerf_tpu_torch.guidance import pipeline as tpipe
from gbnerf_tpu_torch.train import lora_trainer as ttrainer
from gbnerf_tpu_torch.utils.png import read_png

from _sd_pair import close, make_stack, t

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def stack():
    return make_stack()


@pytest.mark.parametrize("steps,strength", [(50, 1.0), (3, 1.0), (10, 0.75),
                                            (7, 0.3), (4, 0.0), (20, 1.5)])
def test_get_timesteps_match_jax(steps, strength):
    np.testing.assert_array_equal(tpipe.get_timesteps(steps, strength),
                                  jpipe.get_timesteps(steps, strength))


def _draws(key, lr):
    k_lat, k_enc1, k_enc2 = jax.random.split(key, 3)
    shape = (1, lr, lr, 4)
    return {"noise": t(jax.random.normal(k_lat, shape)),
            "enc_masked_eps": t(jax.random.normal(k_enc1, shape,
                                                  jnp.float32)),
            "enc_init_eps": t(jax.random.normal(k_enc2, shape, jnp.float32))}


@pytest.mark.parametrize("use_csd,steps,strength", [(False, 3, 1.0),
                                                    (True, 4, 0.75)])
def test_inpaint_matches_jax(stack, rng, use_csd, steps, strength):
    """3 DDIM steps each: SDS from pure noise; BSD from the encoded image
    noised to the first of 4 · 0.75 = 3 timesteps."""
    jm, tm = stack["mods"]()
    image = rng.random((40, 48, 3)).astype(np.float32)
    mask = np.zeros((40, 48), np.float32)
    mask[10:30, 12:36] = 1.0
    key = jax.random.PRNGKey(5)
    kw = dict(num_inference_steps=steps, strength=strength, use_csd=use_csd,
              guidance_scale=4.0, w1=2.0, w2=1.5, w3=0.5)
    ref = jax.jit(lambda im, m: jpipe.inpaint(jm, jm.embeds_rgb, im, m, key,
                                              **kw))(image, mask)
    got = tpipe.inpaint(tm, tm.embeds_rgb, t(image), t(mask),
                        **kw, **_draws(key, 8))
    assert got.shape == (64, 64, 3) and got.dtype == torch.float32
    close(got, ref)
    assert 0.0 <= float(got.min()) and float(got.max()) <= 1.0
    assert float(got.std()) > 0.01


def test_prompt_to_img_is_inpaint_under_a_full_mask(stack):
    """prompt_to_img is inpaint of a blank image under a full mask, as the
    JAX package's. It is not held against the JAX package directly: its
    conditioning image is constant, whose VAE encode is ill-conditioned
    in f32 (flax's GroupNorm takes the variance as E[x²] − E[x]², which
    on a constant group is rounding; the two packages' latents of a zero
    image differ by 2.5e-3 of their scale). inpaint itself is held above."""
    _, tm = stack["mods"]()
    d = _draws(jax.random.PRNGKey(9), 8)
    got = tpipe.prompt_to_img(tm, tm.embeds_rgb, steps=2, noise=d["noise"],
                              enc_masked_eps=d["enc_masked_eps"])
    ref = tpipe.inpaint(tm, tm.embeds_rgb, torch.zeros((64, 64, 3)),
                        torch.ones((64, 64)), num_inference_steps=2,
                        strength=1.0, noise=d["noise"],
                        enc_masked_eps=d["enc_masked_eps"])
    assert torch.equal(got, ref) and got.shape == (64, 64, 3)


def test_class_images_are_written_through_the_pipeline(tmp_path, stack):
    """generate_class_images tops the dir up to the count, as PNGs at the
    asked resolution, and draws from its generator (seeded: the same
    images twice)."""
    _, tm = stack["mods"]()
    for run in ("a", "b"):
        d = tmp_path / run
        d.mkdir()
        (d / "class_00000.png").write_bytes(b"")          # one exists
        n = ttrainer.generate_class_images(
            tm, tm.embeds_rgb, str(d), 3, torch.Generator().manual_seed(4),
            num_inference_steps=2, resolution=32)
        assert n == 2
        assert sorted(p.name for p in d.iterdir()) == [
            "class_00000.png", "class_00001.png", "class_00002.png"]
    for name in ("class_00001.png", "class_00002.png"):
        a = read_png(str(tmp_path / "a" / name))
        assert a.shape == (32, 32, 3) and a.dtype == np.uint8
        np.testing.assert_array_equal(a, read_png(str(tmp_path / "b" / name)))
    assert ttrainer.generate_class_images(tm, tm.embeds_rgb,
                                          str(tmp_path / "a"), 3) == 0
