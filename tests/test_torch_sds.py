"""Port vs JAX: score distillation on the tiny SD1.5-inpainting stack —
``sd_train_step`` (2-way SDS and 3-way CSD, loss and d loss / d rgb, at
64² and at 256², where N = 1024 sends the UNet's and the VAE's
self-attention through the autograd Function, forward and backward),
``make_guidance_fn`` with its normal-map and use_negative gates, and the
masked-latents cache (``precompute_masked_latents``).

The weights and the draws: tests/_sd_pair.py (the same random weights in
both packages; the JAX package's noise and posterior draws recomputed from
its keys and handed to the port).

Tolerances, with their reasons: f32 on both sides. The SDS loss, rtol
1e-4: a sum over the latents in which the 7.5× CFG scale amplifies the
UNet's ≈ 1e-6 relative rounding. Its gradient with respect to the render,
atol 3e-4·max|ref| (and rtol 1e-4): the injected gradient carries that
amplified rounding through the VAE encoder's backward (a dozen
convolutions and GroupNorms summed in another order). The cached latents:
rtol 1e-4, atol 1e-5·max|ref|, as every forward activation.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gbnerf_tpu.guidance import stable as jst
from gbnerf_tpu_torch.guidance import stable as tst
from gbnerf_tpu_torch.ops import attention as tat

from _sd_pair import RTOL, close, draws, guidance_draws, make_stack, t

torch.set_num_threads(1)
GRAD_ATOL_FRAC = 3e-4


@pytest.fixture(scope="module")
def stack():
    return make_stack()


@pytest.mark.parametrize("latent_size,mode", [(64, "sds"), (64, "csd"),
                                              (256, "sds")])
def test_sd_train_step_loss_and_grad_match_jax(stack, rng, monkeypatch,
                                               latent_size, mode):
    """At 256² the UNet's first level (32² latents) and the VAE's mid block
    see N = 1024: the autograd Function's branch, forward and backward."""
    jm, tm = stack["mods"](latent_size)
    gcfg = stack["gcfg"]
    H, W = 24, 32
    rgb = rng.random((H, W, 3)).astype(np.float32)
    mask = (rng.random((H, W)) > 0.6).astype(np.float32)
    key = jax.random.PRNGKey(7)
    step_i = 1234

    def jloss(r):
        return jst.sd_train_step(jm, gcfg, step_i, r, mask, key,
                                 embeds=jm.embeds_rgb, guidance_scale=7.5,
                                 mode=mode)

    ref, rg = jax.jit(jax.value_and_grad(jloss))(rgb)
    applied = []
    real = tat._Attend.apply
    monkeypatch.setattr(tat._Attend, "apply",
                        lambda *a: applied.append(a[0].shape) or real(*a))
    x = t(rgb).requires_grad_(True)
    got = tst.sd_train_step(tm, gcfg, step_i, x, t(mask),
                            embeds=tm.embeds_rgb, guidance_scale=7.5,
                            mode=mode, **draws(key, latent_size // 8))
    got.backward()
    close(got, ref, rtol=RTOL)
    close(x.grad, rg, atol_frac=GRAD_ATOL_FRAC)
    assert float(np.abs(np.asarray(rg)).max()) > 0
    if latent_size == 256:
        # (BH, N, D): the UNet's 2 heads of 16 × 2 CFG copies, the VAE's
        # one head of 32 channels
        assert {s[1:] for s in applied} == {(1024, 16), (1024, 32)}, applied
    else:
        assert applied == []


def test_guidance_fn_gates_match_jax(stack, rng):
    """Both modalities, the normal term gated by normal_start_iter (500;
    its anneal restarts there) and the uncond slot by use_negative (600)."""
    jm, tm = stack["mods"]()
    gcfg = dataclasses.replace(stack["gcfg"], use_negative=600)
    jfn = jst.make_guidance_fn(jm, gcfg)
    tfn = tst.make_guidance_fn(tm, gcfg)

    @jax.jit
    def jrun(step, rgb, normal, mask, key):
        return jax.value_and_grad(
            lambda r, n: jfn(step, r, n, mask, key), argnums=(0, 1))(
                rgb, normal)

    rgb = rng.random((24, 24, 3)).astype(np.float32)
    normal = rng.random((6, 8, 3)).astype(np.float32)
    mask = (rng.random((24, 24)) > 0.7).astype(np.float32)
    key = jax.random.PRNGKey(11)
    values = []
    for step in (100, 500, 800):
        ref, (rg, rn) = jrun(jnp.asarray(step), rgb, normal, mask, key)
        r, n = (t(a).requires_grad_(True) for a in (rgb, normal))
        got = tfn(step, r, n, t(mask), draws=guidance_draws(key, 8))
        got.backward()
        close(got, ref, msg=str(step))
        close(r.grad, rg, atol_frac=GRAD_ATOL_FRAC, msg=str(step))
        if step <= gcfg.normal_start_iter:
            assert n.grad is None and float(np.abs(rn).max()) == 0.0
        else:
            close(n.grad, rn, atol_frac=GRAD_ATOL_FRAC, msg=str(step))
        values.append(got.item())
    assert len(set(values)) == 3


def test_masked_latents_cache_and_its_use_match_jax(stack, rng):
    """precompute_masked_latents (posterior ε of fold_in(key, i)); the RGB
    modality with a cached entry skips its conditioning encode."""
    jm, tm = stack["mods"]()
    imgs = rng.random((3, 24, 24, 3)).astype(np.float32)
    masks = (rng.random((3, 24, 24)) > 0.7).astype(np.float32)
    key = jax.random.PRNGKey(5)
    ref = jst.precompute_masked_latents(jm, imgs, masks, rng=key)
    eps = torch.cat([t(jax.random.normal(jax.random.fold_in(key, i),
                                         (1, 8, 8, 4), jnp.float32))
                     for i in range(3)])
    got = tst.precompute_masked_latents(tm, t(imgs), t(masks), eps=eps)
    close(got, ref)

    gcfg = dataclasses.replace(stack["gcfg"], is_normal_guidance=False)
    jfn = jax.jit(lambda r, m, ml, k: jst.make_guidance_fn(jm, gcfg)(
        jnp.asarray(900), r, None, m, k, masked_latents=ml))
    k = jax.random.PRNGKey(6)
    ml = np.asarray(ref)[1:2]
    r_got = tst.make_guidance_fn(tm, gcfg)(
        900, t(imgs[1]), None, t(masks[1]), masked_latents=t(ml),
        draws=guidance_draws(k, 8))
    close(r_got, jfn(imgs[1], masks[1], ml, k))
