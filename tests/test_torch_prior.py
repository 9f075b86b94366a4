"""Port vs JAX: the tiny-prior trainer and the prior flow of stage 2.

- tools/train_tiny_prior.py's twin: ``make_domain_images`` (sphere and
  hard worlds; images and normal maps) and ``make_domain_masks`` against
  the JAX tool's; both phases' losses with the draws injected. The JAX
  tool defines its losses inside ``main``, so the reference side restates
  those lines (tools/train_tiny_prior.py, ``vae_loss`` and ``unet_loss``)
  with the JAX package's modules.
- train/loop.py::build_guidance with ``sd_prior_ckpt`` and
  ``sd_lora_ckpt``: a prior and adapters written by the JAX package load
  and merge, and the guidance hook's loss and gradients equal the JAX
  package's flow (gbnerf_tpu/train/loop.py: load_prior_ckpt, then
  merge_lora_strict of the UNet adapters); text adapters are refused.
- The CLIs end to end at tiny widths: the prior trainer, then the
  ablation twin's priorNL arm, which trains the scene LoRA on the prior
  through ``python -m gbnerf_tpu_torch.train_lora``.

Tolerances, with their reasons: the domain images are the same numpy
arithmetic (equal); the normal maps go through the integral-image plane
fit in f32 in both packages, summed in another order: atol 1e-5. The
losses: f32, rtol 1e-5 (a mean over the batch of squared differences,
whose terms agree to ≈ 1e-6 relative). The guidance hook: the tolerances
of tests/test_torch_sds.py (loss rtol 1e-4; gradients atol 3e-4·max|ref|
through the VAE encoder's backward).
"""
import dataclasses
import importlib.util
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

from gbnerf_tpu.guidance import lora as jlora
from gbnerf_tpu.guidance import stable as jst
from gbnerf_tpu.guidance import weights as jweights
from gbnerf_tpu.guidance.vae import AutoencoderKL
from gbnerf_tpu_torch import config as tconfig
from gbnerf_tpu_torch.guidance import lora as tlora
from gbnerf_tpu_torch.tools import train_tiny_prior as tprior
from gbnerf_tpu_torch.train import loop as tloop

from _sd_pair import close, guidance_draws, make_stack, t

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
GRAD_ATOL_FRAC = 3e-4


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_train_tiny_prior", ROOT / "tools" / "train_tiny_prior.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def stack():
    return make_stack()


@pytest.mark.parametrize("family", ["spheres", "hard"])
def test_domain_images_and_masks_match_the_jax_tool(family):
    jt = _jax_tool()
    ji, jn = jt.make_domain_images(2, 32, 3, family=family)
    ti, tn = tprior.make_domain_images(2, 32, 3, family=family)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tn, jn, rtol=0, atol=1e-5)
    assert float(np.abs(jn - 0.5).max()) > 0.1
    np.testing.assert_array_equal(tprior.make_domain_masks(3, 32, 3),
                                  jt.make_domain_masks(3, 32, 3))


def test_prior_losses_match_jax(stack, rng):
    """Phase A (reconstruction + latent variance and mean terms) and
    phase B (ε on the 9-channel input, conditioning drawn from the six
    embeddings by modality), each with the JAX keys' draws."""
    jm, tm = stack["mods"](64)
    B, S, n_domain = 3, 64, 2
    imgs = rng.uniform(-1, 1, (B, S, S, 3)).astype(np.float32)
    key = jax.random.PRNGKey(21)

    def jvae_loss(vp, batch, k):            # tools/train_tiny_prior.py
        z = jm.vae.apply({"params": vp}, batch, k,
                         method=AutoencoderKL.encode)
        recon = jm.vae.apply({"params": vp}, z, method=AutoencoderKL.decode)
        var = jnp.mean(z ** 2)
        return (jnp.mean((recon - batch) ** 2) + 0.1 * (var - 1.0) ** 2
                + 1e-3 * jnp.mean(jnp.mean(z, axis=(1, 2)) ** 2))

    ref = jax.jit(jvae_loss)(jm.vae_params, imgs, key)
    eps = t(jax.random.normal(key, (B, 8, 8, 4), jnp.float32))
    close(tprior.vae_loss(tm.vae, t(imgs), eps), ref, rtol=1e-5)

    embeds6 = np.concatenate([np.asarray(jm.embeds_rgb),
                              np.asarray(jm.embeds_normal)])
    masks = np.stack([(rng.random((S, S)) > 0.6) for _ in range(B)]
                     ).astype(np.float32)
    idx = np.array([0, 3, 1], np.int32)       # RGB, normal, RGB
    sched = jm.schedule

    def junet_loss(up, vp, batch_img, batch_mask, batch_idx, k):
        k_t, k_n, k_e1, k_e2, k_c = jax.random.split(k, 5)
        enc = lambda x, kk: jm.vae.apply({"params": vp}, x, kk,  # noqa
                                         method=AutoencoderKL.encode)
        latents = enc(batch_img, k_e1)
        mlat = enc(batch_img * (batch_mask[..., None] < 0.5), k_e2)
        mask_l = jax.image.resize(batch_mask[..., None], (B, 8, 8, 1),
                                  "nearest")
        tt = jax.random.randint(k_t, (B,), 0, sched.num_train_timesteps)
        noise = jax.random.normal(k_n, latents.shape)
        noisy = sched.add_noise(latents, noise, tt)
        ei = (3 * (batch_idx >= n_domain).astype(jnp.int32)
              + jax.random.randint(k_c, (B,), 0, 3))
        pred = jm.unet.apply({"params": up},
                             jnp.concatenate([noisy, mask_l, mlat], -1), tt,
                             jnp.take(jnp.asarray(embeds6), ei, axis=0))
        return jnp.mean((pred - noise) ** 2)

    ref = jax.jit(junet_loss)(jm.unet_params, jm.vae_params, imgs, masks,
                              idx, key)
    k_t, k_n, k_e1, k_e2, k_c = jax.random.split(key, 5)
    shape = (B, 8, 8, 4)
    draws = {"t": torch.from_numpy(np.array(jax.random.randint(
                 k_t, (B,), 0, 1000))).long(),
             "noise": t(jax.random.normal(k_n, shape)),
             "enc_eps": t(jax.random.normal(k_e1, shape, jnp.float32)),
             "enc_masked_eps": t(jax.random.normal(k_e2, shape,
                                                   jnp.float32)),
             "cond": torch.from_numpy(np.array(jax.random.randint(
                 k_c, (B,), 0, 3))).long()}
    got = tprior.unet_loss(tm.unet, tm.vae, tm.schedule, t(embeds6),
                           t(imgs), t(masks), torch.from_numpy(idx),
                           n_domain, draws)
    close(got, ref, rtol=1e-5)


def _jax_prior_and_lora(tmp_path, jm, text=False):
    """A 'trained' prior (the stack's weights perturbed) and adapters with
    B drawn, both written by the JAX package."""
    rng = np.random.default_rng(8)
    pert = lambda tree: jax.tree_util.tree_map(  # noqa: E731
        lambda a: (np.asarray(a) + 0.03 * rng.standard_normal(a.shape)
                   ).astype(np.float32), tree)
    jp = dataclasses.replace(jm, unet_params=pert(jm.unet_params),
                             vae_params=pert(jm.vae_params))
    prior = str(tmp_path / "prior.msgpack")
    jweights.save_prior_ckpt(prior, jp)
    lora = jlora.init_lora(jax.random.PRNGKey(4), jp.unet_params, rank=4)
    lora = jax.tree_util.tree_map_with_path(
        lambda p, a: (np.asarray(a) if p[-1].key == "lora_A" else
                      0.03 * rng.standard_normal(a.shape)).astype(np.float32),
        lora)
    if text:
        lora = {"unet": lora, "text": {"layers_0": {"q_proj": {"kernel": {
            "lora_A": np.ones((32, 4), np.float32),
            "lora_B": np.zeros((4, 32), np.float32)}}}}}
    path = str(tmp_path / "lora.safetensors")
    jlora.save_lora(lora, path)
    return jp, prior, path


def _port_cfg(prior, lora):
    g = tconfig.GuidanceConfig(
        prompt="a thing", prompt_normal="a normal map",
        negative_prompt="bad", normal_start_iter=500, sd_tiny=True,
        sd_latent_size=64, sd_prior_ckpt=prior, sd_lora_ckpt=lora,
        is_rgb_guidance=True, is_normal_guidance=True)
    return tconfig.Config(guidance=g,
                          train=tconfig.TrainConfig(first_stage=False))


def test_build_guidance_prior_flow_matches_jax(tmp_path, stack, rng):
    jm, _ = stack["mods"]()
    jp, prior, lora = _jax_prior_and_lora(tmp_path, jm)
    gcfg = stack["gcfg"]
    # the JAX package's flow (gbnerf_tpu/train/loop.py): load the prior
    # over the stack, merge the UNet adapters
    jl = jweights.load_prior_ckpt(prior, jm)
    unet_ad, text_ad = jlora.split_adapters(lora)
    assert text_ad is None
    jl = dataclasses.replace(jl, unet_params=jlora.merge_lora_strict(
        jl.unet_params, unet_ad, what="prior unet"))
    jfn = jst.make_guidance_fn(jl, gcfg)

    tfn, tm, _ = tloop.build_guidance(_port_cfg(prior, lora), {},
                                      torch.device("cpu"), seed=3)
    assert tm.latent_size == 64
    np.testing.assert_array_equal(tm.embeds_rgb.numpy(), jp.embeds_rgb)

    rgb = rng.random((24, 24, 3)).astype(np.float32)
    normal = rng.random((6, 8, 3)).astype(np.float32)
    mask = (rng.random((24, 24)) > 0.7).astype(np.float32)
    key = jax.random.PRNGKey(11)
    ref, (rg, rn) = jax.jit(jax.value_and_grad(
        lambda r, n: jfn(800, r, n, mask, key), argnums=(0, 1)))(rgb, normal)
    r, n = (t(a).requires_grad_(True) for a in (rgb, normal))
    got = tfn(800, r, n, t(mask), draws=guidance_draws(key, 8))
    got.backward()
    close(got, ref)
    close(r.grad, rg, atol_frac=GRAD_ATOL_FRAC)
    close(n.grad, rn, atol_frac=GRAD_ATOL_FRAC)
    # the adapters took effect: without them the hook computes another loss
    tfn0, _, _ = tloop.build_guidance(_port_cfg(prior, None), {},
                                      torch.device("cpu"), seed=3)
    other = tfn0(800, t(rgb), t(normal), t(mask),
                 draws=guidance_draws(key, 8))
    assert abs(other.item() - got.item()) > 1e-4 * abs(got.item())


def test_prior_flow_refuses_text_adapters(tmp_path, stack):
    jm, _ = stack["mods"]()
    _, prior, lora = _jax_prior_and_lora(tmp_path, jm, text=True)
    unet_ad, text_ad = tlora.split_adapters(lora)
    assert text_ad is not None and len(unet_ad) > 0
    with pytest.raises(ValueError, match="text-encoder adapters"):
        tloop.build_guidance(_port_cfg(prior, lora), {}, torch.device("cpu"),
                             seed=0)


def _cli(args, module):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, "-m", module] + args, cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_prior_then_lora_then_prior_nl_through_the_clis(tmp_path):
    """The tiny-prior CLI, then the ablation twin's priorNL arm at tiny
    widths (the original's small-MLP field at its non-production scale,
    24 × 32 views, latent 64,
    4 + 4 steps): the scene LoRA trains on the prior through the LoRA
    CLI, stage 2 loads the prior and merges the adapters, and both arms
    evaluate."""
    out = tmp_path / "abl"
    out.mkdir()
    r = _cli([str(out / "prior.msgpack"), "--res", "64", "--n_domain", "4",
              "--steps_vae", "2", "--steps_unet", "2", "--batch", "2",
              "--chunk", "1", "--device", "cpu"],
             "gbnerf_tpu_torch.tools.train_tiny_prior")
    assert r.returncode == 0, r.stderr[-3000:]
    assert "[unet 2/2]" in r.stdout and "[prior] saved" in r.stdout
    r = _cli([str(out), "--colmap", "--lindisp", "--combine", "sds",
              "--iters1", "4", "--iters2", "4",
              "--H", "24", "--W", "32", "--n_train", "4", "--n_test", "2",
              "--latent", "64", "--lora_steps", "2", "--skip_prior",
              "--arms", "s1,priorNL", "--device", "cpu"],
             "gbnerf_tpu_torch.tools.run_ablation")
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "| priorNL-sds |" in r.stdout
    res = json.loads((out / "ablation.json").read_text())
    assert res["priorNL-sds"]["iter"] == 8
    assert np.isfinite(res["priorNL-sds"]["eval_psnr_masked"])
    lora_log = (out / "lora.log").read_text()
    assert "fine-tuning on prior" in lora_log and "lora_000002" in lora_log
    log = (out / "priorNL-sds.log").read_text()
    assert "loaded the prior" in log and "merged LoRA adapters" in log
    assert json.loads((out / "lora" / "lora_000002.safetensors.meta.json")
                      .read_text()) == {"res": 64}
