"""Port vs JAX: Perp-Neg guidance — ``weighted_perpendicular_aggregator``,
the directional prompt embeddings (``get_pos_neg_text_embeddings``,
``adjust_text_embeddings``, the azimuth wrap), the orbit views
(``rand_poses``, ``progressive_ranges``, ``ProgressiveViews``), the
direction-suffixed prompt embeddings of ``build_sd_modules``,
``sd_train_step_perpneg`` and ``make_guidance_fn`` with ``perpneg`` on.

The weights and the draws: tests/_sd_pair.py (the same random tiny SD
stack in both packages; the JAX package's noise, posterior and orbit
uniforms recomputed from its keys and handed to the port).

Tolerances, with their reasons: f32 on both sides.
- The aggregator, the directional embeddings and the orbit poses: rtol
  1e-6 with an atol of 1e-6·max|ref| — the same f32 formulas, summed in
  another order at most; an orbit angle's f32 product by π/180 may round
  once otherwise (the JAX package multiplies in f32, the port in f64 and
  then rounds).
- The Perp-Neg SDS loss, rtol 1e-4, and its gradient with respect to the
  render, atol 3e-4·max|ref|: as tests/test_torch_sds.py (the CFG scale
  amplifies the UNet's ≈ 1e-6 relative rounding; the gradient carries it
  through the VAE encoder's backward).
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gbnerf_tpu.guidance import directional as jdir
from gbnerf_tpu.guidance import orchestrator as jorch
from gbnerf_tpu.guidance import perpneg as jpn
from gbnerf_tpu.guidance import stable as jst
from gbnerf_tpu_torch.guidance import directional as tdir
from gbnerf_tpu_torch.guidance import orchestrator as torch_orch
from gbnerf_tpu_torch.guidance import perpneg as tpn
from gbnerf_tpu_torch.guidance import stable as tst

from _sd_pair import RTOL, close, draws, make_stack, t

torch.set_num_threads(1)
EXACT = dict(rtol=1e-6, atol_frac=1e-6)
GRAD_ATOL_FRAC = 3e-4


@pytest.fixture(scope="module")
def stack():
    return make_stack()


@pytest.mark.parametrize("B,K", [(1, 1), (1, 2), (2, 1), (3, 2)])
def test_perpendicular_aggregator_matches_jax(rng, B, K):
    deltas = rng.standard_normal(((K + 1) * B, 4, 5, 3)).astype(np.float32)
    w = rng.standard_normal((K * B,)).astype(np.float32)
    ref = jpn.weighted_perpendicular_aggregator(jnp.asarray(deltas),
                                                jnp.asarray(w), B)
    got = tpn.weighted_perpendicular_aggregator(t(deltas), t(w), B)
    close(got, ref, **EXACT)
    # the residue is perpendicular to the main direction (as
    # tests/test_guidance.py::test_perpneg_aggregator checks for JAX)
    perp = (got - t(deltas[:B])).double()
    dots = (perp * t(deltas[:B]).double()).sum(dim=(1, 2, 3))
    assert float(dots.abs().max()) < 1e-3
    close(tpn.get_perpendicular_component(t(deltas[B:2 * B]), t(deltas[:B])),
          jpn.get_perpendicular_component(jnp.asarray(deltas[B:2 * B]),
                                          jnp.asarray(deltas[:B])), **EXACT)


def _dir_embeds(rng, L=6, D=5):
    e = {k: rng.standard_normal((L, D)).astype(np.float32)
         for k in ("front", "side", "back")}
    return e, {k: jnp.asarray(v) for k, v in e.items()}, \
        {k: t(v) for k, v in e.items()}


AZIMUTHS = (-180.0, -135.0, -90.0, -89.5, -45.0, -10.0, 0.0, 17.0, 72.0,
            89.9, 90.0, 100.0, 162.0, 179.9)


def test_directional_embeddings_match_jax(rng):
    """Both hemispheres, the boundaries ±90 and the decay switches (r
    past 0.8 and under 0.2), with non-default decays."""
    _, je, te = _dir_embeds(rng)
    kw = dict(front_decay_factor=3.0, side_decay_factor=7.0, negative_w=-1.5)
    for az in AZIMUTHS:
        zr, wr = jdir.get_pos_neg_text_embeddings(je, az, **kw)
        zg, wg = tdir.get_pos_neg_text_embeddings(te, az, **kw)
        close(zg, zr, msg=str(az), **EXACT)
        close(wg, wr, msg=str(az), **EXACT)
    az = np.asarray(AZIMUTHS[::3], np.float32)
    zr, wr = jdir.adjust_text_embeddings(je, jnp.asarray(az), **kw)
    zg, wg = tdir.adjust_text_embeddings(te, t(az), **kw)
    assert zg.shape == (3 * len(az), 6, 5) and wg.shape == (2 * len(az),)
    close(zg, zr, **EXACT)
    close(wg, wr, **EXACT)


def test_azimuth_wrap_is_jax_floor_mod():
    """jnp.mod is a floor-mod: torch.remainder, not fmod (which keeps the
    dividend's sign)."""
    az = np.asarray([-725.0, -540.0, -181.0, -180.0, -0.5, 0.0, 179.5,
                     180.0, 359.0, 900.25], np.float32)
    ref = jnp.mod(jnp.asarray(az) + 180.0, 360.0) - 180.0
    close(tdir.wrap_azimuth(t(az)), ref, **EXACT)
    assert float(tdir.wrap_azimuth(t(np.float32([-181.0])))[0]) == 179.0


def _uniforms(key, size):
    """rand_poses' three draws (θ, φ, radius) on [0, 1), from its key."""
    return torch.stack([t(jax.random.uniform(k, (size,)))
                        for k in jax.random.split(key, 3)])


@pytest.mark.parametrize("size", [1, 7])
def test_rand_poses_match_jax_with_injected_uniforms(size):
    """Every direction class shows up at size 7 with these ranges."""
    key = jax.random.PRNGKey(3)
    kw = dict(radius_range=(1.0, 1.5), theta_range=(0.0, 180.0),
              phi_range=(-180.0, 360.0), angle_overhead=30.0,
              angle_front=60.0)
    ref = jorch.rand_poses(key, size, **kw)
    got = torch_orch.rand_poses(size, u=_uniforms(key, size), **kw)
    for name, g, r in zip(("poses", "dirs", "thetas", "phis", "radii"),
                          got, ref):
        close(g.float(), np.asarray(r, np.float32), msg=name, **EXACT)
    if size == 7:
        keys = [jax.random.PRNGKey(s) for s in range(40)]
        dirs = {int(d) for k in keys for d in torch_orch.rand_poses(
            size, u=_uniforms(k, size), **kw)[1]}
        assert dirs == set(range(6))


@pytest.mark.parametrize("progressive", [False, True])
def test_progressive_ranges_match_jax(progressive):
    gcfg = dataclasses.replace(make_gcfg(), progressive_view=progressive,
                               exp_start_iter=100, exp_end_iter=0)
    for step in (0, 100, 250, 1234, 5000, 20000):
        ref = jorch.progressive_ranges(step, gcfg, 4000)
        got = torch_orch.progressive_ranges(step, gcfg, 4000)
        for g, r in zip(got, ref):
            close(np.asarray(g, np.float32), np.asarray(r, np.float32),
                  msg=str(step), **EXACT)
    pv = (jorch.ProgressiveViews(init_frac=0.3, expand_iters=800),
          torch_orch.ProgressiveViews(init_frac=0.3, expand_iters=800))
    for step in (0, 400, 2000):
        assert pv[1].ranges(step) == pv[0].ranges(step)


def make_gcfg(**kw):
    from gbnerf_tpu.config import GuidanceConfig

    base = dict(prompt="a thing", prompt_normal="a normal map",
                negative_prompt="bad", normal_start_iter=500)
    base.update(kw)
    return GuidanceConfig(**base)


def _dir_pair(stack):
    """The direction-suffixed prompt embeddings of the JAX text tower in
    both packages (as build_sd_modules computes them under perpneg)."""
    from gbnerf_tpu.guidance import text as jtext

    tok = jtext.Tokenizer(None, 77, 49408)
    z = np.asarray(jax.jit(stack["jt"].apply)(
        {"params": stack["tp"]},
        tok([f"a thing, {d} view" for d in ("front", "side", "back")])))
    names = ("front", "side", "back")
    return ({n: jnp.asarray(z[i]) for i, n in enumerate(names)},
            {n: t(z[i]) for i, n in enumerate(names)})


def test_build_sd_modules_direction_embeds_match_the_text_tower(stack):
    """build_sd_modules(perpneg) encodes "<prompt>, {front,side,back}
    view" with its text tower: the port's tower (the JAX weights) against
    the JAX tower; without perpneg there are none."""
    _, te = _dir_pair(stack)
    gcfg = make_gcfg(perpneg=True)
    from gbnerf_tpu_torch.guidance.text import CLIPTextConfig
    from gbnerf_tpu_torch.guidance.unet import UNetConfig
    from gbnerf_tpu_torch.guidance.vae import VAEConfig

    mods = tst.build_sd_modules(
        gcfg, torch.Generator().manual_seed(0),
        unet_config=UNetConfig.tiny(), vae_config=VAEConfig.tiny(),
        text_config=CLIPTextConfig(vocab_size=49408, width=32, layers=2,
                                   heads=2),
        latent_size=64, dtype=torch.float32)
    assert set(mods.embeds_dir) == {"front", "side", "back"}
    mods.text_model.load_state_dict(stack["tt"].state_dict())
    with torch.no_grad():
        z = mods.text_model(mods.tokenizer(
            [f"a thing, {d} view" for d in ("front", "side", "back")]))
    for i, n in enumerate(("front", "side", "back")):
        close(z[i], te[n].numpy(), rtol=RTOL)
    assert set(tst.guidance_params(mods)) == {
        "unet", "vae", "embeds_rgb", "embeds_normal", "embeds_dir"}
    plain = tst.build_sd_modules(
        make_gcfg(), torch.Generator().manual_seed(0),
        unet_config=UNetConfig.tiny(), vae_config=VAEConfig.tiny(),
        text_config=CLIPTextConfig(vocab_size=49408, width=32, layers=2,
                                   heads=2),
        latent_size=64, dtype=torch.float32)
    assert plain.embeds_dir is None


@pytest.mark.parametrize("cached", [False, True])
def test_sd_train_step_perpneg_loss_and_grad_match_jax(stack, rng, cached):
    """One UNet call at batch 4 (uncond, main, two auxiliaries) on the
    directional embeddings of azimuth 40°; with a cached masked-latents
    entry the conditioning encode is skipped."""
    jm, tm = stack["mods"]()
    gcfg = stack["gcfg"]
    je, te = _dir_pair(stack)
    H, W = 24, 32
    rgb = rng.random((H, W, 3)).astype(np.float32)
    mask = (rng.random((H, W)) > 0.6).astype(np.float32)
    key = jax.random.PRNGKey(8)
    # the cache holds the VAE encoding of a masked view (as in
    # tests/test_torch_sds.py's cache test)
    ml = (np.asarray(jst.precompute_masked_latents(
        jm, rgb[None], mask[None], rng=jax.random.PRNGKey(9)))
          if cached else None)
    step_i = 777
    jz, jw = jdir.adjust_text_embeddings(je, jnp.asarray([40.0]))
    tz, tw = tdir.adjust_text_embeddings(te, t(np.float32([40.0])))

    def jloss(r):
        return jst.sd_train_step_perpneg(
            jm, gcfg, step_i, r, mask, key, text_z=jz, weights=jw,
            guidance_scale=7.5, uncond=jm.embeds_rgb[1],
            masked_latents=None if ml is None else jnp.asarray(ml))

    ref, rg = jax.jit(jax.value_and_grad(jloss))(rgb)
    x = t(rgb).requires_grad_(True)
    got = tst.sd_train_step_perpneg(
        tm, gcfg, step_i, x, t(mask), text_z=tz, weights=tw,
        guidance_scale=7.5, uncond=tm.embeds_rgb[1],
        masked_latents=None if ml is None else t(ml), **draws(key, 8))
    got.backward()
    close(got, ref, rtol=RTOL)
    close(x.grad, rg, atol_frac=GRAD_ATOL_FRAC)
    assert float(np.abs(np.asarray(rg)).max()) > 0


@pytest.mark.parametrize("progressive", [False, True])
def test_guidance_fn_with_perpneg_matches_jax(stack, rng, progressive):
    """make_guidance_fn under perpneg: the RGB modality draws an orbit
    azimuth (its uniforms injected; the view ranges widen with the step
    under progressive_view, over n_iters) and runs Perp-Neg; the normal
    modality is as without perpneg."""
    jm, tm = stack["mods"]()
    je, te = _dir_pair(stack)
    jm = dataclasses.replace(jm, embeds_dir=je)
    tm = dataclasses.replace(tm, embeds_dir=te)
    gcfg = make_gcfg(perpneg=True, progressive_view=progressive,
                     default_azimuth=30.0, normal_start_iter=100)
    jfn = jst.make_guidance_fn(jm, gcfg, n_iters=3000)
    tfn = tst.make_guidance_fn(tm, gcfg, n_iters=3000)
    rgb = rng.random((24, 24, 3)).astype(np.float32)
    normal = rng.random((6, 8, 3)).astype(np.float32)
    mask = (rng.random((24, 24)) > 0.7).astype(np.float32)

    @jax.jit
    def jrun(step, key):
        return jax.value_and_grad(
            lambda r, n: jfn(step, r, n, mask, key), argnums=(0, 1))(
                rgb, normal)

    values = []
    for step, seed in ((50, 21), (400, 22)):
        key = jax.random.PRNGKey(seed)
        ref, (rg, rn) = jrun(jnp.asarray(step), key)
        k_rgb, k_n, _ = jax.random.split(key, 3)
        k_az, k_sd = jax.random.split(k_rgb)
        d = {"rgb": dict(draws(k_sd, 8), u=_uniforms(k_az, 1)),
             "normal": draws(k_n, 8)}
        r, n = (t(a).requires_grad_(True) for a in (rgb, normal))
        got = tfn(step, r, n, t(mask), draws=d)
        got.backward()
        close(got, ref, msg=str(step))
        close(r.grad, rg, atol_frac=GRAD_ATOL_FRAC, msg=str(step))
        if step > gcfg.normal_start_iter:
            close(n.grad, rn, atol_frac=GRAD_ATOL_FRAC, msg=str(step))
        values.append(got.item())
    assert values[0] != values[1]

