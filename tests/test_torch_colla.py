"""Port vs JAX: collaborative (colla) guidance — ``sd_train_step_colla``
(2-way SDS with the textbook gradient, and the 3-way colla combine under
use_csd), ``make_guidance_fn`` with the RGB and colla modalities, the
stage-2 view selection with its neighbour views, the whole stage-2
``step.loss_fn`` with the four neighbour views rendered with gradient on
small CP fields, and a few ``train()`` steps of stage 2 with colla and
Perp-Neg together on the CPU.

The weights and the draws: tests/_sd_pair.py (the same random tiny SD
stack in both packages; the JAX package's draws recomputed from its keys,
at the views' batch K = 4). The scene is chip_smoke.py's in-memory
SPIn-NeRF-like scene at a small size, as tests/test_torch_stage2.py's.

Tolerances, with their reasons: f32 on both sides. The colla SDS loss,
rtol 1e-4, and its gradient with respect to the views, atol
3e-4·max|ref|, as tests/test_torch_sds.py: the CFG scale amplifies the
UNet's ≈ 1e-6 relative rounding, and the gradient carries it through the
VAE encoder's backward (where the JAX package's own f32 gradient
strays further from an f64 evaluation, the port is held to its f64
evaluation as well; see the test). The stage-2 loss on CP fields: the loss terms to
rtol 1e-3, the field gradients to rtol 3e-2 with atol 5e-3·max|ref|, as
tests/test_torch_stage2.py (bf16 field matmuls on both sides, summed in
another order).
"""
import copy
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from gbnerf_tpu.guidance import stable as jst
from gbnerf_tpu.train import state as jstate
from gbnerf_tpu.train import step as jstep
from gbnerf_tpu_torch import convert
from gbnerf_tpu_torch.data.rays_bank import build_ray_banks
from gbnerf_tpu_torch.guidance import stable as tst
from gbnerf_tpu_torch.train import loop as tloop
from gbnerf_tpu_torch.train import state as tstate
from gbnerf_tpu_torch.train import step as tstep

from _sd_pair import RTOL, close, draws, make_stack, t
from test_torch_stage2 import _batch, _cfg, _loop_cfg, _to_torch

torch.set_num_threads(1)
GRAD_ATOL_FRAC = 3e-4
K = 4


@pytest.fixture(scope="module")
def stack():
    return make_stack()


@pytest.fixture(scope="module")
def scene():
    return chip_smoke.spinnerf_scene(5, 36, 48, n_test=1, seed=2)


def colla_draws(key, lr, k=K):
    """sd_train_step_colla's three draws from its key, at batch k."""
    k_noise, k_enc1, k_enc2 = jax.random.split(key, 3)
    shape = (k, lr, lr, 4)
    return {"noise": t(jax.random.normal(k_noise, shape)),
            "enc_eps": t(jax.random.normal(k_enc1, shape, jnp.float32)),
            "enc_masked_eps": t(jax.random.normal(k_enc2, shape,
                                                   jnp.float32))}


@pytest.mark.parametrize("use_csd", [False, True])
def test_sd_train_step_colla_loss_and_grad_match_jax(stack, rng, use_csd):
    """K = 4 views: the UNet at batch 8 (SDS) or 12 (CSD), the embeddings
    repeated per view in the latents' order; the use_negative gate is on
    (step 700 > 600)."""
    jm, tm = stack["mods"]()
    gcfg = dataclasses.replace(stack["gcfg"], use_csd=use_csd, w1=1.3,
                               w2=0.6, colla_guidance_scale=5.0,
                               use_negative=600)
    rgbs = rng.random((K, 9, 12, 3)).astype(np.float32)
    masks = (rng.random((K, 9, 12)) > 0.6).astype(np.float32)
    key = jax.random.PRNGKey(12)

    def jloss(r):
        return jst.sd_train_step_colla(jm, gcfg, 700, r, masks, key)

    ref, rg = jax.jit(jax.value_and_grad(jloss))(rgbs)
    x = t(rgbs).requires_grad_(True)
    got = tst.sd_train_step_colla(tm, gcfg, 700, x, t(masks),
                                  **colla_draws(key, 8))
    got.backward()
    close(got, ref, rtol=RTOL)
    close(x.grad, rg, atol_frac=GRAD_ATOL_FRAC)
    assert float(np.abs(np.asarray(rg)).max()) > 0
    # every view gets its own gradient
    assert all(float(np.abs(np.asarray(rg[i])).max()) > 0 for i in range(K))


def test_colla_gradient_reaches_unmasked_pixels_as_in_jax(stack):
    """The colla term injects its gradient at the latent mask, but the
    views are encoded whole, so the VAE encoder's receptive field carries
    part of it to pixels outside each view's mask. The JAX package does the
    same: on views with a block mask, the gradient outside the masks is a
    nonzero share of the whole in both packages, and the port's equals
    JAX's there, pixel by pixel (the reference's own behaviour, not a
    port's departure)."""
    jm, tm = stack["mods"]()
    gcfg = dataclasses.replace(stack["gcfg"], use_csd=False,
                               colla_guidance_scale=5.0)
    rng = np.random.default_rng(21)
    rgbs = rng.random((K, 12, 16, 3)).astype(np.float32)
    masks = np.zeros((K, 12, 16), np.float32)
    masks[:, 4:8, 5:11] = 1.0
    key = jax.random.PRNGKey(14)
    rg = np.asarray(jax.jit(jax.grad(lambda r: jst.sd_train_step_colla(
        jm, gcfg, 300, r, masks, key)))(rgbs))
    x = t(rgbs).requires_grad_(True)
    tst.sd_train_step_colla(tm, gcfg, 300, x, t(masks),
                            **colla_draws(key, 8)).backward()
    outside = masks[..., None] == 0
    for g in (rg, x.grad.numpy()):
        share = np.abs(g * outside).sum() / np.abs(g).sum()
        assert 0.05 < share < 1.0, share
    atol = GRAD_ATOL_FRAC * float(np.abs(rg).max())
    np.testing.assert_allclose(x.grad.numpy() * outside, rg * outside,
                               rtol=0, atol=atol)


def test_guidance_fn_with_colla_matches_jax(stack, rng):
    """make_guidance_fn with the RGB and colla modalities: the colla term
    on rgbs4/masks4, its draws from the hook's third key."""
    jm, tm = stack["mods"]()
    gcfg = dataclasses.replace(stack["gcfg"], is_colla_guidance=True,
                               is_normal_guidance=False)
    jfn = jst.make_guidance_fn(jm, gcfg)
    tfn = tst.make_guidance_fn(tm, gcfg)
    rgb = rng.random((24, 24, 3)).astype(np.float32)
    mask = (rng.random((24, 24)) > 0.7).astype(np.float32)
    rgbs4 = rng.random((K, 6, 6, 3)).astype(np.float32)
    masks4 = (rng.random((K, 6, 6)) > 0.5).astype(np.float32)
    key = jax.random.PRNGKey(13)
    ref, (rg, r4) = jax.jit(jax.value_and_grad(
        lambda r, v: jfn(jnp.asarray(300), r, None, mask, key, rgbs4=v,
                         masks4=masks4), argnums=(0, 1)))(rgb, rgbs4)
    k_rgb, _, k_c = jax.random.split(key, 3)
    x, v = t(rgb).requires_grad_(True), t(rgbs4).requires_grad_(True)
    got = tfn(300, x, None, t(mask), rgbs4=v, masks4=t(masks4),
              draws={"rgb": draws(k_rgb, 8), "colla": colla_draws(k_c, 8)})
    got.backward()
    close(got, ref)
    close(v.grad, r4, atol_frac=GRAD_ATOL_FRAC)
    # d loss / d rgb: at this input the JAX package's own f32 gradient is
    # 4.6e-4·max from an f64 evaluation of the same function (the port's
    # 4.3e-6), past GRAD_ATOL_FRAC; so the port is held to its own f64
    # evaluation at 3e-5·max and to the JAX package at 1e-3·max
    close(x.grad, rg, atol_frac=1e-3)
    m64 = dataclasses.replace(tm, unet=copy.deepcopy(tm.unet).double(),
                              vae=copy.deepcopy(tm.vae).double(),
                              embeds_rgb=tm.embeds_rgb.double())
    x64 = t(rgb).double().requires_grad_(True)
    tst.make_guidance_fn(m64, gcfg)(
        300, x64, None, t(mask).double(), rgbs4=t(rgbs4).double(),
        masks4=t(masks4).double(),
        draws={"rgb": {k: a.double() for k, a in draws(k_rgb, 8).items()},
               "colla": {k: a.double()
                         for k, a in colla_draws(k_c, 8).items()}}).backward()
    close(x.grad.double(), x64.grad.numpy(), atol_frac=3e-5)
    # without the views the colla term is skipped, as in the JAX package
    no_views = tfn(300, t(rgb), None, t(mask), draws={"rgb": draws(k_rgb, 8)})
    ref_rgb = jax.jit(lambda r: jfn(jnp.asarray(300), r, None, mask, key))(rgb)
    close(no_views, ref_rgb)


def test_view_selection_with_colla_views(scene, rng):
    """n_colla views: their poses and masks at the injected indices, or
    drawn from the generator after the streams (so the streams' draws do
    not move)."""
    scene, depth_gts = scene
    banks = build_ray_banks(scene.images, scene.masks, scene.inpainted_depths,
                            scene.poses, scene.hwf[2], depth_gts)
    scene_dev = tloop.scene_to_device(scene, banks, "cpu")
    banks_dev = tloop.banks_to_device(banks, "cpu")
    ci = np.asarray([4, 0, 4, 2])
    b = tstep.select_stage2_view(scene_dev, banks_dev, 8, img_i=1,
                                 idx={"colla": torch.from_numpy(ci)},
                                 n_colla=K)
    np.testing.assert_array_equal(b.colla_poses.numpy(),
                                  scene.poses[ci, :3, :4])
    np.testing.assert_array_equal(b.colla_masks.numpy(), scene.masks[ci])
    g0, g1 = (torch.Generator().manual_seed(5) for _ in range(2))
    plain = tstep.select_stage2_view(scene_dev, banks_dev, 8, g0)
    colla = tstep.select_stage2_view(scene_dev, banks_dev, 8, g1, n_colla=K)
    assert plain.colla_poses is None and colla.colla_poses.shape == (K, 3, 4)
    assert torch.equal(plain.clf["o"], colla.clf["o"])


def test_stage2_loss_fn_with_colla_matches_jax(scene, rng):
    """RGB SDS on the composite (a cached masked-latents entry) and the
    colla term on four neighbour views (idx["colla"]) rendered at 1/4 size
    as at eval, with gradient: the loss, its terms, every field gradient.
    The σ-only coarse pass of the views only places the fine samples, so
    their gradient reaches the fields through the fine pass."""
    scene, depth_gts = scene
    cfg = _cfg(is_colla_guidance=True, is_normal_guidance=False)
    pair = make_stack()
    jm, tm = pair["mods"]()
    banks = build_ray_banks(scene.images, scene.masks, scene.inpainted_depths,
                            scene.poses, scene.hwf[2], depth_gts)
    ci = np.asarray([3, 0, 4, 1])
    b = _batch(scene, banks, rng)
    b["masked_latents"] = np.asarray(jst.precompute_masked_latents(
        jm, scene.images[1:2], scene.masks[1:2], rng=jax.random.PRNGKey(1)))
    b["colla_poses"] = scene.poses[ci, :3, :4].astype(np.float32)
    b["colla_masks"] = scene.masks[ci]
    st, tc, tf = tstate.create_train_state(cfg, torch.Generator().manual_seed(
        3))
    params = jax.tree_util.tree_map(jnp.asarray, convert.params_to_jax(
        {"coarse": tc.state_dict(), "fine": tf.state_dict()}))
    jc, jf = jstate.build_field(cfg, fine=False), jstate.build_field(
        cfg, fine=True)
    step_i, key = 7, jax.random.PRNGKey(4)
    jsf = jstep.make_train_step_stage2(
        cfg, jc, jf, scene.near, scene.far, scene.hwf,
        guidance_fn=jst.make_guidance_fn(jm, cfg.guidance))
    jb = jstep.Stage2Batch(**jax.tree_util.tree_map(jnp.asarray, b))
    (ref, jmet), jg = jax.jit(jax.value_and_grad(jsf.loss_fn, has_aux=True))(
        params, jb, step_i, key)
    k_g = jax.random.split(key, 6)[5]
    k_rgb, _, k_c = jax.random.split(k_g, 3)

    tsf = tstep.make_train_step_stage2(
        cfg, tc, tf, scene.near, scene.far, scene.hwf,
        guidance_fn=tst.make_guidance_fn(tm, cfg.guidance))
    loss, m = tsf.loss_fn(tstep.Stage2Batch(**_to_torch(b)), step_i,
                          draws={"rgb": draws(k_rgb, 8),
                                 "colla": colla_draws(k_c, 8)})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-3)
    for k in ("img_loss", "depth_loss", "sds_loss", "sigma_loss"):
        assert float(jmet[k]) != 0.0, k
        np.testing.assert_allclose(m[k].item(), float(jmet[k]), rtol=1e-3,
                                   err_msg=k)
    got = convert.params_to_jax({
        name: {k: p.grad for k, p in mod.named_parameters()}
        for name, mod in (("coarse", tc), ("fine", tf))})
    for path, r in jax.tree_util.tree_leaves_with_path(jg):
        g = got
        for part in path:
            g = g[part.key]
        r = np.asarray(r)
        np.testing.assert_allclose(g, r, rtol=3e-2,
                                   atol=5e-3 * max(np.abs(r).max(), 1e-30),
                                   err_msg=jax.tree_util.keystr(path))

    # the colla term alone: a gradient reaches the fine field through the
    # views (the composite's masked rays render at train, the views at eval)
    sd_only = tst.make_guidance_fn(
        tm, dataclasses.replace(cfg.guidance, is_rgb_guidance=False))
    tf.zero_grad()
    tsf2 = tstep.make_train_step_stage2(cfg, tc, tf, scene.near, scene.far,
                                        scene.hwf, guidance_fn=sd_only)
    _, m2 = tsf2.loss_fn(tstep.Stage2Batch(**_to_torch(b)), step_i,
                         draws={"colla": colla_draws(k_c, 8)})
    grads = torch.autograd.grad(m2["sds_loss"], tf.lines())
    assert sum(float(g.norm()) for g in grads) > 0


def test_train_stage2_with_colla_and_perpneg(tmp_path, scene):
    """Stage 2 through train() with the tiny SD stack, colla and Perp-Neg
    on (the RGB term is Perp-Neg's, the colla views drawn each step):
    finite metrics, a nonzero SDS loss, the direction embeddings built."""
    scene, depth_gts = scene
    cfg = _loop_cfg(tmp_path, N_iters=3)
    cfg = cfg.replace(guidance=dataclasses.replace(
        cfg.guidance, is_colla_guidance=True, perpneg=True,
        progressive_view=True, is_normal_guidance=False))
    out = tloop.train(cfg, scene=scene, depth_gts=depth_gts, device="cpu",
                      log_fn=lambda i, m: None)
    assert out["state"].step == 3
    assert set(out["guidance"].embeds_dir) == {"front", "side", "back"}
    for _, m in out["history"]:
        assert all(np.isfinite(v) for v in m.values()), m
        assert m["sds_loss"] != 0.0
