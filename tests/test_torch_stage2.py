"""Port vs JAX: stage 2 (masked inpainting by score distillation) —
``select_stage2_view``, ``_masked_rays``, the composite into the GT view,
the whole ``step.loss_fn`` on a hand-built ``Stage2Batch`` with the tiny
SD stack (loss, every term, every field gradient), and a few ``train()``
steps of stage 2 on the CPU (``sd_tiny``, warm-started from a stage-1
checkpoint), with the refusals of what is not ported yet; and the nog
configuration of tools/run_ablation.py (no guidance, the LPIPS patch loss
on the composite, gradient_clip) against the JAX package's loss.

The scene is chip_smoke.py's in-memory SPIn-NeRF-like scene at a small
size (intruder-sphere masks, inpainted disparities, COLMAP-style depth
rays); the SD weights and the JAX package's guidance draws come from
tests/_sd_pair.py.

Tolerances, with their reasons: the small CP fields round every field
matmul operand to bf16 on both sides and sum in another order, which can
flip one rounding of a hidden activation (tests/test_field_bwd.py): the
loss terms to rtol 1e-3, the field gradients to rtol 3e-2 with atol
5e-3·max|ref|, as the stage-1 CP test. Rays, the composite and the
selected rows: exact or rtol 1e-6 (the same f32 formulas).
"""
import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from gbnerf_tpu.config import (Config, DataConfig, FieldConfig,
                               GuidanceConfig, RenderConfig, TrainConfig)
from gbnerf_tpu.guidance import stable as jst
from gbnerf_tpu.train import state as jstate
from gbnerf_tpu.train import step as jstep
from gbnerf_tpu.utils import lpips as jlpips
from gbnerf_tpu_torch import convert
from gbnerf_tpu_torch.data.rays_bank import build_ray_banks
from gbnerf_tpu_torch.guidance import stable as tst
from gbnerf_tpu_torch.train import loop as tloop
from gbnerf_tpu_torch.train import state as tstate
from gbnerf_tpu_torch.train import step as tstep
from gbnerf_tpu_torch.utils import lpips as tlpips

from _sd_pair import guidance_draws, make_stack

torch.set_num_threads(1)
H, W = 36, 48


@pytest.fixture(scope="module")
def scene():
    return chip_smoke.spinnerf_scene(3, H, W, n_test=1, seed=2)


def _cfg(**guidance):
    g = dict(prompt="a thing", prompt_normal="a normal map",
             negative_prompt="bad", normal_start_iter=0,
             normalmap_render_factor=4)
    g.update(guidance)
    return Config(
        field=FieldConfig(cp_resolutions=(5, 9, 17), cp_rank=4, cp_bound=3.0),
        render=RenderConfig(N_samples=16, N_importance=16, lindisp=True,
                            white_bkgd=True, perturb=0.0, raw_noise_std=0.0),
        data=DataConfig(depth_lambda=0.1, sdepth_lambda=0.1),
        train=TrainConfig(first_stage=False, tv_loss_weight=1e-3,
                          sigma_loss_weight=0.05, N_rand=16),
        guidance=GuidanceConfig(**g))


def _batch(scene, banks, rng, img_i=1, n=16):
    """A hand-built batch of view img_i: the GT view, its mask and padded
    masked-pixel table, and n rays of each stream."""
    def stream(s):
        i = rng.integers(0, len(s), n)
        return {"o": s.rays_o[i], "d": s.rays_d[i], "target": s.target[i]}

    return dict(image=scene.images[img_i], mask=scene.masks[img_i],
                coords=banks.mask_coords[img_i],
                valid=banks.mask_valid[img_i],
                pose=scene.poses[img_i, :3, :4].astype(np.float32),
                clf=stream(banks.rgb_clf), inp=stream(banks.inp),
                depth=stream(banks.depth))


def _to_torch(x):
    if isinstance(x, dict):
        return {k: _to_torch(v) for k, v in x.items()}
    return torch.from_numpy(np.ascontiguousarray(x))


def test_stage2_loss_fn_matches_jax(scene, rng):
    """Every term on: rgb + rgb0, inpainted disparity, COLMAP depth, σ
    likelihood, TV, and the SDS term of both modalities (RGB on the
    composite with a cached masked-latents entry, the normal map at factor
    4 with its own conditioning encode; the uncached RGB encode is in
    tests/test_torch_sds.py)."""
    scene, depth_gts = scene
    cfg = _cfg()
    pair = make_stack()
    jm, tm = pair["mods"]()
    banks = build_ray_banks(scene.images, scene.masks, scene.inpainted_depths,
                            scene.poses, scene.hwf[2], depth_gts)
    b = _batch(scene, banks, rng)
    b["masked_latents"] = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
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

    tsf = tstep.make_train_step_stage2(
        cfg, tc, tf, scene.near, scene.far, scene.hwf,
        guidance_fn=tst.make_guidance_fn(tm, cfg.guidance))
    loss, m = tsf.loss_fn(tstep.Stage2Batch(**_to_torch(b)), step_i,
                          draws=guidance_draws(k_g, 8))
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


def test_view_selection_rays_and_composite_match_jax(scene, rng):
    scene, depth_gts = scene
    banks = build_ray_banks(scene.images, scene.masks, scene.inpainted_depths,
                            scene.poses, scene.hwf[2], depth_gts)
    scene_dev = tloop.scene_to_device(scene, banks, "cpu")
    banks_dev = tloop.banks_to_device(banks, "cpu")
    idx = {k: torch.from_numpy(rng.integers(0, 50, 8))
           for k in ("clf", "inp", "depth")}
    b = tstep.select_stage2_view(scene_dev, banks_dev, 8, img_i=2, idx=idx)
    assert torch.equal(b.image, torch.from_numpy(scene.images[2]))
    assert torch.equal(b.coords, torch.from_numpy(banks.mask_coords[2]))
    assert torch.equal(b.valid, torch.from_numpy(banks.mask_valid[2]))
    np.testing.assert_array_equal(b.clf["target"],
                                  banks.rgb_clf.target[idx["clf"].numpy()])
    assert b.masked_latents is None
    g = torch.Generator().manual_seed(0)
    assert tstep.select_stage2_view(scene_dev, banks_dev, 8,
                                    g).image.shape == (H, W, 3)

    pose, coords = scene.poses[2, :3, :4], banks.mask_coords[2]
    ro, rd = tstep._masked_rays(H, W, scene.hwf[2], torch.from_numpy(pose),
                                torch.from_numpy(coords))
    jro, jrd = jstep._masked_rays(H, W, scene.hwf[2], pose, coords)
    np.testing.assert_allclose(ro.numpy(), jro, rtol=1e-6)
    np.testing.assert_allclose(rd.numpy(), jrd, rtol=1e-6, atol=1e-7)

    valid = banks.mask_valid[2]
    rgb = rng.random((len(coords), 3)).astype(np.float32)
    got = tstep._composite(torch.from_numpy(scene.images[2]),
                           torch.from_numpy(coords), torch.from_numpy(valid),
                           torch.from_numpy(rgb))
    img = jnp.asarray(scene.images[2])
    rgb_m = jnp.where(valid[:, None], rgb, 0.0)
    ref = img.at[coords[:, 1], coords[:, 0]].set(
        jnp.where(valid[:, None], rgb_m, img[coords[:, 1], coords[:, 0]]))
    assert not (scene.masks[2][0, 0] == 1)       # no collision at (0, 0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _loop_cfg(tmp_path, **train):
    cfg = _cfg(sd_tiny=True, cache_masked_latents=True)
    kw = dict(N_iters=4, N_rand=32, lrate=1e-2, i_print=2, i_weights=100,
              i_video=100, i_evaluate=100, i_testset=100, first_stage=False,
              basedir=str(tmp_path), expname="s2", render_factor=0)
    kw.update(train)
    return cfg.replace(
        render=dataclasses.replace(cfg.render, perturb=1.0,
                                   raw_noise_std=1.0, render_block=512),
        train=dataclasses.replace(cfg.train, **kw))


def test_train_stage2_warm_started_with_sd_tiny(tmp_path, scene, capsys):
    """Stage 1 for 3 steps, then stage 2 from its checkpoint (ft_path) for
    3 more with the tiny SD stack, the masked-latents cache and both
    modalities: finite metrics, a nonzero SDS loss, a checkpoint."""
    scene, depth_gts = scene
    s1 = _loop_cfg(tmp_path, first_stage=True, N_iters=3, expname="s1",
                   i_print=3)
    tloop.train(s1, scene=scene, depth_gts=depth_gts, device="cpu",
                log_fn=lambda i, m: None)
    cfg = _loop_cfg(tmp_path, N_iters=6, ft_path=str(tmp_path / "s1" /
                                                      "ckpt" / "3"))
    out = tloop.train(cfg, scene=scene, depth_gts=depth_gts, device="cpu",
                      log_fn=lambda i, m: None)
    text = capsys.readouterr().out
    assert "warm-start" in text and "cached 3 per-view" in text
    assert out["state"].step == 6
    hist = out["history"]
    assert [i for i, _ in hist] == [4, 6]
    for _, m in hist:
        assert all(np.isfinite(v) for v in m.values()), m
        assert m["sds_loss"] != 0.0
    assert set(out["setup_times"]) == {"sd_build_s", "masked_latents_s"}
    assert out["guidance"].latent_size == 64
    assert os.listdir(tmp_path / "s2" / "ckpt") == ["6.pt"]


def test_train_stage2_without_weights_warns_and_trains(tmp_path, scene,
                                                       capsys):
    scene, depth_gts = scene
    cfg = _loop_cfg(tmp_path, N_iters=2)
    cfg = cfg.replace(guidance=dataclasses.replace(cfg.guidance,
                                                   sd_tiny=False))
    out = tloop.train(cfg, scene=scene, depth_gts=depth_gts, device="cpu",
                      log_fn=lambda i, m: None)
    assert "guidance DISABLED" in capsys.readouterr().out
    assert out["guidance"] is None
    assert out["history"][-1][1]["sds_loss"] == 0.0


def test_stage2_unported_options_raise(scene, tmp_path):
    """A mesh builds the step (tests/test_torch_parallel.py runs it on N
    ranks) and a mesh that is not a DeviceMesh is refused; the frozen-σ
    field and colla build their steps (held against the JAX package in
    tests/test_torch_frozen_sigma.py and tests/test_torch_colla.py)."""
    import torch.distributed as dist

    from gbnerf_tpu_torch.parallel.mesh import make_mesh

    scene, _ = scene
    cfg = _cfg()
    st, tc, tf = tstate.create_train_state(cfg, torch.Generator())
    args = (cfg, tc, tf, scene.near, scene.far, scene.hwf)
    with pytest.raises(TypeError, match="DeviceMesh"):
        tstep.make_train_step_stage2(*args, mesh=object())
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        assert callable(tstep.make_train_step_stage2(*args,
                                                     mesh=make_mesh()))
    finally:
        dist.destroy_process_group()
    assert callable(tstep.make_train_step_stage2(*args, alpha=tf))
    c = cfg.replace(guidance=dataclasses.replace(cfg.guidance,
                                                 is_colla_guidance=True))
    assert callable(tstep.make_train_step_stage2(
        c, *args[1:], guidance_fn=lambda *a, **k: 0.0))


def _nog_cfg(**train):
    """tools/run_ablation.py's nog arm: no guidance, the LPIPS patch loss
    (32-pixel patches, 4 a step) and gradient_clip; lpips_weight 50 here so
    that the LPIPS term weighs as much as the image term."""
    cfg = _cfg(is_rgb_guidance=False)
    kw = dict(lpips=True, gradient_clip=True, patch_len=32, n_patches=4,
              lpips_weight=50.0)
    kw.update(train)
    return cfg.replace(train=dataclasses.replace(cfg.train, **kw))


@pytest.fixture(scope="module")
def lpips_pair():
    j = jlpips.LPIPS(jax.random.PRNGKey(9))
    return j, tlpips.LPIPS(weights=jax.tree_util.tree_map(np.asarray,
                                                          j.params))


def test_stage2_nog_loss_fn_matches_jax(scene, rng, lpips_pair):
    """The nog arm's loss: no guidance_fn, lpips_fn on (both packages on one
    set of VGG weights), gradient_clip on; the port handed the JAX draw of
    the patch centres (randint(fold_in(k_g, 7), …))."""
    scene, depth_gts = scene
    cfg = _nog_cfg()
    jl, tl = lpips_pair
    banks = build_ray_banks(scene.images, scene.masks, scene.inpainted_depths,
                            scene.poses, scene.hwf[2], depth_gts)
    b = _batch(scene, banks, rng)
    st, tc, tf = tstate.create_train_state(cfg, torch.Generator().manual_seed(
        3))
    params = jax.tree_util.tree_map(jnp.asarray, convert.params_to_jax(
        {"coarse": tc.state_dict(), "fine": tf.state_dict()}))
    jc, jf = jstate.build_field(cfg, fine=False), jstate.build_field(
        cfg, fine=True)
    step_i, key = 7, jax.random.PRNGKey(4)
    jsf = jstep.make_train_step_stage2(cfg, jc, jf, scene.near, scene.far,
                                       scene.hwf, lpips_fn=jl)
    jb = jstep.Stage2Batch(**jax.tree_util.tree_map(jnp.asarray, b))
    (ref, jmet), jg = jax.jit(jax.value_and_grad(jsf.loss_fn, has_aux=True))(
        params, jb, step_i, key)
    k_g = jax.random.split(key, 6)[5]
    count = max(int((b["mask"] > 0).sum()), 1)
    pidx = np.asarray(jax.random.randint(jax.random.fold_in(k_g, 7),
                                         (cfg.train.n_patches,), 0, count))

    tsf = tstep.make_train_step_stage2(cfg, tc, tf, scene.near, scene.far,
                                       scene.hwf, lpips_fn=tl)
    loss, m = tsf.loss_fn(tstep.Stage2Batch(**_to_torch(b)), step_i,
                          draws={"patches": torch.from_numpy(pidx.copy())})
    loss.backward()
    # the LPIPS term is a real share of the loss, and no guidance ran
    assert 0.2 < cfg.train.lpips_weight * m["lpips_loss"].item() / loss.item()
    assert m["sds_loss"].item() == 0.0 == float(jmet["sds_loss"])
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-3)
    for k in ("img_loss", "depth_loss", "sigma_loss"):
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


def test_stage2_lpips_patches_hold_the_render_at_a_masked_corner(scene, rng,
                                                                 lpips_pair):
    """A view whose pixel (0, 0) is masked: the patch cut there from the
    composite holds the render of that pixel (the port sends the padded
    entries of the masked-pixel table to a spare slot; the JAX package
    writes them back onto (0, 0), which collides with the render there),
    and the GT patch holds the GT view."""
    scene, depth_gts = scene
    scene = dataclasses.replace(scene, masks=scene.masks.copy())
    scene.masks[1, :3, :4] = 1.0
    banks = build_ray_banks(scene.images, scene.masks, scene.inpainted_depths,
                            scene.poses, scene.hwf[2], depth_gts)
    assert not banks.mask_valid[1].all()           # the table is padded
    cfg = _nog_cfg(patch_len=8)
    st, tc, tf = tstate.create_train_state(cfg, torch.Generator().manual_seed(
        5))
    seen = []

    def spy(a, b):
        seen.append((a.detach(), b))
        return tlpips_pair_fn(a, b)

    tlpips_pair_fn = lpips_pair[1]
    b = tstep.Stage2Batch(**_to_torch(_batch(scene, banks, rng)))
    step = tstep.make_train_step_stage2(cfg, tc, tf, scene.near, scene.far,
                                        scene.hwf, lpips_fn=spy)
    step.loss_fn(b, 0, draws={"patches": torch.zeros(4, dtype=torch.long)})
    (pr, pg), = seen
    render = tstep.make_render_fn(cfg, tc, tf, scene.near, scene.far,
                                  hwf=scene.hwf)
    ro, rd = tstep._masked_rays(H, W, scene.hwf[2], b.pose, b.coords[:1])
    with torch.no_grad():
        corner = render(ro, rd, train=True).rgb[0]
    assert tuple(b.coords[0].tolist()) == (0, 0)
    torch.testing.assert_close(pr[0, 0, 0], corner, rtol=1e-5, atol=1e-6)
    assert torch.equal(pg[0], b.image[:8, :8])
    assert not torch.allclose(pr[0, 0, 0], pg[0, 0, 0])
