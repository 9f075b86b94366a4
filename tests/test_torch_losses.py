"""Port vs JAX: the stage-2 losses of gbnerf_tpu/train/losses.py —
``pwclip``, ``compute_scale_and_shift``, ``gradient_loss`` and
``extract_patches``.

Tolerances: pwclip's forward is the identity on both sides (exact), its
backward the same f32 formula (rtol 1e-6); the two image losses are the
same f32 sums (rtol 1e-6); patches are gathers (exact) once the port is
handed the JAX draw.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gbnerf_tpu.train import losses as jlosses
from gbnerf_tpu_torch.train import losses as tlosses


def test_pwclip_forward_exact_backward_matches_jax(rng):
    x = rng.standard_normal((50, 3)).astype(np.float32)
    # cotangents on both sides of the clip (±1): some rows are scaled
    g = (rng.standard_normal((50, 3)) * 2.0).astype(np.float32)
    g[0] = 0.0
    for clip in (1.0, 0.3):
        y, vjp = jax.vjp(lambda v: jlosses.pwclip(v, clip), jnp.asarray(x))
        (jg,) = vjp(jnp.asarray(g))
        tx = torch.from_numpy(x).requires_grad_(True)
        ty = tlosses.pwclip(tx, clip)
        np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(y))
        (tg,) = torch.autograd.grad(ty, tx, torch.from_numpy(g))
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6)
        assert np.abs(tg.numpy()).max() <= clip * (1 + 1e-6)
        assert not np.allclose(tg.numpy(), g)          # the clip bit


def test_pwclip_keeps_each_pixels_direction():
    g = torch.tensor([[4.0, -2.0, 1.0], [0.5, 0.1, -0.2]])
    x = torch.zeros(2, 3, requires_grad=True)
    (out,) = torch.autograd.grad(tlosses.pwclip(x), x, g)
    torch.testing.assert_close(out[0], g[0] / 4.0)
    torch.testing.assert_close(out[1], g[1])


def _extras_inputs(rng):
    """tests/test_extras.py::test_scale_shift_and_gradient_loss's inputs,
    and a partial mask."""
    target = rng.random((1, 8, 8)).astype(np.float32)
    pred = (target - 0.5) / 2.0
    full = np.ones_like(target)
    part = (rng.random((1, 8, 8)) > 0.4).astype(np.float32)
    return pred, target, (full, part)


def test_scale_shift_and_gradient_loss_match_jax(rng):
    pred, target, masks = _extras_inputs(rng)
    for mask in masks + (np.zeros_like(pred),):
        args = [pred, target, mask]
        ts, tt = tlosses.compute_scale_and_shift(*map(torch.from_numpy, args))
        js, jt = jlosses.compute_scale_and_shift(*map(jnp.asarray, args))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-6)
        tg = tlosses.gradient_loss(*map(torch.from_numpy, args))
        jg = jlosses.gradient_loss(*map(jnp.asarray, args))
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6)
    ts, tt = tlosses.compute_scale_and_shift(*map(torch.from_numpy,
                                                  (pred, target, masks[0])))
    np.testing.assert_allclose(ts.numpy(), 2.0, atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), 0.5, atol=1e-4)


@pytest.mark.parametrize("case", ["mask", "corner", "empty", "small_image"])
def test_extract_patches_with_jax_draw_is_exact(rng, case):
    H, W, pl, n = 30, 41, 16, 6
    if case == "small_image":
        H, W = 12, 9                          # the patch clamps to 9
    img = rng.random((H, W, 3)).astype(np.float32)
    mask = (rng.random((H, W)) > 0.8).astype(np.float32)
    if case == "corner":                      # centres at the image edges
        mask[:] = 0
        mask[0, 0] = mask[H - 1, W - 1] = mask[0, W - 2] = 1
    if case == "empty":
        mask[:] = 0
    key = jax.random.PRNGKey(11)
    ref = jlosses.extract_patches(jnp.asarray(img), jnp.asarray(mask), pl, n,
                                  key)
    count = max(int((mask > 0).sum()), 1)
    idx = np.asarray(jax.random.randint(key, (n,), 0, count))
    got = tlosses.extract_patches(torch.from_numpy(img),
                                  torch.from_numpy(mask), pl, n,
                                  idx=torch.from_numpy(idx.copy()))
    assert got.shape == ref.shape == (n, min(pl, H, W), min(pl, H, W), 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_extract_patches_draws_inside_the_mask(rng):
    """Without idx, the centres are drawn from the generator over the mask
    pixels > 0 only (not over all H·W entries of the table): a patch of
    the mask itself is centred on a 1."""
    H, W = 40, 50
    mask = np.zeros((H, W), np.float32)
    mask[5:9, 30:33] = 1.0
    m = torch.from_numpy(mask)
    idx = tlosses.draw_patch_idx(m, 200, torch.Generator().manual_seed(0))
    assert int(idx.min()) >= 0 and int(idx.max()) < 12
    assert len(set(idx.tolist())) == 12
    pm = tlosses.extract_patches(m[..., None], m, 3, 200, idx=idx)
    assert torch.all(pm[:, 1, 1, 0] == 1)
    a = tlosses.extract_patches(m[..., None], m, 8, 5,
                                torch.Generator().manual_seed(3))
    b = tlosses.extract_patches(m[..., None], m, 8, 5,
                                torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
