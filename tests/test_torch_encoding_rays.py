"""Port vs JAX: encodings, camera rays and the full-view ray grid.

The same numpy inputs go through the JAX function and its counterpart in
gbnerf_tpu_torch. All of it is elementwise f32 arithmetic in the same
order, so agreement is held to a few f32 ulps.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gbnerf_tpu.core import encoding as jenc
from gbnerf_tpu.core import rays as jrays
from gbnerf_tpu.train.step import _full_view_rays as j_full_view_rays
from gbnerf_tpu_torch.core import encoding as tenc
from gbnerf_tpu_torch.core import rays as trays
from gbnerf_tpu_torch.train.step import _full_view_rays as t_full_view_rays

torch.set_num_threads(1)


def _dirs(rng, n):
    d = rng.standard_normal((n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


@pytest.mark.parametrize("degree", [1, 2, 3, 4])
def test_sh_encode_matches_jax(rng, degree):
    d = _dirs(rng, 257)
    got = tenc.sh_encode(torch.from_numpy(d), degree).numpy()
    ref = np.asarray(jenc.sh_encode(jnp.asarray(d), degree))
    assert got.shape == (257, degree ** 2)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("num_freqs,include_input,log_sampling",
                         [(4, True, True), (10, True, True),
                          (6, False, False), (0, True, True)])
def test_freq_encode_matches_jax(rng, num_freqs, include_input, log_sampling):
    x = rng.uniform(-2, 2, (31, 5, 3)).astype(np.float32)
    got = tenc.freq_encode(torch.from_numpy(x), num_freqs, include_input,
                           log_sampling).numpy()
    ref = np.asarray(jenc.freq_encode(jnp.asarray(x), num_freqs,
                                      include_input, log_sampling))
    assert got.shape[-1] == tenc.freq_encode_dim(3, num_freqs, include_input)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=2e-5)


def _pose(rng):
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    return np.concatenate([q, rng.standard_normal((3, 1))], 1).astype(np.float32)


def test_get_rays_matches_jax(rng):
    c2w = _pose(rng)
    ro, rd = trays.get_rays(7, 9, 5.5, torch.from_numpy(c2w))
    jo, jd = jrays.get_rays(7, 9, 5.5, jnp.asarray(c2w))
    np.testing.assert_allclose(ro.numpy(), np.asarray(jo), rtol=1e-6)
    np.testing.assert_allclose(rd.numpy(), np.asarray(jd), rtol=1e-6,
                               atol=1e-6)


def test_ndc_rays_matches_jax(rng):
    ro = rng.standard_normal((40, 3)).astype(np.float32) * 0.3
    rd = rng.standard_normal((40, 3)).astype(np.float32)
    rd[:, 2] = -np.abs(rd[:, 2]) - 0.5                # forward-facing
    got = trays.ndc_rays(24, 32, 30.0, 1.0, torch.from_numpy(ro),
                         torch.from_numpy(rd))
    ref = jrays.ndc_rays(24, 32, 30.0, 1.0, jnp.asarray(ro), jnp.asarray(rd))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-6)


def test_full_view_rays_matches_jax(rng):
    pose = _pose(rng)
    ro, rd = t_full_view_rays(6, 10, 7.25, torch.from_numpy(pose))
    jo, jd = j_full_view_rays(6, 10, 7.25, jnp.asarray(pose))
    assert ro.shape == rd.shape == (6, 10, 3)
    np.testing.assert_allclose(ro.numpy(), np.asarray(jo), rtol=1e-6)
    np.testing.assert_allclose(rd.numpy(), np.asarray(jd), rtol=1e-6,
                               atol=1e-6)
