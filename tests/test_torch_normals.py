"""Port vs JAX: normal maps from rendered depth (core/normals.py) —
``depth2xyz``, the integral-image ``_box_sum`` (also against a brute-force
window sum), ``depth2normal_geo`` forward and gradient (windows inside the
map, larger than the map, and an exactly singular window), and
``render_normal_map``.

Tolerances, with their reasons: the box sums in f32 are cumulative sums,
which XLA and torch associate differently: rtol 1e-5, atol 1e-5·max|ref|.
The normals solve a near-planar least-squares fit whose adjugate terms
cancel (myy·mzz − myz² …): in f32 that amplifies the cumsum's roundings to
≈ 1e-3 of max|n|, so they are held in f64 (both packages), where the
algorithm is the only difference left: rtol 1e-8, atol 1e-10·max|ref|,
forward and gradient. The singular window's zero normal: exact.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gbnerf_tpu.core import normals as jn
from gbnerf_tpu_torch.core import normals as tn

torch.set_num_threads(1)
RTOL64, ATOL64 = 1e-8, 1e-10


class x64:
    """JAX float64 for the duration of a with-block."""

    def __enter__(self):
        jax.config.update("jax_enable_x64", True)

    def __exit__(self, *exc):
        jax.config.update("jax_enable_x64", False)


def _close(got, ref, rtol, atol_frac):
    ref = np.asarray(ref)
    np.testing.assert_allclose(
        got.detach().numpy(), ref, rtol=rtol,
        atol=atol_frac * max(float(np.abs(ref).max()), 1e-30))


def _K(H, W, focal):
    return np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]],
                    np.float64)


def _depth(rng, H, W):
    """A tilted plane with a bump and noise, 2…4 units away."""
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    d = (3.0 + 0.02 * x - 0.015 * y
         + 0.3 * np.exp(-((x - W / 2) ** 2 + (y - H / 2) ** 2) / 20.0))
    return d + 0.01 * rng.standard_normal((H, W))


@pytest.mark.parametrize("k", [3, 5, 31])
def test_box_sum_matches_jax_and_brute_force(rng, k):
    x = rng.standard_normal((9, 12, 4)).astype(np.float32)
    got = tn._box_sum(torch.from_numpy(x), k)
    _close(got, jn._box_sum(jnp.asarray(x), k), rtol=1e-5, atol_frac=1e-5)
    r = k // 2
    pad = np.pad(x.astype(np.float64), ((r, r), (r, r), (0, 0)))
    brute = np.stack([np.stack([pad[i:i + k, j:j + k].sum((0, 1))
                                for j in range(12)]) for i in range(9)])
    _close(got, brute, rtol=1e-5, atol_frac=1e-5)


@pytest.mark.parametrize("H,W,k", [(12, 16, 5), (27, 36, 31), (9, 12, 31)])
def test_depth2normal_geo_forward_and_grad_match_jax(rng, H, W, k):
    """(27, 36): the stage-2 normal map of a 189 × 252 view at factor 7;
    (9, 12) with k = 31: every window spans the whole map."""
    depth = _depth(rng, H, W)
    K = _K(H, W, 1.2 * W)
    g = rng.standard_normal((H, W, 3))

    def jf(d):
        n = jn.depth2normal_geo(jn.depth2xyz(d, K), k=k)
        return jnp.sum(n * g), n

    with x64():
        (_, ref), jg = jax.jit(jax.value_and_grad(jf, has_aux=True))(depth)
        pts_ref = jn.depth2xyz(depth, K)
        nmap_ref = jn.render_normal_map(depth, K, k=k)
    d = torch.from_numpy(depth).requires_grad_(True)
    pts = tn.depth2xyz(d, torch.from_numpy(K))
    _close(pts, pts_ref, rtol=RTOL64, atol_frac=ATOL64)
    n = tn.depth2normal_geo(pts, k=k)
    torch.sum(n * torch.from_numpy(g)).backward()
    _close(n, ref, rtol=RTOL64, atol_frac=ATOL64)
    _close(d.grad, jg, rtol=RTOL64, atol_frac=ATOL64)
    _close(tn.render_normal_map(d, torch.from_numpy(K), k=k), nmap_ref,
           rtol=RTOL64, atol_frac=ATOL64)


def test_singular_window_gives_zero_normal_and_finite_grad(rng):
    """A zero-depth patch larger than the window: the points are all 0, the
    window's matrix is exactly singular, the normal is 0 and the gradient
    finite (the double where), as in the JAX package."""
    depth = _depth(rng, 16, 16)
    depth[:9, :9] = 0.0
    K = _K(16, 16, 20.0)
    d = torch.from_numpy(depth).requires_grad_(True)
    n = tn.depth2normal_geo(tn.depth2xyz(d, torch.from_numpy(K)), k=5)
    n.sum().backward()
    with x64():
        ref = jn.depth2normal_geo(jn.depth2xyz(depth, K), k=5)
        jg = jax.grad(lambda x: jnp.sum(jn.depth2normal_geo(
            jn.depth2xyz(x, K), k=5)))(depth)
    assert bool(torch.isfinite(d.grad).all())
    assert torch.equal(n[:5, :5], torch.zeros(5, 5, 3, dtype=n.dtype))
    np.testing.assert_array_equal(np.asarray(ref)[:5, :5], 0.0)
    _close(n, ref, rtol=RTOL64, atol_frac=ATOL64)
    _close(d.grad, jg, rtol=RTOL64, atol_frac=ATOL64)
