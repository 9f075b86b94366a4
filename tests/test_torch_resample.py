"""Port vs JAX: z sampling, the inverse CDF, the z-merge and the scans.

The merge (K3's plain version) is a permutation of its input, so it must
equal the JAX bitonic kernel (run in interpret mode on the CPU) exactly,
ties included. The inverse CDF sums in another order than XLA, so it is
held at f32 tolerance, and the last deterministic sample (u = 1.0) by
interval membership (the documented divergence, ops/resample.py:30-35).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gbnerf_tpu.core import sampling as jsamp
from gbnerf_tpu.ops import resample as jres
from gbnerf_tpu.ops import scan as jscan
from gbnerf_tpu_torch.core import sampling as tsamp
from gbnerf_tpu_torch.ops import resample as tres
from gbnerf_tpu_torch.ops import scan as tscan

torch.set_num_threads(1)


@pytest.mark.parametrize("split", [64, 48])
def test_merge128_plain_matches_jax_kernel(rng, split):
    a = np.sort(rng.random((37, split)).astype(np.float32), axis=-1)
    b = np.sort(rng.random((37, 128 - split)).astype(np.float32), axis=-1)
    ref = np.asarray(jres._merge128(jnp.asarray(a), jnp.asarray(b)))
    x = torch.from_numpy(np.concatenate([a, b], -1))
    np.testing.assert_array_equal(tres.merge128(x, split).numpy(), ref)
    got = tres.merge_sorted_fast(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_merge128_with_ties_matches_jax_kernel(rng):
    vals = rng.integers(0, 10, size=(21, 128)).astype(np.float32)
    a = np.sort(vals[:, :64], axis=-1)
    b = np.sort(vals[:, 64:], axis=-1)
    ref = np.asarray(jres._merge128(jnp.asarray(a), jnp.asarray(b)))
    got = tres.merge_sorted_fast(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_merge_sorted_fast_other_shapes_match_jax(rng):
    a = np.sort(rng.random((11, 64)).astype(np.float32), axis=-1)
    b = np.sort(rng.random((11, 48)).astype(np.float32), axis=-1)
    ref = np.asarray(jres.merge_sorted_fast(jnp.asarray(a), jnp.asarray(b)))
    got = tres.merge_sorted_fast(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_merge_sorted_fast_takes_a_broadcast_row(rng):
    """The render's z_vals is one row expanded over the rays (stride 0)."""
    row = np.sort(rng.random(64).astype(np.float32))
    b = np.sort(rng.random((9, 64)).astype(np.float32), axis=-1)
    a = torch.from_numpy(row).expand(9, 64)
    got = tres.merge_sorted_fast(a, torch.from_numpy(b)).numpy()
    ref = np.sort(np.concatenate([np.broadcast_to(row, (9, 64)), b], -1), -1)
    np.testing.assert_array_equal(got, ref)


def _tied_halves(rng, rows):
    """Two per-row sorted halves of 64 with ties within and across them."""
    vals = rng.integers(0, 12, size=(rows, 128)).astype(np.float32)
    return np.sort(vals[:, :64], axis=-1), np.sort(vals[:, 64:], axis=-1)


def test_merge128_grad_matches_jax_vjp_with_ties(rng):
    """The gradient through merge_sorted_fast (the stable sort's backward on
    the CPU) equals jax.vjp of the JAX _merge128 (its custom VJP, the
    Pallas forward in interpret mode) exactly, ties included: both route
    the cotangent through the stable sort's permutation."""
    a, b = _tied_halves(rng, 19)
    g = rng.standard_normal((19, 128)).astype(np.float32)
    out, vjp = jax.vjp(jres._merge128, jnp.asarray(a), jnp.asarray(b))
    ja, jb = vjp(jnp.asarray(g))
    ta, tb = (torch.from_numpy(x).requires_grad_(True) for x in (a, b))
    got = tres.merge_sorted_fast(ta, tb)
    got.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(out))
    np.testing.assert_array_equal(ta.grad.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tb.grad.numpy(), np.asarray(jb))


def test_merge128_function_backward_is_the_stable_sorts(rng, monkeypatch):
    """The card's autograd Function, with K3 replaced by its plain version:
    its backward gives exactly the CPU path's gradient, ties included."""
    monkeypatch.setattr(tres, "_launch_merge", tres.merge128_plain)
    a, b = _tied_halves(rng, 23)
    x = np.concatenate([a, b], -1)
    g = torch.from_numpy(rng.standard_normal((23, 128)).astype(np.float32))
    xf = torch.from_numpy(x).requires_grad_(True)
    out = tres._Merge128.apply(xf, 64)
    (dx,) = torch.autograd.grad(out, xf, g)
    xp = torch.from_numpy(x).requires_grad_(True)
    (ref,) = torch.autograd.grad(tres.merge128(xp, 64), xp, g)
    assert torch.equal(out, tres.merge128_plain(xp.detach(), 64))
    assert torch.equal(dx, ref)


@pytest.mark.cuda
def test_merge128_grad_on_the_card_equals_the_cpu(rng):
    """K3 with a gradient on the card: the forward bit-equal to the stable
    sort and the gradient of a random cotangent equal to the CPU plain
    path's, ties included. chip_smoke.py makes the same check there."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K3 is CUDA C++; no CPU mode)")
    a, b = _tied_halves(rng, 1000)
    x = torch.from_numpy(np.concatenate([a, b], -1))
    g = torch.from_numpy(rng.standard_normal((1000, 128)).astype(np.float32))
    res = []
    for dev in ("cuda:0", "cpu"):
        xd = x.to(dev).requires_grad_(True)
        out = tres.merge128(xd, 64)
        (dx,) = torch.autograd.grad(out, xd, g.to(dev))
        res.append((out.detach().cpu(), dx.cpu()))
    assert torch.equal(res[0][0], res[1][0])
    assert torch.equal(res[0][1], res[1][1])


@pytest.mark.parametrize("case", ["meta_device", "not_contiguous",
                                  "wrong_width", "bad_split", "wrong_dtype"])
def test_merge128_wrapper_refuses(case):
    """Only a CPU tensor takes the plain version; the kernel's argument
    checks raise on what csrc/resample.cu does not take."""
    x = torch.zeros(8, 128)
    with pytest.raises(ValueError):
        if case == "meta_device":
            tres.merge128(x.to("meta"), 64)
        elif case == "not_contiguous":
            tres.check_merge_args(torch.zeros(128, 8).t(), 64)
        elif case == "wrong_width":
            tres.check_merge_args(torch.zeros(8, 96), 64)
        elif case == "bad_split":
            tres.check_merge_args(x, 128)
        else:
            tres.check_merge_args(x.double(), 64)


def _bins_weights(rng, n, nb):
    bins = np.sort(rng.random((n, nb)).astype(np.float32) * 5, axis=-1)
    weights = rng.random((n, nb - 1)).astype(np.float32)
    return bins, weights


def test_sample_pdf_fast_det_matches_jax(rng):
    bins, weights = _bins_weights(rng, 16, 63)
    got = tres.sample_pdf_fast(torch.from_numpy(bins),
                               torch.from_numpy(weights), 64, det=True).numpy()
    ref = np.asarray(jres.sample_pdf_fast(jnp.asarray(bins),
                                          jnp.asarray(weights), 64, det=True))
    np.testing.assert_allclose(got[:, :-1], ref[:, :-1], atol=2e-5)
    # u = 1.0: compare by membership of the last interval, where both lie
    assert (got[:, -1] >= bins[:, -2] - 1e-6).all()
    assert (got[:, -1] <= bins[:, -1] + 1e-6).all()


def test_sample_pdf_fast_injected_u_matches_jax(rng):
    bins, weights = _bins_weights(rng, 8, 33)
    u = np.sort(rng.random((8, 32)).astype(np.float32), axis=-1) * 0.999
    got = tres.sample_pdf_fast(torch.from_numpy(bins),
                               torch.from_numpy(weights), 32,
                               u=torch.from_numpy(u)).numpy()
    ref = np.asarray(jres.sample_pdf_fast(jnp.asarray(bins),
                                          jnp.asarray(weights), 32,
                                          u=jnp.asarray(u)))
    np.testing.assert_allclose(got, ref, atol=2e-5)


def test_sample_pdf_oracle_matches_jax(rng):
    bins, weights = _bins_weights(rng, 8, 33)
    u = rng.random((8, 32)).astype(np.float32)
    for kw in ({"u": u}, {"det": True}):
        t_kw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                for k, v in kw.items()}
        j_kw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                for k, v in kw.items()}
        got = tsamp.sample_pdf(torch.from_numpy(bins),
                               torch.from_numpy(weights), 32, **t_kw).numpy()
        ref = np.asarray(jsamp.sample_pdf(jnp.asarray(bins),
                                          jnp.asarray(weights), 32, **j_kw))
        np.testing.assert_allclose(got, ref, atol=2e-5)


def test_sorted_uniform_is_sorted_and_uniform():
    g = torch.Generator().manual_seed(0)
    u = tres.sorted_uniform((4096, 16), generator=g)
    assert u.shape == (4096, 16)
    assert bool((u[:, 1:] >= u[:, :-1]).all())
    assert bool((u > 0).all()) and bool((u < 1).all())
    # order statistics of 16 uniforms: E[u_(i)] = i / 17
    mean = u.mean(0).numpy()
    np.testing.assert_allclose(mean, np.arange(1, 17) / 17.0, atol=0.01)


@pytest.mark.parametrize("lindisp", [False, True])
@pytest.mark.parametrize("perturb", [False, True])
def test_stratified_z_vals_matches_jax(rng, lindisp, perturb):
    near = rng.uniform(0.3, 0.8, (12, 1)).astype(np.float32)
    far = rng.uniform(3.0, 5.0, (12, 1)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    ref = np.asarray(jsamp.stratified_z_vals(
        jnp.asarray(near), jnp.asarray(far), 33, lindisp=lindisp,
        perturb=perturb, rng=key))
    # the JAX jitter draw, injected into the port
    t_rand = np.array(jax.random.uniform(key, (12, 33), dtype=jnp.float32))
    got = tsamp.stratified_z_vals(
        torch.from_numpy(near), torch.from_numpy(far), 33, lindisp=lindisp,
        perturb=perturb, t_rand=torch.from_numpy(t_rand)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_merge_z_vals_matches_jax(rng):
    a = rng.random((5, 17)).astype(np.float32)
    b = rng.random((5, 9)).astype(np.float32)
    got = tsamp.merge_z_vals(torch.from_numpy(a), torch.from_numpy(b))
    ref = jsamp.merge_z_vals(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_scans_match_jax_non_tpu_branch(rng):
    x = rng.random((19, 64)).astype(np.float32)
    x[:, 5] = 0.0                               # opaque sample: 1 − α = 0
    for excl in (False, True):
        np.testing.assert_allclose(
            tscan.cumsum_last(torch.from_numpy(x), exclusive=excl).numpy(),
            np.asarray(jscan.cumsum_last(jnp.asarray(x), exclusive=excl)),
            rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        tscan.cumprod_last_exclusive(torch.from_numpy(x), eps=1e-10).numpy(),
        np.asarray(jscan.cumprod_last_exclusive(jnp.asarray(x), eps=1e-10)),
        rtol=1e-5, atol=1e-30)
