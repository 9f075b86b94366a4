"""Port vs JAX: the standalone CP encode (K6's plain version, the autograd
Function around it, ``cp_encode_fused``) and the K6 wrapper's refusals.

The encode has two nonzero taps per axis and products of two bf16 values,
exact in f32, so the port's plain version equals JAX's ``_xla_impl`` and
its Pallas ``_kernel`` (run here in interpret mode) to the last bit, and
so do their gradients through JAX's custom VJP. Points on 0, 1 and the
grid nodes sit on the ties of clip, max and |·|, where the gradient
conventions of JAX and of torch.clamp/relu/abs differ; they are in every
case. The per-level paths add ``upsample_lines``, whose f32 einsum may
round differently in the two frameworks (test_torch_field.py holds it to
1e-7): a one-ulp change of a line value can flip its bf16 rounding, so
those cases allow one bf16 step, 2^-7 relative, plus 1e-7·max|ref|.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from gbnerf_tpu.ops import cp_pallas as jcpp
from gbnerf_tpu_torch.ops import cp_pallas as tcpp

torch.set_num_threads(1)


def _points(rng, n, r_max):
    """Uniform points with ties in front: the corners 0 and 1, points past
    them, and points on grid nodes."""
    x = rng.random((n, 3)).astype(np.float32)
    x[0], x[1] = 0.0, 1.0
    x[2] = (-0.25, 1.5, 0.5)
    nodes = rng.integers(0, r_max, (min(24, n - 3), 3)) / (r_max - 1)
    x[3:3 + len(nodes)] = nodes.astype(np.float32)
    return x


def _jax_kernel_fwd(x01, ulines, r_max):
    """The JAX package's ``_fwd_impl`` with its ``_kernel`` in interpret
    mode (the package's own call has no interpret switch)."""
    n, feat = x01.shape[0], ulines.shape[-1]
    tile = jcpp.TILE
    ntiles = -(-n // tile)
    xp = jnp.pad(x01, ((0, ntiles * tile - n), (0, 0)))
    out = pl.pallas_call(
        functools.partial(jcpp._kernel, r_max=r_max, feat_dim=feat),
        grid=(ntiles,),
        in_specs=[pl.BlockSpec((tile, 3), lambda i: (i, 0)),
                  pl.BlockSpec((3, r_max, feat), lambda i: (0, 0, 0))],
        out_specs=pl.BlockSpec((tile, feat), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((ntiles * tile, feat), jnp.float32),
        interpret=True,
    )(xp, ulines)
    return out[:n]


@pytest.fixture
def jax_kernel(monkeypatch):
    monkeypatch.setattr(jcpp, "_fwd_impl", _jax_kernel_fwd)


SHAPES = [(17, 8, 40), (65, 24, 300), (257, 80, 700)]


@pytest.mark.parametrize("r_max,feat,n", SHAPES)
def test_encode_plain_equals_jax_xla_impl(rng, r_max, feat, n):
    x = _points(rng, n, r_max)
    ul = rng.standard_normal((3, r_max, feat)).astype(np.float32)
    got = tcpp.encode_plain(torch.from_numpy(x), torch.from_numpy(ul), r_max)
    ref = jcpp._xla_impl(jnp.asarray(x), jnp.asarray(ul), r_max)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("r_max,feat,n", SHAPES)
def test_encode_plain_equals_jax_pallas_kernel(rng, r_max, feat, n):
    x = _points(rng, n, r_max)
    ul = rng.standard_normal((3, r_max, feat)).astype(np.float32)
    got = tcpp.encode_plain(torch.from_numpy(x), torch.from_numpy(ul), r_max)
    ref = _jax_kernel_fwd(jnp.asarray(x), jnp.asarray(ul), r_max)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("jax_ref", ["xla_impl", "pallas_kernel"])
def test_encode_plain_passes_nan_points_like_jax(rng, jax_ref):
    """A NaN coordinate gives a row of NaN features on both sides (clip and
    maximum pass NaN on); the kernel keeps it so (cp_tap in
    csrc/field_common.cuh), and the other rows are untouched."""
    x = _points(rng, 40, 17)
    x[5, 1] = x[30, 0] = np.nan
    ul = rng.standard_normal((3, 17, 8)).astype(np.float32)
    got = tcpp.encode_plain(torch.from_numpy(x), torch.from_numpy(ul),
                            17).numpy()
    ref_fn = jcpp._xla_impl if jax_ref == "xla_impl" else _jax_kernel_fwd
    ref = np.asarray(ref_fn(jnp.asarray(x), jnp.asarray(ul), 17))
    np.testing.assert_array_equal(got, ref)          # NaNs in the same places
    assert np.isnan(got[[5, 30]]).all()
    assert np.isfinite(np.delete(got, [5, 30], axis=0)).all()


def _per_level(rng, resolutions, rank):
    return [(rng.standard_normal((3, r, rank)) * 0.5).astype(np.float32)
            for r in resolutions]


def _close_bf16(got, ref):
    ref = np.asarray(ref)
    atol = 1e-7 * np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=2.0 ** -7, atol=atol)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("resolutions,rank,n", [
    ((17, 33, 65, 129, 257), 16, 512), ((17, 33, 65, 129, 257), 16, 333),
    ((17, 33, 65), 8, 512), ((17, 33, 65), 8, 77)])
def test_cp_encode_fused_matches_jax(rng, jax_kernel, resolutions, rank, n,
                                     use_pallas):
    lines = _per_level(rng, resolutions, rank)
    x = _points(rng, n, max(resolutions))
    got = tcpp.cp_encode_fused(torch.from_numpy(x),
                               [torch.from_numpy(l) for l in lines],
                               use_pallas=use_pallas)
    ref = jcpp.cp_encode_fused(jnp.asarray(x), [jnp.asarray(l) for l in lines],
                               use_pallas=use_pallas)
    assert got.shape == (n, len(resolutions) * rank)
    _close_bf16(got.numpy(), ref)


@pytest.mark.parametrize("r_max,feat,n", [(17, 8, 40), (65, 24, 300)])
def test_cp_encode_unified_gradients_match_jax_vjp(rng, jax_kernel, r_max,
                                                   feat, n):
    """Through JAX's custom VJP (forward: the interpreted kernel; backward:
    ``_bwd``, the vjp of ``_xla_impl``): dx and dlines to the last bit,
    ties included."""
    x = _points(rng, n, r_max)
    ul = rng.standard_normal((3, r_max, feat)).astype(np.float32)
    g = rng.standard_normal((n, feat)).astype(np.float32)
    out, vjp = jax.vjp(lambda a, b: jcpp.cp_encode_unified(a, b, r_max),
                       jnp.asarray(x), jnp.asarray(ul))
    jdx, jdl = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    lt = torch.from_numpy(ul).requires_grad_(True)
    o = tcpp.cp_encode_unified(xt, lt, r_max)
    dx, dl = torch.autograd.grad(o, (xt, lt), torch.from_numpy(g))
    np.testing.assert_array_equal(o.detach().numpy(), np.asarray(out))
    np.testing.assert_array_equal(dx.numpy(), np.asarray(jdx))
    np.testing.assert_array_equal(dl.numpy(), np.asarray(jdl))
    # the ties are where the conventions part: torch.clamp/relu/abs would
    # give another dx on the corner and node points
    assert np.abs(np.asarray(jdx)[:27]).max() > 0


def test_gradient_flows_to_per_level_lines(rng):
    """cp_encode_fused(use_pallas=True) reaches the per-level lines through
    the upsampling, as the JAX package's does."""
    lines = [torch.from_numpy(l).requires_grad_(True)
             for l in _per_level(rng, (17, 33), 4)]
    x = torch.from_numpy(_points(rng, 50, 33))
    tcpp.cp_encode_fused(x, lines, use_pallas=True).square().sum().backward()
    assert all(l.grad is not None and torch.isfinite(l.grad).all()
               and l.grad.abs().sum() > 0 for l in lines)


def _refusal_cases():
    ok_x = torch.rand(8, 3)
    ok_l = torch.randn(3, 17, 8)
    misaligned = torch.empty(3 * 17 * 8 + 1)[1:].view(3, 17, 8)
    return {
        "feat not a multiple of 4": (ok_x, torch.randn(3, 17, 6), 17),
        "x01 not float32": (ok_x.double(), ok_l, 17),
        "lines not float32": (ok_x, ok_l.to(torch.bfloat16), 17),
        "x01 not contiguous": (torch.rand(3, 8).t(), ok_l, 17),
        "lines not contiguous": (ok_x, torch.randn(3, 8, 17).transpose(1, 2),
                                 17),
        "x01 not [N, 3]": (torch.rand(8, 4), ok_l, 17),
        "r_max disagrees": (ok_x, ok_l, 33),
        "mixed devices": (ok_x.to("meta"), ok_l, 17),
        "too many points": (torch.empty((1 << 29, 3), device="meta"),
                            torch.empty((3, 17, 8), device="meta"), 17),
        "lines misaligned": (ok_x, misaligned, 17),
        "lines exceed shared memory": (ok_x, torch.empty(3, 513, 80), 513),
    }


@pytest.mark.parametrize("case", sorted(_refusal_cases()))
def test_kernel_wrapper_refuses(case):
    x, ul, r_max = _refusal_cases()[case]
    with pytest.raises(ValueError):
        tcpp.check_encode_args(x, ul, r_max)


def test_kernel_wrapper_needs_cuda_and_the_function_a_known_device():
    with pytest.raises(ValueError, match="CUDA"):
        tcpp.encode_kernel(torch.rand(8, 3), torch.randn(3, 17, 8), 17)
    with pytest.raises(ValueError, match="device"):
        tcpp.cp_encode_unified(torch.rand(8, 3, device="meta"),
                               torch.randn(3, 17, 8, device="meta"), 17)
    # the launch counter moves only where the kernel launches: not on the
    # CPU's plain version
    before = dict(tcpp.LAUNCHES)
    tcpp.cp_encode_unified(torch.rand(8, 3), torch.randn(3, 17, 8), 17)
    assert tcpp.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("r_max,feat,n", [(257, 80, 65536 - 29),
                                          (65, 24, 4099)])
def test_kernel_equals_plain_on_the_card(rng, r_max, feat, n):
    """K6 against its plain version on the card: bit-equal (same taps,
    same roundings), ragged N; and the gradient against the CPU's. pytest
    does not run on the GPU machine (tests/conftest.py imports JAX):
    chip_smoke.py makes the same checks there."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K6 is CUDA C++; no CPU mode)")
    dev = torch.device("cuda:0")
    x = torch.from_numpy(_points(rng, n, r_max))
    ul = torch.from_numpy(rng.standard_normal((3, r_max, feat)).astype(
        np.float32))
    before = tcpp.LAUNCHES["cp_encode"]
    got = tcpp.cp_encode_unified(x.to(dev), ul.to(dev), r_max)
    assert tcpp.LAUNCHES["cp_encode"] == before + 1
    ref = tcpp.encode_plain(x.to(dev), ul.to(dev), r_max)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    xg = x[:4096].to(dev).requires_grad_(True)
    lg = ul.to(dev).requires_grad_(True)
    g = torch.randn(xg.shape[0], feat, generator=torch.Generator().manual_seed(0))
    dx, dl = torch.autograd.grad(tcpp.cp_encode_unified(xg, lg, r_max),
                                 (xg, lg), g.to(dev))
    xc = x[:4096].clone().requires_grad_(True)
    lc = ul.clone().requires_grad_(True)
    rdx, rdl = torch.autograd.grad(tcpp.cp_encode_unified(xc, lc, r_max),
                                   (xc, lc), g)
    # the backward rounds its cotangents to bf16 (as JAX's does) after f32
    # sums taken in another order on the card: one bf16 step (2^-7
    # relative), and 5e-3·max where the three axes' terms cancel
    for a, b in ((dx.cpu(), rdx), (dl.cpu(), rdl)):
        torch.testing.assert_close(a, b, rtol=2.0 ** -7,
                                   atol=5e-3 * float(b.abs().max()))
