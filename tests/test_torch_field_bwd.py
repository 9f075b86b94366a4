"""Port vs JAX: the fused field's backward (K4/K5's plain version), the
autograd wrapper around K1/K4 and K2/K5, and the gradients of the CP field.

``field_bwd_plain`` is held against ``jax.vjp`` of the JAX ``_oracle`` and
against the JAX Pallas backward kernels in interpret mode
(``_pallas_bwd``/``_pallas_bwd_sigma``), with the sizes, tie-free points
and tolerances of tests/test_field_bwd.py: rtol 3e-2 and atol 5e-3 · max,
for dx rtol 5e-2 and atol 8e-3 · max. Both sides round every matmul operand
to bf16 and accumulate in f32; the kernel rounds the cotangent entering
each product where the re-linearised oracle rounds the product's result,
and the Σ_R signed sum of dx amplifies that difference.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import gbnerf_tpu.ops.field_fused as jff
from gbnerf_tpu.core import cp_field as jcp
from gbnerf_tpu_torch import convert
from gbnerf_tpu_torch.core import cp_field as tcp
from gbnerf_tpu_torch.ops import field_fused as tff

torch.set_num_threads(1)

R_MAX, FEAT, SH_DIM, TILE = 33, 16, 16, 256
K = jff.W_KEYS


def _mats(rng, n, r_max=R_MAX, feat=FEAT):
    # off grid nodes and the clip boundary (tests/test_field_bwd.py::_mats)
    x01 = (0.03 + 0.94 * rng.random((n, 3))).astype(np.float32)
    u = x01 * (r_max - 1)
    x01 += ((np.abs(u - np.round(u)) < 1e-3) * 2e-3).astype(np.float32)
    sh = rng.standard_normal((n, SH_DIM)).astype(np.float32) * 0.5
    ulines = rng.standard_normal((3, r_max, feat)).astype(np.float32) * 0.5
    Ws = {
        "ws0": rng.standard_normal((feat, 64)).astype(np.float32) * 0.2,
        "ws1": rng.standard_normal((64, 16)).astype(np.float32) * 0.2,
        "wc0": rng.standard_normal((SH_DIM + 15, 64)).astype(np.float32) * 0.2,
        "wc1": rng.standard_normal((64, 64)).astype(np.float32) * 0.2,
        "wc2": rng.standard_normal((64, 3)).astype(np.float32) * 0.2,
    }
    g = rng.standard_normal((n, 4)).astype(np.float32)
    return x01, sh, ulines, Ws, g


def _close(a, b, name, rtol=3e-2, atol_frac=5e-3):
    a, b = np.asarray(a), np.asarray(b)
    atol = atol_frac * max(np.abs(b).max(), 1e-3)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=name)


def _close_all(got, ref, names):
    for name, a, b in zip(names, got, ref):
        if name == "dx":
            _close(a, b, name, rtol=5e-2, atol_frac=8e-3)
        else:
            _close(a, b, name)


def _plain(x01, sh, ulines, Ws, g, sigma_only):
    t = torch.from_numpy
    keys = K[:2] if sigma_only else K
    dx, dsh, dul, dWs = tff.field_bwd_plain(
        t(x01), None if sigma_only else t(sh), t(ulines),
        {k: t(Ws[k]) for k in keys}, t(g), sigma_only=sigma_only)
    out = [dx, dul] if sigma_only else [dx, dsh, dul]
    return [v.numpy() for v in out + [dWs[k] for k in keys]]


def _j(a):
    return jnp.asarray(a)


@pytest.mark.parametrize("n", [256, 300])      # a full tile and a ragged tail
def test_bwd_plain_matches_jax_oracle_vjp(rng, n):
    x01, sh, ulines, Ws, g = _mats(rng, n)

    @jax.jit
    def ref_fn(g, *args):
        _, vjp = jax.vjp(
            lambda x, s, ul, a, b, c, d, e: jff._oracle(
                x, s, ul, dict(zip(K, (a, b, c, d, e))), sigma_only=False),
            *args)
        return vjp(g)

    ref = ref_fn(_j(g), _j(x01), _j(sh), _j(ulines), *(_j(Ws[k]) for k in K))
    got = _plain(x01, sh, ulines, Ws, g, False)
    _close_all(got, ref, ("dx", "dsh", "dul") + K)


@pytest.mark.parametrize("n", [256, 300])
def test_bwd_plain_matches_jax_pallas_kernel(rng, n):
    x01, sh, ulines, Ws, g = _mats(rng, n)
    dx, dsh, dul, dWs = jff._pallas_bwd(
        _j(x01), _j(sh), _j(ulines), {k: _j(v) for k, v in Ws.items()},
        _j(g), sigma_only=False, interpret=True, tile=TILE)
    got = _plain(x01, sh, ulines, Ws, g, False)
    _close_all(got, [dx, dsh, dul] + [dWs[k] for k in K],
               ("dx", "dsh", "dul") + K)


@pytest.mark.parametrize("n", [256, 300])
def test_bwd_sigma_plain_matches_jax_oracle_and_pallas(rng, n):
    x01, _, ulines, Ws, g = _mats(rng, n)
    g[:, :3] = 0.0          # the σ-only variant's rgb rows are zeros

    def oracle(x, ul, a, b):
        dummy_sh = jnp.zeros((x.shape[0], 1), x.dtype)
        return jff.heads_apply(jff.encode_oracle(x, ul), dummy_sh,
                               {"ws0": a, "ws1": b, "wc0": None, "wc1": None,
                                "wc2": None}, sigma_only=True)

    ref = jax.jit(lambda g, *a: jax.vjp(oracle, *a)[1](g))(
        _j(g), _j(x01), _j(ulines), _j(Ws["ws0"]), _j(Ws["ws1"]))
    got = _plain(x01, None, ulines, Ws, g, True)
    names = ("dx", "dul", "ws0", "ws1")
    _close_all(got, ref, names)
    pallas = jff._pallas_bwd_sigma(_j(x01), _j(ulines), _j(Ws["ws0"]),
                                   _j(Ws["ws1"]), _j(g), interpret=True,
                                   tile=TILE)
    _close_all(got, pallas, names)


def test_bwd_plain_full_width_matches_jax_pallas_kernel(rng):
    """The shipped config's widths: F 80, R_max 257 (ragged)."""
    x01, sh, ulines, Ws, g = _mats(rng, 300, r_max=257, feat=80)
    dx, dsh, dul, dWs = jff._pallas_bwd(
        _j(x01), _j(sh), _j(ulines), {k: _j(v) for k, v in Ws.items()},
        _j(g), sigma_only=False, interpret=True, tile=TILE)
    got = _plain(x01, sh, ulines, Ws, g, False)
    _close_all(got, [dx, dsh, dul] + [dWs[k] for k in K],
               ("dx", "dsh", "dul") + K)


def test_bwd_plain_clipped_points_zero_dx(rng):
    """Clipped points get zero position gradient, as from the JAX kernel,
    and still contribute to dulines."""
    x01, sh, ulines, Ws, g = _mats(rng, 256)
    x01[:64, 0] = -0.5
    x01[64:128, 1] = 1.5
    got = _plain(x01, sh, ulines, Ws, g, False)
    assert np.all(got[0][:64, 0] == 0.0)
    assert np.all(got[0][64:128, 1] == 0.0)
    dx, _, dul, _ = jff._pallas_bwd(
        _j(x01), _j(sh), _j(ulines), {k: _j(v) for k, v in Ws.items()},
        _j(g), sigma_only=False, interpret=True, tile=TILE)
    _close(got[0], dx, "dx", rtol=5e-2, atol_frac=8e-3)
    _close(got[2], dul, "dul")
    assert np.abs(got[2]).max() > 0.0


@pytest.mark.parametrize("sigma_only", [False, True])
def test_autograd_function_uses_the_plain_backward(rng, sigma_only):
    """On CPU tensors, the gradient through cp_field_fused is exactly
    field_bwd_plain's, for every differentiable operand."""
    x01, sh, ulines, Ws, g = _mats(rng, 200)
    t = torch.from_numpy
    keys = K[:2] if sigma_only else K
    x = t(x01).requires_grad_(True)
    s = None if sigma_only else t(sh).requires_grad_(True)
    ul = t(ulines).requires_grad_(True)
    W = {k: t(Ws[k]).requires_grad_(True) for k in keys}
    out = tff.cp_field_fused(x, s, ul, W, sigma_only=sigma_only)
    out.backward(t(g))
    ref = _plain(x01, sh, ulines, Ws, g, sigma_only)
    got = [x.grad] + ([] if sigma_only else [s.grad]) + [ul.grad] + [
        W[k].grad for k in keys]
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), b)


def test_autograd_skips_unneeded_cotangents(rng):
    """Only the operands that need a gradient get one (the wrapper may skip
    storing dx and dsh on the card)."""
    x01, sh, ulines, Ws, g = _mats(rng, 64)
    t = torch.from_numpy
    W = {k: t(v).requires_grad_(True) for k, v in Ws.items()}
    ul = t(ulines).requires_grad_(True)
    x, s = t(x01), t(sh)
    tff.cp_field_fused(x, s, ul, W).backward(t(g))
    assert x.grad is None and s.grad is None
    assert ul.grad is not None and all(W[k].grad is not None for k in K)


def _cp_pair(resolutions, rank, seed=0):
    jm = jcp.CPGridField(bound=2.0, resolutions=resolutions, rank=rank)
    params = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(seed), jnp.zeros((8, 3)),
        jnp.ones((8, 3)) / np.sqrt(3.0))["params"])
    tm = tcp.CPGridField(bound=2.0, resolutions=resolutions, rank=rank)
    convert.load_jax_params(tm, params)
    return jm, params, tm


@pytest.mark.parametrize("resolutions", [(5, 9, 17), (6, 11)])
@pytest.mark.parametrize("sigma_only", [False, True])
def test_cp_field_grads_match_flax(rng, resolutions, sigma_only):
    """Gradients of CPGridField to every lines_* (through upsample_lines's
    einsum when nested, the two-hot encode when not) and to ws0 … wc2,
    against jax.grad of the flax module, from the same weights."""
    jm, params, tm = _cp_pair(resolutions, 4)
    pts = rng.uniform(-2.2, 2.2, (16, 9, 3)).astype(np.float32)
    vd = rng.standard_normal((16, 1, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    cot = rng.standard_normal((16, 9, 4)).astype(np.float32)
    if sigma_only:
        cot[..., :3] = 0.0

    def loss(p):
        out = jm.apply({"params": p}, jnp.asarray(pts), jnp.asarray(vd),
                       sigma_only=sigma_only)
        return jnp.sum(out * cot)

    ref = jax.jit(jax.grad(loss))(params)
    out = tm(torch.from_numpy(pts), torch.from_numpy(vd),
             sigma_only=sigma_only)
    torch.sum(out * torch.from_numpy(cot)).backward()
    names = [f"lines_{l}" for l in range(len(resolutions))] + list(
        K[:2] if sigma_only else K)
    for name in names:
        g = getattr(tm, name).grad
        assert g is not None, name
        _close(g.numpy(), ref[name], name)
    if sigma_only:
        for name in K[2:]:
            grad = getattr(tm, name).grad
            assert grad is None or float(grad.abs().max()) == 0.0, name


@pytest.mark.parametrize("case", ["g_shape", "g_dtype", "g_device"])
def test_bwd_wrapper_refuses(rng, case):
    """The kernel's argument checks raise on a cotangent that
    csrc/field_fused_bwd.cu does not take."""
    x01, sh, ulines, Ws, g = _mats(rng, 64)
    x, s, ul, gt = (torch.from_numpy(a) for a in (x01, sh, ulines, g))
    W = {k: torch.from_numpy(v) for k, v in Ws.items()}
    if case == "g_shape":
        gt = gt[:, :3].contiguous()
    elif case == "g_dtype":
        gt = gt.double()
    else:
        gt = gt.to("meta")
    with pytest.raises(ValueError):
        tff.check_bwd_args(x, s, ul, W, gt, sigma_only=False)


def test_weight_shapes_are_the_dw_layout():
    """weight_shapes is both what check_field_args demands and the order
    and shapes of K4/K5's dW buffer (the σ-only one stops after ws1)."""
    full = tff.weight_shapes(80, sigma_only=False)
    assert list(full) == list(K) and full["ws0"] == (80, 64)
    assert sum(a * b for a, b in full.values()) == 80 * 64 + 7296
    assert list(tff.weight_shapes(80, sigma_only=True)) == ["ws0", "ws1"]


def _tiled(x01, sh, ulines, Ws, g, sigma_only, grid=tff.PLAIN_GRID):
    t = torch.from_numpy
    keys = K[:2] if sigma_only else K
    dx, dsh, dul, dWs = tff.field_bwd_tiled_plain(
        t(x01), None if sigma_only else t(sh), t(ulines),
        {k: t(Ws[k]) for k in keys}, t(g), sigma_only=sigma_only, grid=grid)
    out = [dx, dul] if sigma_only else [dx, dsh, dul]
    return [v.numpy() for v in out + [dWs[k] for k in keys]]


# (r_max, F, n, σ-only, clipped points): both widths of the mirror's
# feature chunks (F 16 one k-chunk, 80 five), ragged tiles of 128
TILED_CASES = [(17, 16, 300, False, False), (33, 80, 300, False, True),
               (33, 16, 256, True, False), (17, 80, 333, True, True)]


@pytest.mark.parametrize("r_max,feat,n,sigma_only,clipped", TILED_CASES)
def test_bwd_tiled_plain_matches_jax_pallas_kernel_and_oracle(
        rng, r_max, feat, n, sigma_only, clipped):
    """K4/K5's algorithm in plain PyTorch (per-tile dW and dense
    triangle-mask dlines, summed per block and in block order) against the
    JAX Pallas backward in interpret mode and jax.vjp of the oracle, at the
    tolerances of tests/test_field_bwd.py."""
    x01, sh, ulines, Ws, g = _mats(rng, n, r_max=r_max, feat=feat)
    if clipped:
        x01[:40, 0] = -0.5
        x01[40:80, 2] = 1.5
    if sigma_only:
        g[:, :3] = 0.0
    got = _tiled(x01, sh, ulines, Ws, g, sigma_only)
    if clipped:
        assert np.all(got[0][:40, 0] == 0.0)
        assert np.all(got[0][40:80, 2] == 0.0)
    if sigma_only:
        names = ("dx", "dul", "ws0", "ws1")
        pallas = jff._pallas_bwd_sigma(_j(x01), _j(ulines), _j(Ws["ws0"]),
                                       _j(Ws["ws1"]), _j(g), interpret=True,
                                       tile=TILE)

        def oracle(x, ul, a, b):
            dummy_sh = jnp.zeros((x.shape[0], 1), x.dtype)
            return jff.heads_apply(jff.encode_oracle(x, ul), dummy_sh,
                                   {"ws0": a, "ws1": b, "wc0": None,
                                    "wc1": None, "wc2": None},
                                   sigma_only=True)

        ref = jax.jit(lambda g, *a: jax.vjp(oracle, *a)[1](g))(
            _j(g), _j(x01), _j(ulines), _j(Ws["ws0"]), _j(Ws["ws1"]))
    else:
        names = ("dx", "dsh", "dul") + K
        dx, dsh, dul, dWs = jff._pallas_bwd(
            _j(x01), _j(sh), _j(ulines), {k: _j(v) for k, v in Ws.items()},
            _j(g), sigma_only=False, interpret=True, tile=TILE)
        pallas = [dx, dsh, dul] + [dWs[k] for k in K]
        _, vjp = jax.vjp(
            lambda x, s, ul, a, b, c, d, e: jff._oracle(
                x, s, ul, dict(zip(K, (a, b, c, d, e))), sigma_only=False),
            _j(x01), _j(sh), _j(ulines), *(_j(Ws[k]) for k in K))
        ref = vjp(_j(g))
    _close_all(got, pallas, names)
    _close_all(got, ref, names)


@pytest.mark.parametrize("sigma_only", [False, True])
def test_bwd_tiled_plain_is_bit_equal_over_two_calls(rng, sigma_only):
    """Its sums run in a fixed order: two calls give the same bits, and
    another grid sums the same terms (within f32 rounding)."""
    x01, sh, ulines, Ws, g = _mats(rng, 300, r_max=33, feat=16)
    a = _tiled(x01, sh, ulines, Ws, g, sigma_only)
    b = _tiled(x01, sh, ulines, Ws, g, sigma_only)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)
    one = _tiled(x01, sh, ulines, Ws, g, sigma_only, grid=1)
    for u, v in zip(a, one):
        np.testing.assert_allclose(u, v, rtol=1e-5,
                                   atol=1e-6 * np.abs(v).max())


def _ray_points(rng, n, samples, r_max):
    """[n, 3] points along rays of ``samples`` (prof_field_kernels's
    layout), off the grid nodes as _mats keeps its points."""
    from gbnerf_tpu_torch.tools.prof_field_kernels import points

    x01 = points("rays", n, samples, rng)
    u = x01 * (r_max - 1)
    return x01 + ((np.abs(u - np.round(u)) < 1e-3) * 2e-3).astype(np.float32)


@pytest.mark.parametrize("sigma_only", [False, True])
def test_bwd_tiled_plain_over_many_blocks_matches_jax(rng, sigma_only):
    """More tiles than PLAIN_GRID blocks take (1,100 points: each block sums
    two or three tiles), with points along rays, so that most lines rows
    (the kernels' 16-row units) are touched by some blocks and not others:
    against the JAX Pallas backward in interpret mode and jax.vjp of the
    oracle, and bit-equal over two calls."""
    n, r_max, feat = 1100, 33, 16
    x01, sh, ulines, Ws, g = _mats(rng, n, r_max=r_max, feat=feat)
    x01 = _ray_points(rng, n - n % 50, 50, r_max)
    x01 = np.concatenate([x01, x01[: n - len(x01)]])
    assert n > tff.PLAIN_GRID * tff.BWD_TILE
    if sigma_only:
        g[:, :3] = 0.0
    got = _tiled(x01, sh, ulines, Ws, g, sigma_only)
    for u, v in zip(got, _tiled(x01, sh, ulines, Ws, g, sigma_only)):
        np.testing.assert_array_equal(u, v)
    if sigma_only:
        names = ("dx", "dul", "ws0", "ws1")
        pallas = jff._pallas_bwd_sigma(_j(x01), _j(ulines), _j(Ws["ws0"]),
                                       _j(Ws["ws1"]), _j(g), interpret=True,
                                       tile=TILE)
    else:
        names = ("dx", "dsh", "dul") + K
        dx, dsh, dul, dWs = jff._pallas_bwd(
            _j(x01), _j(sh), _j(ulines), {k: _j(v) for k, v in Ws.items()},
            _j(g), sigma_only=False, interpret=True, tile=TILE)
        pallas = [dx, dsh, dul] + [dWs[k] for k in K]
    _close_all(got, pallas, names)
    # the rays leave some 16-row units of every block untouched: the
    # kernels write those for no block and skip them in the block sums
    i0 = np.floor(np.clip(x01, 0, 1) * (r_max - 1)).astype(int)
    touched = [{(a, r // 16) for t in range(b * tff.BWD_TILE, n,
                                            tff.PLAIN_GRID * tff.BWD_TILE)
                for p in range(t, min(n, t + tff.BWD_TILE))
                for a in range(3) for r in (i0[p, a], i0[p, a] + 1)}
               for b in range(tff.PLAIN_GRID)]
    units = 3 * ((r_max + 15) // 16)
    assert all(len(t) < units for t in touched)


@pytest.mark.cuda
@pytest.mark.parametrize("sigma_only,n", [(False, 131072), (False, 65536 - 29),
                                          (True, 65536)])
def test_kernel_bwd_is_deterministic_on_the_card(rng, sigma_only, n):
    """K4/K5 on the card: two calls on the same inputs give bit-equal dx,
    dsh, dlines and dW (every sum runs in an order fixed by the inputs),
    each within the tolerances above of field_bwd_plain. chip_smoke.py
    makes the same checks there at every check_field_bwd case."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K4/K5 are CUDA C++; no CPU mode)")
    dev = torch.device("cuda:0")
    x01, sh, ulines, Ws, g = _mats(rng, n, r_max=257, feat=80)
    keys = K[:2] if sigma_only else K
    args = [torch.from_numpy(a).to(dev) for a in (x01, sh, ulines)]
    W = {k: torch.from_numpy(Ws[k]).to(dev) for k in keys}
    gt = torch.from_numpy(g).to(dev)
    if sigma_only:
        args[1] = None
        gt[:, :3] = 0.0
    runs = [tff.field_fused_bwd(*args, W, gt, sigma_only=sigma_only)
            for _ in range(2)]
    flat = [[r[0], r[1], r[2]] + [r[3][k] for k in keys] for r in runs]
    for a, b in zip(*flat):
        assert (a is None and b is None) or torch.equal(a, b)
    ref = tff.field_bwd_plain(*args, W, gt, sigma_only=sigma_only)
    got = flat[0]
    names = ("dx", "dsh", "dul") + keys
    for name, a, b in zip(names, got, [ref[0], ref[1], ref[2]]
                          + [ref[3][k] for k in keys]):
        if b is not None:
            _close_all([a.cpu().numpy()], [b.cpu().numpy()], (name,))


@pytest.mark.cuda
@pytest.mark.parametrize("sigma_only,samples", [(False, 128), (True, 64)])
def test_kernel_bwd_along_rays_is_deterministic_on_the_card(rng, sigma_only,
                                                            samples):
    """K4/K5 at the training step's layout (points along rays, most of a
    block's lines units untouched): two calls bit-equal, and within the
    tolerances above of field_bwd_plain."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K4/K5 are CUDA C++; no CPU mode)")
    dev = torch.device("cuda:0")
    n = 1024 * samples
    _, sh, ulines, Ws, g = _mats(rng, n, r_max=257, feat=80)
    x01 = _ray_points(rng, n, samples, 257)
    keys = K[:2] if sigma_only else K
    x, s, ul = (torch.from_numpy(a).to(dev) for a in (x01, sh, ulines))
    W = {k: torch.from_numpy(Ws[k]).to(dev) for k in keys}
    gt = torch.from_numpy(g).to(dev)
    if sigma_only:
        s = None
        gt[:, :3] = 0.0
    runs = [tff.field_fused_bwd(x, s, ul, W, gt, sigma_only=sigma_only)
            for _ in range(2)]
    flat = [[r[0], r[1], r[2]] + [r[3][k] for k in keys] for r in runs]
    for a, b in zip(*flat):
        assert (a is None and b is None) or torch.equal(a, b)
    ref = tff.field_bwd_plain(x, s, ul, W, gt, sigma_only=sigma_only)
    for name, a, b in zip(("dx", "dsh", "dul") + keys, flat[0],
                          [ref[0], ref[1], ref[2]]
                          + [ref[3][k] for k in keys]):
        if b is not None:
            _close_all([a.cpu().numpy()], [b.cpu().numpy()], (name,))


@pytest.mark.cuda
@pytest.mark.parametrize("sigma_only,r_max,feat", [
    (False, 257, 80), (True, 257, 80), (False, 129, tff.MAX_FEAT),
    (False, 33, 16)])
def test_kernel_info_matches_the_wrapper(sigma_only, r_max, feat):
    """kernel_info's account of K4/K5 agrees with the layout the wrapper
    and the CPU mirror take: 128-point tiles of 8 warps, no cluster, one
    block an SM, no spills, the dW partial sums it keeps in shared memory
    no more than the dW it returns (all of it at the shipped F 80), the
    shared memory within the card's limit; the scratch buffer's row holds
    dlines, dW and one flag a 16-row unit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K4/K5 are CUDA C++; no CPU mode)")
    info = tff.kernel_info(backward=True, sigma_only=sigma_only, r_max=r_max,
                           feat=feat)
    assert set(info) == set(tff.BWD_INFO_KEYS)
    assert info["tile"] == tff.BWD_TILE and info["warps"] * 16 == info["tile"]
    assert info["cluster"] == 1 and info["blocks_per_sm"] == 1
    assert info["spill_bytes"] == 0
    n_dw = sum(a * b for a, b in tff.weight_shapes(
        feat, sigma_only=sigma_only).values())
    assert 0 < info["dw_smem_floats"]
    if feat == 80:
        assert info["dw_smem_floats"] >= n_dw
    props = torch.cuda.get_device_properties(0)
    assert info["smem_bytes"] <= props.shared_memory_per_block_optin
    grid, row = tff.bwd_grid(131072, r_max, feat, sigma_only)
    assert 1 <= grid <= props.multi_processor_count
    units = 3 * ((r_max + 15) // 16)
    assert row == 3 * r_max * feat + n_dw + (units + 3) // 4 * 4
