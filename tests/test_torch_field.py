"""Port vs JAX: the fused CP field (K1/K2's plain version), the CP field
module, the NeRF MLP, field construction and the weight converter.

The plain version of K1/K2 is held against both the JAX Pallas kernels
(``_pallas_fwd``/``_pallas_fwd_sigma`` in interpret mode on the CPU) and
the JAX ``_oracle``. Every matmul operand on both sides is rounded to
bf16 and accumulated in f32, but the sums run in another order, which can
flip a bf16 rounding of a hidden activation: hence the tolerances of
tests/test_field_bwd.py::_close (rtol 3e-2, atol 5e-3 · max |ref|).
Points are kept off grid nodes and the clip boundary, as there.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import gbnerf_tpu.ops.field_fused as jff
from gbnerf_tpu.config import Config, FieldConfig
from gbnerf_tpu.core import cp_field as jcp
from gbnerf_tpu.core.fields import NeRFMLP as JNeRFMLP
from gbnerf_tpu.ops import cp_pallas as jcpp
from gbnerf_tpu.train.state import build_field as j_build_field
from gbnerf_tpu_torch import convert
from gbnerf_tpu_torch.core import cp_field as tcp
from gbnerf_tpu_torch.core.fields import HashGridField as THashGridField
from gbnerf_tpu_torch.core.fields import NeRFMLP as TNeRFMLP
from gbnerf_tpu_torch.ops import cp_pallas as tcpp
from gbnerf_tpu_torch.ops import field_fused as tff
from gbnerf_tpu_torch.train.state import build_field, create_params

torch.set_num_threads(1)


def _mats(rng, n, r_max, feat):
    x01 = (0.03 + 0.94 * rng.random((n, 3))).astype(np.float32)
    u = x01 * (r_max - 1)
    x01 += ((np.abs(u - np.round(u)) < 1e-3) * 2e-3).astype(np.float32)
    sh = rng.standard_normal((n, 16)).astype(np.float32) * 0.5
    ulines = rng.standard_normal((3, r_max, feat)).astype(np.float32) * 0.5
    Ws = {
        "ws0": rng.standard_normal((feat, 64)).astype(np.float32) * 0.2,
        "ws1": rng.standard_normal((64, 16)).astype(np.float32) * 0.2,
        "wc0": rng.standard_normal((31, 64)).astype(np.float32) * 0.2,
        "wc1": rng.standard_normal((64, 64)).astype(np.float32) * 0.2,
        "wc2": rng.standard_normal((64, 3)).astype(np.float32) * 0.2,
    }
    return x01, sh, ulines, Ws


def _close(a, b, name, rtol=3e-2, atol_frac=5e-3):
    a, b = np.asarray(a), np.asarray(b)
    atol = atol_frac * max(np.abs(b).max(), 1e-3)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=name)


def _port(x01, sh, ulines, Ws, sigma_only):
    t = lambda a: torch.from_numpy(a)   # noqa: E731
    return tff.cp_field_fused(t(x01), None if sigma_only else t(sh),
                              t(ulines), {k: t(v) for k, v in Ws.items()},
                              sigma_only=sigma_only).numpy()


SHAPES = [(33, 16, 256), (33, 16, 300), (257, 80, 300)]


@pytest.mark.parametrize("sigma_only", [False, True])
@pytest.mark.parametrize("r_max,feat,n", SHAPES)
def test_field_plain_matches_jax_pallas_kernel(rng, monkeypatch, r_max, feat,
                                               n, sigma_only):
    x01, sh, ulines, Ws = _mats(rng, n, r_max, feat)
    monkeypatch.setattr(jff, "INTERPRET", True)
    monkeypatch.setattr(jff, "TILE", 256)
    jW = {k: jnp.asarray(v) for k, v in Ws.items()}
    if sigma_only:
        ref = jff._pallas_fwd_sigma(jnp.asarray(x01), jnp.asarray(ulines),
                                    jW["ws0"], jW["ws1"])
    else:
        ref = jff._pallas_fwd(jnp.asarray(x01), jnp.asarray(sh),
                              jnp.asarray(ulines), jW, sigma_only=False)
    got = _port(x01, sh, ulines, Ws, sigma_only)
    assert got.shape == (n, 4)
    _close(got, ref, "raw")
    if sigma_only:
        assert np.all(got[:, :3] == 0.0)


@pytest.mark.parametrize("sigma_only", [False, True])
@pytest.mark.parametrize("r_max,feat,n", SHAPES)
def test_field_plain_matches_jax_oracle(rng, r_max, feat, n, sigma_only):
    x01, sh, ulines, Ws = _mats(rng, n, r_max, feat)
    ref = jff._oracle(jnp.asarray(x01), jnp.asarray(sh), jnp.asarray(ulines),
                      {k: jnp.asarray(v) for k, v in Ws.items()},
                      sigma_only=sigma_only)
    _close(_port(x01, sh, ulines, Ws, sigma_only), ref, "raw")


def test_encode_oracle_matches_jax(rng):
    """Two nonzero taps per axis, products of bf16 values exact in f32: the
    encode agrees to the last bit whatever the order of the sum."""
    x01, _, ulines, _ = _mats(rng, 300, 257, 80)
    got = tcpp.encode_plain(torch.from_numpy(x01), torch.from_numpy(ulines),
                             ulines.shape[1])
    ref = jff.encode_oracle(jnp.asarray(x01), jnp.asarray(ulines))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_encode_oracle_clipped_points_match_jax(rng):
    """Points outside [0, 1]³ clip to the grid's ends (x = 1.0 reaches the
    last node, where the kernel clamps its first tap)."""
    _, _, ulines, _ = _mats(rng, 8, 33, 16)
    x01 = np.array([[-0.5, 1.0, 1.5], [0.0, 2.0, -1.0], [1.0, 1.0, 1.0],
                    [0.5, 0.0, 1.0]], np.float32)
    got = tcpp.encode_plain(torch.from_numpy(x01), torch.from_numpy(ulines),
                             ulines.shape[1])
    ref = jff.encode_oracle(jnp.asarray(x01), jnp.asarray(ulines))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_heads_apply_matches_jax(rng):
    _, sh, _, Ws = _mats(rng, 200, 33, 16)
    enc = rng.standard_normal((200, 16)).astype(np.float32) * 0.3
    got = tff.heads_apply(torch.from_numpy(enc), torch.from_numpy(sh),
                          {k: torch.from_numpy(v) for k, v in Ws.items()})
    ref = jff.heads_apply(jnp.asarray(enc), jnp.asarray(sh),
                          {k: jnp.asarray(v) for k, v in Ws.items()})
    _close(got.numpy(), ref, "raw")


@pytest.mark.parametrize("feat", [24, 80])
def test_pack_weights_layout(rng, feat):
    """The kernels' bf16 weight buffer: unpack(pack(W)) == bf16(W), each
    weight where csrc/field_tile.cuh::weight_layout puts it (ws0's rows in
    each k-chunk's feature order), every padding entry (wc0's row 16
    included) zero."""
    _, _, _, Ws = _mats(rng, 4, 33, feat)
    W = {k: torch.from_numpy(v) for k, v in Ws.items()}
    b = lambda t: t.to(torch.bfloat16).float()   # noqa: E731
    for sigma_only in (False, True):
        buf = tff.pack_weights(W, sigma_only=sigma_only)
        lay = tff.weight_layout(feat, sigma_only=sigma_only)
        fp = -(-feat // 16) * 16
        assert buf.dtype == torch.bfloat16 and buf.numel() == lay["total"]
        assert lay["total"] == fp * 72 + 64 * 24 + (
            0 if sigma_only else 32 * 72 + 64 * 72 + 64 * 8)
        assert lay["total"] % 8 == 0       # 16-byte copies
        got = tff.unpack_weights(buf, feat, sigma_only=sigma_only)
        assert list(got) == list(tff.weight_shapes(feat,
                                                   sigma_only=sigma_only))
        for k, v in got.items():
            np.testing.assert_array_equal(v.numpy(), b(W[k]).numpy())
        # the padding: zero everywhere the weights are not
        mask = torch.zeros(lay["total"], dtype=torch.bool)
        for k, (a, c) in tff.weight_shapes(feat,
                                           sigma_only=sigma_only).items():
            off, rows, stride = lay[k]
            view = mask[off:off + rows * stride].view(rows, stride)
            if k == "wc0":
                view[:16, :c] = True
                view[17:, :c] = True
            elif k == "ws0":
                view[:, :c] = tff._chunk_order(
                    (torch.arange(view.shape[0]) < a)[:, None]).expand(-1, c)
            else:
                view[:a, :c] = True
        assert bool((buf.float()[~mask] == 0).all())
    # a lane's four A entries of a k-chunk (positions 2t, 2t+1, 2t+8, 2t+9)
    # are features 4t … 4t + 3
    at = tff._chunk_order(torch.arange(32))        # the feature at a row
    for t in range(4):
        for c in (0, 16):
            assert [int(at[c + r]) for r in (2 * t, 2 * t + 1, 2 * t + 8,
                                             2 * t + 9)] == [
                c + 4 * t + q for q in range(4)]
    assert torch.equal(tff._chunk_order(at, inverse=True), torch.arange(32))


def _pack_elementwise(Ws, *, sigma_only):
    """The element-wise pack that ``pack_weights`` replaced (a zeroed
    buffer, each weight cast and written into its slices): the reference
    the gathered buffer must equal bit for bit."""
    feat = Ws["ws0"].shape[0]
    lay = tff.weight_layout(feat, sigma_only=sigma_only)
    buf = torch.zeros(lay["total"], dtype=torch.bfloat16)
    for k in tff.W_KEYS[:2 if sigma_only else 5]:
        off, rows, stride = lay[k]
        view = buf[off:off + rows * stride].view(rows, stride)
        w = Ws[k].detach().to(torch.bfloat16)
        if k == "wc0":
            view[:16, :64] = w[:16]
            view[17:, :64] = w[16:]
        elif k == "ws0":
            view[:, :64] = tff._chunk_order(
                torch.nn.functional.pad(w, (0, 0, 0, rows - feat)))
        else:
            view[:w.shape[0], :w.shape[1]] = w
    return buf


@pytest.mark.parametrize("sigma_only", [False, True])
@pytest.mark.parametrize("feat", [16, 24, 80, 160])
def test_pack_weights_gather_equals_the_elementwise_pack(rng, feat,
                                                         sigma_only):
    """pack_weights' one gather from the cached index map gives the
    element-wise pack's buffer bit for bit (every padding entry a +0), on
    a second call from the cache too, and a weight's update shows in it."""
    _, _, _, Ws = _mats(rng, 4, 33, feat)
    W = {k: torch.from_numpy(v) for k, v in Ws.items()}
    if sigma_only:
        W = {k: W[k] for k in ("ws0", "ws1")}
    bits = lambda t: t.view(torch.int16)          # noqa: E731
    for _ in range(2):
        got = tff.pack_weights(W, sigma_only=sigma_only)
        assert got.dtype == torch.bfloat16
        assert torch.equal(bits(got),
                           bits(_pack_elementwise(W, sigma_only=sigma_only)))
    W["ws1"] = W["ws1"] + 1.0
    assert torch.equal(bits(tff.pack_weights(W, sigma_only=sigma_only)),
                       bits(_pack_elementwise(W, sigma_only=sigma_only)))


@pytest.mark.parametrize("sigma_only", [False, True])
@pytest.mark.parametrize("r_max,feat,n", [(17, 16, 300), (33, 80, 300),
                                          (257, 80, 300)])
def test_field_tiled_plain_matches_jax(rng, monkeypatch, r_max, feat, n,
                                       sigma_only):
    """K1/K2's algorithm in plain PyTorch (the 2-tap encode, the packed
    colour input) against the JAX Pallas kernels in interpret mode and the
    JAX oracle; and against the port's plain version, which rounds at the
    same places."""
    x01, sh, ulines, Ws = _mats(rng, n, r_max, feat)
    monkeypatch.setattr(jff, "INTERPRET", True)
    monkeypatch.setattr(jff, "TILE", 256)
    jW = {k: jnp.asarray(v) for k, v in Ws.items()}
    if sigma_only:
        ref = jff._pallas_fwd_sigma(jnp.asarray(x01), jnp.asarray(ulines),
                                    jW["ws0"], jW["ws1"])
    else:
        ref = jff._pallas_fwd(jnp.asarray(x01), jnp.asarray(sh),
                              jnp.asarray(ulines), jW, sigma_only=False)
    oracle = jff._oracle(jnp.asarray(x01), jnp.asarray(sh),
                         jnp.asarray(ulines), jW, sigma_only=sigma_only)
    t = torch.from_numpy
    args = (t(x01), None if sigma_only else t(sh), t(ulines),
            {k: t(v) for k, v in Ws.items()})
    got = tff.field_tiled_plain(*args, sigma_only=sigma_only).numpy()
    assert got.shape == (n, 4)
    _close(got, ref, "raw vs pallas")
    _close(got, oracle, "raw vs oracle")
    _close(got, tff.field_plain(*args, sigma_only=sigma_only).numpy(),
           "raw vs plain")
    if sigma_only:
        assert np.all(got[:, :3] == 0.0)


@pytest.mark.parametrize("case", ["meta_device", "feat_not_4", "x_strided",
                                  "ws0_shape", "sh_missing", "bad_cotangent",
                                  "feat_too_wide"])
def test_field_wrapper_refuses(rng, case):
    """Only a CPU tensor takes the plain version; the kernels' argument
    checks raise on what csrc/field_fused.cu and field_fused_bwd.cu do not
    take (a gradient is no longer refused: K4/K5 compute it)."""
    x01, sh, ulines, Ws = _mats(rng, 64, 33, 16)
    x, s, ul = (torch.from_numpy(a) for a in (x01, sh, ulines))
    W = {k: torch.from_numpy(v) for k, v in Ws.items()}
    kw = {"sigma_only": False}
    if case == "meta_device":
        with pytest.raises(ValueError):
            tff.cp_field_fused(x.to("meta"), s.to("meta"), ul.to("meta"),
                               {k: v.to("meta") for k, v in W.items()})
        return
    if case == "feat_not_4":
        ul = ul[..., :14]
        W["ws0"] = W["ws0"][:14]
    elif case == "x_strided":
        x = torch.from_numpy(np.ascontiguousarray(x01.T)).t()
    elif case == "ws0_shape":
        W["ws0"] = W["ws0"][:, :32]
    elif case == "sh_missing":
        s = None
    elif case == "feat_too_wide":    # past the kernels' shared memory
        ul = torch.zeros(3, 33, tff.MAX_FEAT + 4)
        W["ws0"] = torch.zeros(tff.MAX_FEAT + 4, 64)
    if case == "bad_cotangent":
        W["ws1"].requires_grad_(True)
        with pytest.raises(ValueError):
            tff.check_bwd_args(x, s, ul, W, torch.zeros(64, 3), **kw)
        tff.check_field_args(x, s, ul, W, **kw)   # a gradient is fine
        return
    with pytest.raises(ValueError):
        tff.check_field_args(x, s, ul, W, **kw)


def test_upsample_lines_and_check_nested_match_jax(rng):
    lines = [rng.standard_normal((3, R, 4)).astype(np.float32)
             for R in (5, 9, 17)]
    got = tcpp.upsample_lines([torch.from_numpy(l) for l in lines], 17)
    ref = jcpp.upsample_lines([jnp.asarray(l) for l in lines], 17)
    assert got.shape == (3, 17, 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-7)
    assert tcpp.check_nested((17, 33, 65)) == 65
    with pytest.raises(ValueError):
        tcpp.check_nested((16, 33))


def test_twohot_cp_encode_matches_jax(rng):
    x01 = rng.random((100, 3)).astype(np.float32)
    lines = [rng.standard_normal((3, R, 4)).astype(np.float32)
             for R in (7, 12)]
    got = tcp.cp_encode(torch.from_numpy(x01),
                        [torch.from_numpy(l) for l in lines])
    ref = jcp.cp_encode(jnp.asarray(x01), [jnp.asarray(l) for l in lines])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-7)


def _cp_pair(resolutions, rank, seed=0):
    jm = jcp.CPGridField(bound=2.0, resolutions=resolutions, rank=rank)
    pts = jnp.zeros((8, 3))
    dirs = jnp.ones((8, 3)) / np.sqrt(3.0)
    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(seed), pts, dirs)["params"])
    tm = tcp.CPGridField(bound=2.0, resolutions=resolutions, rank=rank)
    convert.load_jax_params(tm, params)
    return jm, params, tm


@pytest.mark.parametrize("resolutions", [(5, 9, 17), (6, 11)])
@pytest.mark.parametrize("sigma_only", [False, True])
def test_cp_field_module_matches_flax(rng, resolutions, sigma_only):
    """Nested resolutions go through the fused call, non-nested ones
    through the per-level two-hot encode."""
    jm, params, tm = _cp_pair(resolutions, 4)
    pts = rng.uniform(-2.2, 2.2, (12, 9, 3)).astype(np.float32)
    vd = rng.standard_normal((12, 1, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    ref = jm.apply({"params": params}, jnp.asarray(pts), jnp.asarray(vd),
                   sigma_only=sigma_only)
    with torch.no_grad():
        got = tm(torch.from_numpy(pts), torch.from_numpy(vd),
                 sigma_only=sigma_only)
    assert got.shape == (12, 9, 4)
    _close(got.numpy(), ref, "raw")


@pytest.mark.parametrize("use_viewdirs", [True, False])
def test_nerf_mlp_matches_flax(rng, use_viewdirs):
    kw = dict(depth=3, width=32, skips=(1,), multires=4, multires_views=2,
              use_viewdirs=use_viewdirs)
    jm = JNeRFMLP(**kw)
    pts = rng.standard_normal((10, 5, 3)).astype(np.float32)
    vd = rng.standard_normal((10, 1, 3)).astype(np.float32)
    params = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(1), jnp.asarray(pts), jnp.asarray(vd))["params"])
    tm = convert.load_jax_params(TNeRFMLP(**kw), params)
    ref = jm.apply({"params": params}, jnp.asarray(pts), jnp.asarray(vd))
    with torch.no_grad():
        got = tm(torch.from_numpy(pts), torch.from_numpy(vd))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)


def _flat_shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_shapes(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = tuple(np.shape(v))
    return out


@pytest.mark.parametrize("field", ["cp", "cp_proposal", "mlp"])
def test_params_round_trip_and_match_flax_layout(field):
    """create_params builds the fields the JAX package builds (same names
    and shapes), and params_from_jax ∘ params_to_jax is the identity."""
    fc = {"cp": FieldConfig(cp_resolutions=(5, 9, 17), cp_rank=4),
          "cp_proposal": FieldConfig(cp_resolutions=(5, 9, 17), cp_rank=4,
                                     cp_resolutions_coarse=(5, 9),
                                     cp_rank_coarse=2),
          "mlp": FieldConfig(no_tcnn=True, netdepth=3, netwidth=32,
                             netdepth_fine=2, netwidth_fine=16)}[field]
    cfg = Config(field=fc)
    pts, dirs = jnp.zeros((8, 3)), jnp.ones((8, 3)) / np.sqrt(3.0)
    jparams = {}
    for name, fine in (("coarse", False), ("fine", True)):
        jm = j_build_field(cfg, fine=fine)
        jparams[name] = jax.tree_util.tree_map(
            np.asarray, jm.init(jax.random.PRNGKey(int(fine)), pts,
                                dirs)["params"])
    coarse, fine = create_params(cfg, torch.Generator().manual_seed(0))
    sds = convert.params_from_jax(jparams)
    for name, mod in (("coarse", coarse), ("fine", fine)):
        own = mod.state_dict()
        assert set(own) == set(sds[name])
        for k, v in own.items():
            assert tuple(v.shape) == tuple(sds[name][k].shape), k
        mod.load_state_dict(sds[name])
    back = convert.params_to_jax({"coarse": coarse.state_dict(),
                                  "fine": fine.state_dict()})
    assert _flat_shapes(back) == _flat_shapes(jparams)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_array_equal(a, b)


def test_create_params_is_seeded_and_on_the_device():
    cfg = Config(field=FieldConfig(cp_resolutions=(5, 9, 17), cp_rank=4))
    c1, f1 = create_params(cfg, torch.Generator().manual_seed(3), "cpu")
    c2, _ = create_params(cfg, torch.Generator().manual_seed(3), "cpu")
    for (k, a), b in zip(c1.state_dict().items(), c2.state_dict().values()):
        assert torch.equal(a, b), k
        assert a.device.type == "cpu"
    assert not torch.equal(c1.ws0, f1.ws0)
    # the init scales of the flax module: lines ~ 0.5·N(0,1), lecun kernels
    assert 0.4 < float(c1.lines_2.detach().std()) < 0.6
    assert float(c1.wc1.detach().abs().max()) <= 2.0 / 0.8796 / 8.0 + 1e-6
    # field_type = hash: the same hash-grid architecture for both fields
    hcfg = cfg.replace(field=dataclasses.replace(
        cfg.field, field_type="hash", n_levels=2, log2_hashmap_size=6))
    hc = build_field(hcfg, generator=torch.Generator().manual_seed(3))
    hf = build_field(hcfg, fine=True, generator=torch.Generator().manual_seed(3))
    assert isinstance(hc, THashGridField) and hc.hash_table.shape == (2, 64, 2)
    assert all(torch.equal(a, b) for a, b in zip(hc.state_dict().values(),
                                                 hf.state_dict().values()))
    assert float(hc.hash_table.detach().abs().max()) <= 1e-4


@pytest.mark.parametrize("bound", [8.0, 3.0, 1.5])
def test_cp_positions_are_the_jax_fields_quotient(rng, bound):
    """positions() (the CP field's x01) on the CPU is the JAX package's
    f32 (pts + bound) / (2·bound), bit for bit."""
    pts = (rng.standard_normal((4096, 3)) * bound).astype(np.float32)
    ref = np.asarray((jnp.asarray(pts) + bound) / (2.0 * bound))
    got = tcp.positions(torch.from_numpy(pts), bound).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.cuda
def test_cp_positions_on_the_card_equal_the_cpus():
    """The CP field's x01 on the card is the CPU's bit for bit at the
    shipped bound (8: 2·bound a power of two) and at bounds where the
    reciprocal of 2·bound is inexact (3, 1.5): the divisor is a 0-d device
    tensor, not a Python scalar (which CUDA turns into a product with the
    reciprocal)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA's division by a scalar)")
    g = torch.Generator().manual_seed(0)
    pts = torch.randn(1 << 16, 3, generator=g) * 4
    for bound in (8.0, 3.0, 1.5):
        assert torch.equal(tcp.positions(pts.cuda(), bound).cpu(),
                           tcp.positions(pts, bound)), bound


@pytest.mark.cuda
@pytest.mark.parametrize("sigma_only", [False, True])
@pytest.mark.parametrize("r_max,feat,n", [(257, 80, 131072 - 29),
                                          (65, 24, 4099), (33, 16, 1000),
                                          (129, tff.MAX_FEAT, 3001)])
def test_kernel_fwd_matches_plain_on_the_card(rng, r_max, feat, n,
                                              sigma_only):
    """K1/K2 (warpgroup products, 64 points a warpgroup, a ragged last
    tile) against field_plain at the tolerances above, at the shipped
    width, the proposal field's (F 24: one k-chunk half past F), the
    narrowest and the widest; rgb exactly zero for K2."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K1/K2 are CUDA C++; no CPU mode)")
    dev = torch.device("cuda:0")
    x01, sh, ulines, Ws = _mats(rng, n, r_max, feat)
    x, s, ul = (torch.from_numpy(a).to(dev) for a in (x01, sh, ulines))
    W = {k: torch.from_numpy(v).to(dev) for k, v in Ws.items()}
    s = None if sigma_only else s
    with torch.no_grad():
        got = tff.cp_field_fused(x, s, ul, W, sigma_only=sigma_only)
        ref = tff.field_plain(x, s, ul, W, sigma_only=sigma_only)
    _close(got.cpu().numpy(), ref.cpu().numpy(), "raw")
    if sigma_only:
        assert bool((got[:, :3] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("sigma_only", [False, True])
def test_kernel_fwd_info_on_the_card(sigma_only):
    """kernel_info's account of K1/K2: 4 warpgroups of 64 points a block,
    one block an SM, no spills, the lines staged at the shipped shape
    (their 136 KB and the weights within the card's limit)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K1/K2 are CUDA C++; no CPU mode)")
    info = tff.kernel_info(backward=False, sigma_only=sigma_only, r_max=257,
                           feat=80)
    assert list(info) == list(tff.FWD_INFO_KEYS)
    assert info["warpgroups"] == 4 and info["tile"] == 64
    assert info["blocks_per_sm"] == 1 and info["spill_bytes"] == 0
    assert info["smem_bytes"] > 3 * 257 * 88 * 2
    props = torch.cuda.get_device_properties(0)
    assert info["smem_bytes"] <= props.shared_memory_per_block_optin
