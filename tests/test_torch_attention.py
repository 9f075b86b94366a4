"""Port vs JAX: the self-attention of the diffusion models (ops/attention.py).

``_oracle`` against the JAX ``_oracle`` in f32 and bf16, ``self_attention``
forward and gradient against the JAX ``self_attention`` on each routing
branch (the autograd Function for long aligned self-attention; the plain
version for short, misaligned and cross attention; single-head [B, N, D]
callers; the wider query tile of D > 160), and the kernel wrapper's
refusals. K7 itself runs only on the card (chip_smoke.py holds it against
``attention_plain``); here the Function's CPU forward is the plain version,
and ``attention_tiled_plain`` — K7's algorithm in plain PyTorch: key tiles,
the base-2 online softmax, the key split and its log-sum-exp merge — is
held against the plain version and JAX's ``_oracle``.

Tolerances, with their reasons: f32, the same einsums and softmax summed in
another order: rtol 1e-5, atol 1e-6·max|ref|, forward and gradient. bf16
inputs: the operands are exact in f32 on both sides and p is rounded to
bf16 once, which a one-ulp difference in f32 can flip: atol 2^-8·max|ref|
(one bf16 ulp of the largest output). The tiled form rounds the
unnormalised p of each tile (relative to the running max) where the plain
version rounds the normalised p; each output term moves by a bf16 rounding
(2^-8 relative): atol 1e-2·max|ref|, the card's tolerance for K7
(chip_smoke.py ATTN_ATOL_FRAC).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gbnerf_tpu.ops import attention as jat
from gbnerf_tpu_torch.ops import attention as tat

torch.set_num_threads(1)


def _close(got, ref, rtol=1e-5, atol_frac=1e-6):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(
        got.detach().float().numpy(), ref, rtol=rtol,
        atol=atol_frac * max(float(np.abs(ref).max()), 1e-30))


def _qkv(rng, q_shape, k_len=None):
    k_shape = q_shape[:-2] + (k_len or q_shape[-2], q_shape[-1])
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in (q_shape, k_shape, k_shape))


def test_oracle_matches_jax_f32_and_bf16(rng):
    q, k, v = _qkv(rng, (3, 70, 16))
    _close(tat._oracle(*map(torch.from_numpy, (q, k, v)), 0.25),
           jat._oracle(q, k, v, 0.25))
    qb, kb, vb = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    tb = [torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        torch.bfloat16) for x in (qb, kb, vb)]
    got = tat._oracle(*tb, 0.25)
    assert got.dtype == torch.bfloat16
    _close(got, jat._oracle(qb, kb, vb, 0.25).astype(jnp.float32),
           rtol=0.0, atol_frac=2.0 ** -8)
    # attention_plain is the oracle of the bf16-rounded, pre-scaled operands
    ref = jat._oracle((qb * jnp.asarray(0.25, jnp.bfloat16)), kb, vb, 1.0)
    _close(tat.attention_plain(*tb, 0.25), ref.astype(jnp.float32),
           rtol=0.0, atol_frac=2.0 ** -8)


# (q shape, k length, the branch the JAX routing takes)
CASES = {
    "function": ((1, 2, 1024, 16), None, True),
    "short": ((2, 2, 512, 16), None, False),
    "misaligned": ((1, 2, 1100, 16), None, False),
    "cross": ((1, 2, 1024, 16), 77, False),
    "single_head": ((1, 1024, 32), None, True),
    "wide_head": ((1, 1, 1152, 192), None, True),       # tq = 128 for D > 160
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_self_attention_routing_forward_and_grad_match_jax(rng, monkeypatch,
                                                           case):
    q_shape, k_len, via_function = CASES[case]
    q, k, v = _qkv(rng, q_shape, k_len)
    g = rng.standard_normal(q.shape).astype(np.float32)
    scale = q_shape[-1] ** -0.5

    def jloss(q, k, v):
        out = jat.self_attention(q, k, v, scale=scale)
        return jnp.sum(out * g), out

    (_, ref), jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                              has_aux=True))(q, k, v)
    calls = []
    real = tat._Attend.apply
    monkeypatch.setattr(tat._Attend, "apply",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = tat.self_attention(tq, tk, tv, scale=scale)
    torch.sum(out * torch.from_numpy(g)).backward()
    assert out.shape == q.shape
    assert bool(calls) == via_function, calls
    _close(out, ref)
    for got, r in zip((tq.grad, tk.grad, tv.grad), jg):
        _close(got, r)


def test_function_backward_relinearises_the_unscaled_oracle(rng):
    """The Function's backward is the VJP of _oracle(q, k, v, scale) (not of
    the forward's pre-scaled form), as _attend_bwd; in bf16 the two differ."""
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
               for x in _qkv(rng, (2, 1024, 8)))
    g = torch.from_numpy(rng.standard_normal((2, 1024, 8)).astype(
        np.float32)).to(torch.bfloat16)
    torch.sum(tat._Attend.apply(q, k, v, 0.3).float() * g.float()).backward()
    qq, kk, vv = (x.detach().requires_grad_(True) for x in (q, k, v))
    ref = torch.autograd.grad(tat._oracle(qq, kk, vv, 0.3), (qq, kk, vv), g)
    for got, r in zip((q.grad, k.grad, v.grad), ref):
        assert torch.equal(got, r)


def test_kernel_wrapper_refuses(rng):
    q, k, v = (torch.from_numpy(x) for x in _qkv(rng, (2, 64, 40)))
    with pytest.raises(ValueError, match="no kernel"):
        tat.flash_fwd(q, k, v, 0.1)
    bad = [((2, 64, 20),) * 3, ((2, 64, 40), (2, 60, 40), (2, 60, 40)),
           ((2, 64, 520),) * 3, ((2, 64, 40),) * 2 + ((1, 64, 40),)]
    for shapes in bad:
        with pytest.raises(ValueError):
            tat.check_attention_args(*(torch.zeros(s) for s in shapes))
    with pytest.raises(ValueError, match="floating"):
        tat.check_attention_args(q.to(torch.int32), k, v)
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        tat.check_attention_args(q.to(dtype), k, v)
    assert tat.LAUNCHES == {"attention": 0, "attention_kernels": 0}


# (BH, N, D, keys a tile, key ranges asked, q dtype): ragged N, splits
# whose ranges differ in length, more ranges asked than there are tiles,
# other tile sizes, and an f16 q (the wrapper scales it in f16 and passes
# it as f32); a tile of None is the kernel's own (key_tile: 64 keys up to
# D 16 and 128 up to D 128, the wgmma design's; 32 above): D 40 and 80
# past a tile, key splits, an f32 q, an odd D/8 (q·kᵀ padded to
# 16·⌈D/16⌉) and D 128
TILED = {
    "d40_kernel_tile_ragged": (2, 300, 40, None, 1, torch.bfloat16),
    "d80_kernel_tile_ragged_split2": (2, 300, 80, None, 2, torch.bfloat16),
    "d40_kernel_tile_split3_f32q": (1, 700, 40, None, 3, torch.float32),
    "d32_kernel_tile_f16q": (2, 257, 32, None, 1, torch.float16),
    "d72_kernel_tile_ragged": (2, 200, 72, None, 1, torch.bfloat16),
    "d128_kernel_tile_split2_f32q": (1, 300, 128, None, 2, torch.float32),
    "d16_kernel_tile_split_past_tiles": (3, 129, 16, None, 4,
                                         torch.bfloat16),
    "d40_ragged": (2, 300, 40, 64, 1, torch.bfloat16),
    "d40_split2": (2, 300, 40, 64, 2, torch.bfloat16),
    "d40_split_past_tiles": (1, 100, 40, 64, 5, torch.bfloat16),
    "d40_f16q": (2, 300, 40, 64, 1, torch.float16),
    "d8_ragged_f32q": (2, 77, 8, 64, 1, torch.float32),
    "d80_ragged_split2": (2, 300, 80, 128, 2, torch.bfloat16),
    "d64_split3_f32q": (1, 257, 64, 32, 3, torch.float32),
    "d16_split4_f32q": (3, 1000, 16, 64, 4, torch.float32),
    "wide_ragged_split2": (1, 200, 136, 32, 2, torch.bfloat16),
    "d512_ragged_split2": (1, 200, 512, 32, 2, torch.bfloat16),
}


@pytest.mark.parametrize("case", sorted(TILED))
def test_tiled_plain_matches_plain_and_jax_oracle(rng, case):
    bh, n, d, bk, split, dtype = TILED[case]
    q, k, v = (torch.from_numpy(x) for x in _qkv(rng, (bh, n, d)))
    q = (q * 3).to(dtype)              # a peaked softmax, as on the card
    k, v = k.to(dtype), v.to(dtype)
    scale = d ** -0.5
    got = tat.attention_tiled_plain(q, k, v, scale, block_k=bk, split=split)
    assert got.dtype == dtype and got.shape == q.shape
    ref = tat.attention_plain(q, k, v, scale)
    _close(got.float(), ref.float().numpy(), rtol=0.0, atol_frac=1e-2)
    bf = jnp.bfloat16
    jq, jk, jv = (jnp.asarray(x.float().numpy()) for x in (q, k, v))
    jref = jat._oracle((jq * jnp.asarray(scale, jq.dtype)).astype(bf),
                       jk.astype(bf), jv.astype(bf), 1.0)
    _close(got.float(), np.asarray(jref.astype(jnp.float32)), rtol=0.0,
           atol_frac=1e-2)


@pytest.mark.parametrize("d, tile", [
    (8, 64), (16, 64), (24, 128), (40, 128), (80, 128), (72, 128),
    (128, 128), (136, 32), (264, 32), (512, 32)])
def test_key_tile_is_the_tiled_plain_default(d, tile):
    """The kernel's keys a tile (64 up to D 16, 128 up to D 128, the wgmma
    design's; 32 above: chip_smoke.py holds key_tile to the kernel's
    library on the card) is the tiled plain version's default tile."""
    assert tat.key_tile(d) == tile
    q = torch.zeros((1, 2 * tile + 3, d))
    assert torch.equal(tat.attention_tiled_plain(q, q, q, 1.0),
                       tat.attention_tiled_plain(q, q, q, 1.0, block_k=tile))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 16, 40, 48, 80, 128, 136, 512])
def test_kernel_info_matches_the_wrapper(d):
    """The kernel's library reports the key tile that key_tile gives and
    the padded depth and width of its products."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the info comes from the CUDA "
                    "library)")
    info = tat.kernel_info(d)
    assert info["key_tile"] == tat.key_tile(d)
    pad = (-(-d // 16) * 16 if d <= 128 else 256 if d <= 256
           else 384 if d <= 384 else 512)
    assert (info["qk_depth"], info["pv_width"]) == (
        (pad, d) if d <= 128 else (pad, pad))
    assert info["blocks_per_sm"] >= 1 and info["spill_bytes"] == 0


def test_tiled_plain_without_split_is_the_online_softmax(rng):
    """One key range and one tile is the plain softmax with p rounded
    unnormalised: equal to the plain version to one bf16 step."""
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in _qkv(rng, (2, 48, 16)))
    got = tat.attention_tiled_plain(q, k, v, 0.25, block_k=64)
    _close(got.float(), tat.attention_plain(q, k, v, 0.25).float().numpy(),
           rtol=0.0, atol_frac=2.0 ** -7)


MAIN_SHAPES = ((16, 4096, 40), (16, 1024, 80), (1, 4096, 512))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(MAIN_SHAPES) + [
    (3, 4000, 40), (1, 4000, 512), (2, 77, 512)])
def test_kernel_plan_is_valid(shape):
    """kernel_plan's (wm, split), from the kernel's library and the card's
    SM count: blocks of at most 16 16-row groups up to D 128 (256 rows,
    the wgmma design's tile up to D 16) and at most 4 above (two warps a
    group, 256 threads), a split cut to the key tiles there are, and
    at the stage-2 path's shapes a grid of at least 90 % of the card's
    SMs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the plan comes from the CUDA "
                    "library)")
    dev = torch.device("cuda:0")
    bh, n, d = shape
    wm, split = tat.kernel_plan(bh, n, d, dev)
    assert 1 <= wm <= (16 if d <= 128 else 4) and split >= 1
    if d <= 128:        # two consumer warpgroups, or the most D allows
        assert wm in (8, 16 if d <= 16 else 12 if d <= 48 else 8)
    assert tat.kernel_plan(bh, n, d, dev, plan=tat.Plan(wm, 0)) == (wm, split)
    assert tat.kernel_plan(bh, n, d, dev, plan=tat.Plan(wm, n)).split \
        <= -(-n // 32)
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = -(-n // (16 * wm)) * split * bh
    if shape in MAIN_SHAPES:
        assert blocks >= 0.9 * sm, (shape, wm, split, blocks)
    with pytest.raises(ValueError, match="no launch plan"):
        tat.kernel_plan(bh, n, d, dev, plan=tat.Plan(9, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(TILED))
def test_kernel_matches_plain_on_the_card(rng, case):
    """K7 on the card against attention_plain, q in bf16, f32 (the folded
    scale and the output in q's dtype) and f16, with the plan forced to
    the case's split; one launch per call, plus the merge of a split.
    chip_smoke.py makes the same checks at the stage-2 shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K7 is CUDA C++; no CPU mode)")
    bh, n, d, _, split, dtype = TILED[case]
    dev = torch.device("cuda:0")
    q, k, v = (torch.from_numpy(x).to(dev) for x in _qkv(rng, (bh, n, d)))
    q = (q * 3).to(dtype)
    k, v = k.to(dtype), v.to(dtype)
    before = dict(tat.LAUNCHES)
    plan = tat.Plan(0, split)
    got = tat.flash_fwd(q, k, v, d ** -0.5, plan=plan)
    run = tat.kernel_plan(bh, n, d, dev, plan=plan).split
    assert tat.LAUNCHES["attention"] == before["attention"] + 1
    assert tat.LAUNCHES["attention_kernels"] == (
        before["attention_kernels"] + (2 if run > 1 else 1))
    assert got.dtype == dtype
    ref = tat.attention_plain(q, k, v, d ** -0.5)
    _close(got.float().cpu(), ref.float().cpu().numpy(), rtol=1e-2,
           atol_frac=1e-2)
