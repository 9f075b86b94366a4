"""Port vs JAX: the self-attention of the diffusion models (ops/attention.py).

``_oracle`` against the JAX ``_oracle`` in f32 and bf16, ``self_attention``
forward and gradient against the JAX ``self_attention`` on each routing
branch (the autograd Function for long aligned self-attention; the plain
version for short, misaligned and cross attention; single-head [B, N, D]
callers; the wider query tile of D > 160), and the kernel wrapper's
refusals. K7 itself runs only on the card (chip_smoke.py holds it against
``attention_plain``); here the Function's CPU forward is the plain version.

Tolerances, with their reasons: f32, the same einsums and softmax summed in
another order: rtol 1e-5, atol 1e-6·max|ref|, forward and gradient. bf16
inputs: the operands are exact in f32 on both sides and p is rounded to
bf16 once, which a one-ulp difference in f32 can flip: atol 2^-8·max|ref|
(one bf16 ulp of the largest output).
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
    tat.check_attention_args(q, k, v)
    assert tat.LAUNCHES == {"attention": 0}
