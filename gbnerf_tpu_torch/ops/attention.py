"""Self-attention for the diffusion models, and its Hopper kernel (K7).

Port of gbnerf_tpu/ops/attention.py. ``self_attention`` takes q, k, v
[B, H, N, D] (or [B, N, D] for one head) and keeps the JAX package's
routing exactly: a sequence shorter than ``min_seq``, not a multiple of the
TPU kernel's query tile (128 if D > 160 else 256), or with a k length other
than q's (cross attention) takes the plain version on every device; every
other call goes through an autograd Function whose forward is

- on a CPU tensor the plain version, as the JAX package's non-TPU path
  (``_oracle`` of q·scale, in q's dtype);
- on a CUDA tensor csrc/attention.cu (K7), or an error. There is no
  fallback.

The backward re-linearises the plain version with ``torch.autograd``, as
the JAX package's custom VJP does: the UNet runs without gradient in score
distillation, and only the VAE encode (its mid-block attention) is
differentiated. There is no backward kernel on either side.

K7 computes what the TPU kernel computes: q·scale rounded to bf16, k and v
in bf16, scores and softmax in f32, p·v summed in f32, the output cast to
q's dtype. It rounds the unnormalised p of an online softmax where the TPU
rounds the normalised p (the source note says why): the two agree to bf16
level relative to max|out|.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from ._build import kernel_function

# Launches of K7 since the last reset (chip_smoke.py zeroes and reads it),
# and the same launches by (N, D), which tells the UNet's (D 40, 80) from
# the VAE's (D 512).
LAUNCHES = {"attention": 0}
LAUNCHES_BY_SHAPE: collections.Counter = collections.Counter()

MAX_HEAD_DIM = 512


def _scaled(q: torch.Tensor, scale: float) -> torch.Tensor:
    """q · scale with the scale rounded to q's dtype first, as
    ``q * jnp.asarray(scale, q.dtype)``."""
    return q * torch.tensor(scale, dtype=q.dtype, device=q.device)


def _oracle(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            scale: float) -> torch.Tensor:
    """Plain attention, [BH, N, D] → [BH, N, D] in q's dtype.

    The operands in their own dtype (bf16 on the card) multiplied in f32,
    softmax in f32, p cast to q's dtype before p·v: a bf16 @ bf16
    ``torch.matmul`` would round the sums once more (see
    ops/field_fused.py::_bf16). With bf16 inputs this is also K7's plain
    version: what _flash_fwd computes, unfused.
    """
    s = torch.einsum("bnd,bmd->bnm", q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bnm,bmd->bnd", p.float(), v.float()).to(q.dtype)


def attention_plain(q, k, v, scale: float) -> torch.Tensor:
    """The plain version of K7 on the kernel's operands: bf16 q·scale, k, v.
    The reference that chip_smoke.py holds the kernel against."""
    bf = torch.bfloat16
    out = _oracle(_scaled(q, scale).to(bf), k.to(bf), v.to(bf), 1.0)
    return out.to(q.dtype)


def check_attention_args(q, k, v) -> None:
    """Raise on anything csrc/attention.cu does not take."""
    if not (q.device == k.device == v.device):
        raise ValueError("attention: q, k, v lie on different devices")
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"attention: q, k, v must be [BH, N, D] of one "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    bh, n, d = q.shape
    if d % 8 or not 8 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"attention: the kernel reads rows in 16-byte "
                         f"chunks and takes D a multiple of 8 up to "
                         f"{MAX_HEAD_DIM}; D = {d}")
    if bh >= 1 << 16:
        raise ValueError(f"attention: {bh} batch·heads exceed the grid's "
                         "z dimension; split the call")
    if bh * n * d >= 1 << 31:
        raise ValueError("attention: too many elements for the kernel")


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float) -> torch.Tensor:
    """K7 on CUDA tensors: [BH, N, D] → [BH, N, D] in q's dtype."""
    if q.device.type != "cuda":
        raise ValueError(f"attention: no kernel for device {q.device}; the "
                         "CPU takes the plain version")
    check_attention_args(q, k, v)
    bf = torch.bfloat16
    qs = _scaled(q.detach(), scale).to(bf).contiguous()
    kb = k.detach().to(bf).contiguous()
    vb = v.detach().to(bf).contiguous()
    bh, n, d = q.shape
    out = torch.empty((bh, n, d), dtype=torch.float32, device=q.device)
    fn = kernel_function("gbnerf_attention_fwd", [ctypes.c_void_p] * 4
                         + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    with torch.cuda.device(q.device):
        err = fn(qs.data_ptr(), kb.data_ptr(), vb.data_ptr(), out.data_ptr(),
                 bh, n, d, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"attention kernel launch failed: CUDA error {err}")
    LAUNCHES["attention"] += 1
    LAUNCHES_BY_SHAPE[(n, d)] += 1
    return out.to(q.dtype)


def _dispatch(q, k, v, scale: float) -> torch.Tensor:
    if q.device.type == "cpu":
        return _oracle(_scaled(q, scale), k, v, 1.0)
    return flash_fwd(q, k, v, scale)


class _Attend(torch.autograd.Function):
    """K7 forward (the plain forward on CPU tensors); the backward
    re-linearises ``_oracle(q, k, v, scale)``, as _attend_bwd does."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return _dispatch(q, k, v, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            qq, kk, vv = (x.detach().requires_grad_(True) for x in (q, k, v))
            out = _oracle(qq, kk, vv, ctx.scale)
            dq, dk, dv = torch.autograd.grad(out, (qq, kk, vv),
                                             g.to(q.dtype))
        return dq, dk, dv, None


def self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   scale: float, min_seq: int = 1024) -> torch.Tensor:
    """Attention with the JAX package's routing (see the module note).

    q, k, v: [B, H, N, D] (or [B, N, D] for single-head callers); k and v
    may have another length than q (cross attention). Returns q's shape.
    """
    shape = q.shape
    if q.dim() == 3:
        q, k, v = (x[:, None] for x in (q, k, v))
    b, h, n, d = q.shape
    tq = 128 if d > 160 else 256
    qf, kf, vf = (x.reshape(b * h, x.shape[2], x.shape[3]) for x in (q, k, v))
    if n < min_seq or n % tq != 0 or k.shape[2] != n:
        out = _oracle(_scaled(qf, scale), kf, vf, 1.0)
    else:
        out = _Attend.apply(qf, kf, vf, scale)
    return out.reshape(shape)
