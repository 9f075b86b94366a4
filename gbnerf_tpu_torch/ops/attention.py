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
in bf16, scores and softmax in f32, p·v summed in f32, the output in q's
dtype. It rounds the unnormalised p of an online softmax where the TPU
rounds the normalised p (the source note says why): the two agree to bf16
level relative to max|out|. ``attention_tiled_plain`` is the kernel's
algorithm in plain PyTorch (key tiles of ``key_tile(D)``, the base-2
online softmax, the key split and its log-sum-exp merge), for the tests.
K7 has two designs by head dim: up to D 128 a warp-specialised kernel (TMA
loads, wgmma, consumer warpgroups of 64 query rows a block: up to four at
D ≤ 16 and three at D ≤ 48, else two, as the grid fills the card; keys in
tiles of 64 up to D 16, 128 above); above D 128, two warps a 16-row group
on mma.sync (keys in tiles of 32).

On bf16 inputs ``flash_fwd`` is the kernel's launch alone (plus its merge
launch when the keys are split): the kernel scales q as it loads it and
writes q's dtype.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch

from ..utils.profiling import SPAN_ATTN_BWD, annotate
from ._build import kernel_function

# Calls of K7 since the last reset (chip_smoke.py zeroes and reads it), the
# kernels they launched (the forward, and the merge of a key split), and
# the calls by (N, D), which tells the UNet's (D 40, 80) from the VAE's
# (D 512).
LAUNCHES = {"attention": 0, "attention_kernels": 0}
LAUNCHES_BY_SHAPE: collections.Counter = collections.Counter()
# self_attention's self-attention calls (k as long as q) since the last
# reset, by (route, head dim): "k7", the autograd Function whose forward is
# K7 on a card, or "plain", the fallback of a short sequence or one that
# is no multiple of the query tile. Host integers, counted at dispatch on
# every device; cross attention, always plain, is not counted.
ROUTES: collections.Counter = collections.Counter()

MAX_HEAD_DIM = 512
SMALL_HEAD_DIM = 128       # the wgmma design up to here (csrc/attention.cu)
LOG2E = 1.4426950408889634


def key_tile(d: int) -> int:
    """Keys a tile of K7 at head dim d (csrc/attention.cu::key_tile)."""
    return 64 if d <= 16 else 128 if d <= SMALL_HEAD_DIM else 32


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
    if not q.dtype.is_floating_point:
        raise ValueError(f"attention: q must be a floating tensor; q is "
                         f"{q.dtype}")
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


class Plan(NamedTuple):
    """K7's launch: wm 16-row groups a block (16·wm query rows, in both
    designs; at D ≤ 128 four for each consumer warpgroup of 64 rows: 8, or
    16 up to D 16 and 12 up to D 48; 1…4 above D 128, two warps a group),
    split key ranges across blocks (merged by a second kernel)."""
    wm: int
    split: int


@functools.lru_cache(maxsize=None)
def _plan(bh: int, n: int, d: int, sm_count: int, asked: Plan) -> Plan:
    plan = (ctypes.c_int * 2)(*asked)
    fn = kernel_function("gbnerf_attention_plan",
                         [ctypes.c_int] * 4 + [ctypes.c_void_p])
    err = fn(bh, n, d, sm_count, ctypes.addressof(plan))
    if err:
        raise ValueError(f"attention: no launch plan for [{bh}, {n}, {d}] "
                         f"with {tuple(asked)}: CUDA error {err}")
    return Plan(plan[0], plan[1])


def kernel_plan(bh: int, n: int, d: int, device: torch.device, *,
                plan: Optional[Plan] = None) -> Plan:
    """The launch plan of K7 at [BH, N, D] on a card, as the kernel's
    library works it out from the card's SM count
    (csrc/attention.cu::gbnerf_attention_plan): ``plan``'s wm and split
    where it gives them (0 = choose), the split cut so that every key
    range holds a tile."""
    sm = torch.cuda.get_device_properties(device).multi_processor_count
    return _plan(bh, n, d, sm, Plan(*(plan or (0, 0))))


@functools.lru_cache(maxsize=None)
def _launch_args(bh: int, n: int, d: int, plan: Optional[Plan],
                 dtype: torch.dtype, scale: float, idx: int) -> tuple:
    """(wm, split, q_f32, the scale rounded to q's dtype) of one call
    shape, worked out once: the UNet calls K7 with a few shapes thousands
    of times, and the launch is host-bound there."""
    wm, split = kernel_plan(bh, n, d, torch.device("cuda", idx), plan=plan)
    return (wm, split, int(dtype == torch.float32),
            float(torch.tensor(scale, dtype=dtype)))


def kernel_info(d: int, wm: int = 0) -> dict:
    """Registers and local (spill) bytes a thread, dynamic shared memory a
    block (bf16 q), blocks an SM, pipeline stages, keys a tile, threads a
    block, and the depth of q·kᵀ and the width of p·v that the tensor
    cores run (D padded: up to D 128 q·kᵀ 16·⌈D/16⌉ deep; above, both at
    256, 384 or 512) of the kernel that runs head dim d at wm (0: the
    largest blocks of the design; 8 at D ≤ 48: two consumer warpgroups),
    from the kernel's library and the CUDA runtime (cudaFuncGetAttributes
    and the occupancy query) on the current card."""
    info = (ctypes.c_int * 9)()
    fn = kernel_function("gbnerf_attention_info",
                         [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    err = fn(d, wm, ctypes.addressof(info))
    if err:
        raise RuntimeError(f"attention kernel info at D {d}, wm {wm}: CUDA "
                           f"error {err}")
    return dict(zip(("registers", "spill_bytes", "smem_bytes",
                     "blocks_per_sm", "stages", "key_tile", "threads",
                     "qk_depth", "pv_width"), list(info)))


_ATTN_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                  + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p])


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x contiguous with a 16-byte aligned start (a copy only if needed)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float, *, plan: Optional[Plan] = None) -> torch.Tensor:
    """K7 on CUDA tensors: [BH, N, D] → [BH, N, D] in q's dtype.

    q: bf16 or f32, scaled and rounded to bf16 by the kernel; another
    float q is scaled in its dtype (as ``attention_plain``), passed as f32
    and the output cast back. k, v: bf16 (other dtypes are cast first).
    plan: a Plan (0 = choose) in place of ``kernel_plan``'s, for the
    tuning script. The launch reads only the tensors' pointers, so no
    autograd node is recorded.
    """
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"attention: no kernel for device {dev}; the "
                         "CPU takes the plain version")
    check_attention_args(q, k, v)
    bf = torch.bfloat16
    dtype = q.dtype
    if dtype not in (bf, torch.float32):
        q, scale = _scaled(q, scale).float(), 1.0
    qd = _aligned(q)
    kb = _aligned(k if k.dtype == bf else k.to(bf))
    vb = _aligned(v if v.dtype == bf else v.to(bf))
    bh, n, d = q.shape
    # the raw stream handle of the tensors' card; the device is switched
    # only when another one is current
    cur = torch.cuda.current_device()
    idx = cur if dev.index is None else dev.index
    wm, split, q_f32, qscale = _launch_args(bh, n, d, plan, q.dtype, scale,
                                            idx)
    out = torch.empty((bh, n, d), dtype=q.dtype, device=dev)
    part = ml = None
    if split > 1:
        part = torch.empty((split, bh, n, d), dtype=torch.float32, device=dev)
        ml = torch.empty((split, bh, n, 2), dtype=torch.float32, device=dev)
    fn = kernel_function("gbnerf_attention_fwd", _ATTN_ARGTYPES)
    with contextlib.nullcontext() if idx == cur else torch.cuda.device(idx):
        err = fn(qd.data_ptr(), kb.data_ptr(), vb.data_ptr(), out.data_ptr(),
                 None if part is None else part.data_ptr(),
                 None if ml is None else ml.data_ptr(), bh, n, d, q_f32,
                 qscale, wm, split, torch._C._cuda_getCurrentRawStream(idx))
    if err:
        raise RuntimeError(f"attention kernel launch failed: CUDA error {err}")
    LAUNCHES["attention"] += 1
    LAUNCHES["attention_kernels"] += 2 if split > 1 else 1
    LAUNCHES_BY_SHAPE[(n, d)] += 1
    return out if out.dtype == dtype else out.to(dtype)


def attention_tiled_plain(q, k, v, scale: float, *,
                          block_k: Optional[int] = None,
                          split: int = 1) -> torch.Tensor:
    """K7's algorithm in plain PyTorch: the kernel's operands (as
    ``attention_plain``), the keys in tiles of block_k (the kernel's,
    ``key_tile(D)``, by default), an online softmax
    in base 2 (p = 2^(s·log2e − m·log2e), the unnormalised p rounded to
    bf16, the accumulators rescaled by 2^((m_old − m_new)·log2e)), the keys
    split into ranges of ⌈T / split⌉ whole tiles (T tiles; fewer ranges
    than ``split`` where the tiles run out), each range's unnormalised O,
    row max and row sum merged by log-sum-exp. [BH, N, D] → q's dtype."""
    bf = torch.bfloat16
    block_k = block_k or key_tile(q.shape[-1])
    qs = _scaled(q, scale).to(bf).float()
    kf, vf = k.to(bf).float(), v.to(bf).float()
    tiles = -(-kf.shape[1] // block_k)
    per = -(-tiles // max(1, min(split, tiles)))

    def exp2_shifted(x, m):       # ex2(fma(x, log2e, −fl(m·log2e)))
        ml = (m * LOG2E).float()
        return torch.exp2((x.double() * LOG2E - ml.double()).float())

    parts = []
    for t0 in range(0, tiles, per):
        m = qs.new_full(qs.shape[:2] + (1,), -math.inf)
        l = qs.new_zeros(qs.shape[:2] + (1,))
        o = qs.new_zeros(qs.shape)
        for t in range(t0, min(tiles, t0 + per)):
            ks = kf[:, t * block_k:(t + 1) * block_k]
            vs = vf[:, t * block_k:(t + 1) * block_k]
            s = torch.einsum("bnd,bmd->bnm", qs, ks)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            corr = exp2_shifted(m, m_new)
            p = exp2_shifted(s, m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            o = o * corr + torch.einsum("bnm,bmd->bnd", p.to(bf).float(), vs)
            m = m_new
        parts.append((o, m, l))
    if len(parts) == 1:
        o, _, l = parts[0]
        return (o / l).to(q.dtype)
    mmax = torch.stack([m for _, m, _ in parts]).amax(0)
    num, den = torch.zeros_like(parts[0][0]), torch.zeros_like(parts[0][2])
    for o, m, l in parts:
        w = exp2_shifted(m, mmax)
        num, den = num + w * o, den + w * l
    return (num / den).to(q.dtype)


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
        with annotate(SPAN_ATTN_BWD), torch.enable_grad():
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
        if k.shape[2] == n:
            ROUTES["plain", d] += 1
        out = _oracle(_scaled(qf, scale), kf, vf, 1.0)
    else:
        ROUTES["k7", d] += 1
        out = _Attend.apply(qf, kf, vf, scale)
    return out.reshape(shape)
