"""Fused CP field: forward and backward, plain PyTorch and Hopper kernels.

Port of gbnerf_tpu/ops/field_fused.py. ``cp_field_fused`` maps points in
[0, 1]³ and their SH direction features to raw [N, 4] (rgb logits ⊕ σ):
the unified-line CP encode, the σ-net F → 64 → 16 and the colour net
SH ⊕ geo(15) = 31 → 64 → 64 → 3, with every matmul operand rounded to
bf16 and accumulated in f32. It is differentiable in every operand.

- On a CPU tensor the forward is the plain version (``encode_plain`` of
  ops/cp_pallas.py + ``heads_apply``) and the backward is ``field_bwd_plain``, which
  re-linearises it with ``torch.autograd.grad`` (the JAX package's
  non-TPU path). The CPU tests hold both against the JAX package.
- On a CUDA tensor the forward launches csrc/field_fused.cu (K1, or K2
  when ``sigma_only``) and the backward launches csrc/field_fused_bwd.cu
  (K4, or K5 when ``sigma_only``), which recomputes the forward and emits
  all the cotangents in one pass, as the TPU kernel does. Both run the
  heads on the tensor cores: K1/K2 as warpgroup products (wgmma, 64
  points a warpgroup), K4/K5 as mma.sync chains (csrc/field_tile.cuh,
  whose encode and fragment code K1/K2 share); the backward's sums run
  in an order fixed by the inputs (per-block partials in a scratch buffer,
  summed in block order by a second kernel), so the same inputs give
  bit-equal cotangents on every call. Anything the kernels do not take
  raises. There is no fallback.
- ``field_tiled_plain`` and ``field_bwd_tiled_plain`` are the kernels'
  algorithms in plain PyTorch (2-tap encode, the packed colour input, dW
  and dlines summed per tile, per block and in block order, dlines as the
  dense bf16 triangle-mask contraction), for the CPU tests.

On the layout: the TPU kernels work in [features, points], a Mosaic layout
choice; the port keeps the public [points, features] layout throughout.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import torch

from ._build import kernel_function
from .cp_pallas import check_points_and_lines, encode_plain

# Ws dict keys, Dense-style [in, out] orientation (as in the JAX package).
W_KEYS = ("ws0", "ws1", "wc0", "wc1", "wc2")
SIGMA_WIDTH, GEO, SH_DIM, COLOR_WIDTH = 64, 16, 16, 64
# The widest F the kernels take: K4's tile buffers and weights fill a
# block's shared memory there (cp_rank 32 × 5 levels).
MAX_FEAT = 160
# Points a tile of K4/K5 (8 warps × 16), and the blocks
# field_bwd_tiled_plain sums over by default
BWD_TILE, PLAIN_GRID = 128, 4

# Launches of each kernel since the last reset: chip_smoke.py zeroes them
# before the main path and reads them after, to show that it ran here.
LAUNCHES = {"field_fused": 0, "field_fused_sigma": 0,
            "field_fused_bwd": 0, "field_fused_bwd_sigma": 0}


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and return f32. A bf16 @ bf16 torch.matmul returns
    bf16, one rounding more than JAX's preferred_element_type=f32, so the
    plain version multiplies bf16-rounded operands in f32 instead."""
    return t.to(torch.bfloat16).float()


def heads_apply(enc: torch.Tensor, sh: Optional[torch.Tensor],
                Ws: Dict[str, torch.Tensor], *, sigma_only: bool = False
                ) -> torch.Tensor:
    """σ/colour MLP heads on an encoding — plain version, [points, feats].

    bf16 operands, f32 accumulation, relu in f32. Returns raw [..., 4]
    (rgb logits ⊕ σ); rgb is zero when sigma_only (sh is then unused).
    """

    def dot(h, w):
        return _bf16(h) @ _bf16(w)

    h = torch.relu(dot(enc, Ws["ws0"]))
    h = dot(h, Ws["ws1"])                          # [..., 16]
    sigma = h[..., :1]
    if sigma_only:
        return torch.cat([torch.zeros(sigma.shape[:-1] + (3,),
                                      dtype=sigma.dtype, device=sigma.device),
                          sigma], dim=-1)
    hc = torch.cat([sh.float(), h[..., 1:]], dim=-1)
    h = torch.relu(dot(hc, Ws["wc0"]))
    h = torch.relu(dot(h, Ws["wc1"]))
    rgb = dot(h, Ws["wc2"])
    return torch.cat([rgb, sigma], dim=-1)


def field_plain(x01, sh, ulines, Ws, *, sigma_only: bool = False):
    """The plain version of K1/K2 (the JAX package's ``_oracle``). Its
    encode is K6's plain version, ``encode_plain`` (the JAX package's
    ``encode_oracle``), which materialises one [N, R_max] f32 weight matrix
    per axis: ≈ 4.3 GB at N = 4 M points and R_max = 257, so compare
    against it on a subset of points."""
    return heads_apply(encode_plain(x01.float(), ulines, ulines.shape[1]), sh,
                       Ws, sigma_only=sigma_only)


def field_bwd_plain(x01, sh, ulines, Ws, g, *, sigma_only: bool):
    """The plain version of K4/K5: every cotangent of ``field_plain``.

    Re-linearises the plain forward with ``torch.autograd.grad``, as the
    JAX package's non-TPU backward re-linearises its oracle. g: [N, 4].
    Returns (dx [N, 3], dsh [N, 16] | None, dulines [3, R_max, F],
    {key: dW} in Dense orientation); sigma_only has no dsh and only the
    σ-net's dW (ws0, ws1).
    """
    keys = W_KEYS[:2] if sigma_only else W_KEYS
    with torch.enable_grad():
        x = x01.detach().requires_grad_(True)
        s = None if sigma_only else sh.detach().requires_grad_(True)
        ul = ulines.detach().requires_grad_(True)
        W = {k: Ws[k].detach().requires_grad_(True) for k in keys}
        inputs = [x] + ([] if sigma_only else [s]) + [ul] + [W[k] for k in keys]
        out = field_plain(x, s, ul, W, sigma_only=sigma_only)
        grads = torch.autograd.grad(out, inputs, g, allow_unused=True)
    grads = [torch.zeros_like(i) if d is None else d
             for d, i in zip(grads, inputs)]
    dx = grads.pop(0)
    dsh = None if sigma_only else grads.pop(0)
    dul = grads.pop(0)
    return dx, dsh, dul, dict(zip(keys, grads))


def field_fused_bwd(x01, sh, ulines, Ws, g, *, sigma_only: bool,
                    need_dx: bool = True, need_dsh: bool = True):
    """Every cotangent of ``cp_field_fused`` for the output cotangent g.

    CPU tensors: ``field_bwd_plain``. CUDA tensors: K4 (K5 when
    sigma_only), or an error. dx and dsh are None where not needed.
    """
    if x01.device.type == "cpu":
        dx, dsh, dul, dWs = field_bwd_plain(x01, sh, ulines, Ws, g,
                                            sigma_only=sigma_only)
        return (dx if need_dx else None, dsh if need_dsh else None, dul,
                dWs)
    if x01.device.type != "cuda":
        raise ValueError(f"field_fused_bwd: no kernel for device "
                         f"{x01.device}; tensors must lie on the CPU or a "
                         "CUDA device")
    return _launch_bwd(x01, sh, ulines, Ws, g, sigma_only=sigma_only,
                       need_dx=need_dx, need_dsh=need_dsh)


def _forward(x01, sh, ulines, Ws, *, sigma_only: bool) -> torch.Tensor:
    if x01.device.type == "cpu":
        return field_plain(x01, sh, ulines, Ws, sigma_only=sigma_only)
    return _launch(x01, sh, ulines, Ws, sigma_only=sigma_only)


class _Field(torch.autograd.Function):
    """K1 forward, K4 backward (the plain pair on CPU tensors)."""

    @staticmethod
    def forward(ctx, x01, sh, ulines, ws0, ws1, wc0, wc1, wc2):
        ws = (ws0, ws1, wc0, wc1, wc2)
        ctx.save_for_backward(x01, sh, ulines, *ws)
        return _forward(x01, sh, ulines, dict(zip(W_KEYS, ws)),
                        sigma_only=False)

    @staticmethod
    def backward(ctx, g):
        x01, sh, ulines, *ws = ctx.saved_tensors
        need = ctx.needs_input_grad
        dx, dsh, dul, dWs = field_fused_bwd(
            x01, sh, ulines, dict(zip(W_KEYS, ws)), g, sigma_only=False,
            need_dx=need[0], need_dsh=need[1])
        return (dx, dsh, dul) + tuple(dWs[k] for k in W_KEYS)


class _FieldSigma(torch.autograd.Function):
    """K2 forward, K5 backward (the plain pair on CPU tensors)."""

    @staticmethod
    def forward(ctx, x01, ulines, ws0, ws1):
        ctx.save_for_backward(x01, ulines, ws0, ws1)
        return _forward(x01, None, ulines, {"ws0": ws0, "ws1": ws1},
                        sigma_only=True)

    @staticmethod
    def backward(ctx, g):
        x01, ulines, ws0, ws1 = ctx.saved_tensors
        dx, _, dul, dWs = field_fused_bwd(
            x01, None, ulines, {"ws0": ws0, "ws1": ws1}, g, sigma_only=True,
            need_dx=ctx.needs_input_grad[0])
        return dx, dul, dWs["ws0"], dWs["ws1"]


def cp_field_fused(x01: torch.Tensor, sh: Optional[torch.Tensor],
                   ulines: torch.Tensor, Ws: Dict[str, torch.Tensor], *,
                   sigma_only: bool = False) -> torch.Tensor:
    """Fused CP field: points + SH → raw [N, 4] (rgb logits ⊕ σ).

    Differentiable in x01, sh, ulines and every head weight.

    Args:
      x01: [N, 3] points in [0, 1]³, f32.
      sh: [N, 16] per-point SH direction encoding, f32; unused (may be
        None) when sigma_only.
      ulines: [3, R_max, F] unified (upsampled) CP lines.
      Ws: head weights, Dense orientation [in, out]: ws0 [F, 64],
        ws1 [64, 16], wc0 [31, 64], wc1 [64, 64], wc2 [64, 3].
    """
    if x01.device.type not in ("cpu", "cuda"):
        raise ValueError(f"cp_field_fused: no kernel for device "
                         f"{x01.device}; tensors must lie on the CPU or a "
                         "CUDA device")
    if sigma_only:
        return _FieldSigma.apply(x01, ulines, Ws["ws0"], Ws["ws1"])
    return _Field.apply(x01, sh, ulines, *(Ws[k] for k in W_KEYS))


def weight_shapes(feat: int, *, sigma_only: bool) -> Dict[str, tuple]:
    """The head weights' shapes, Dense [in, out], in W_KEYS order (the
    σ-net's only when sigma_only); also the layout of K4/K5's dW buffer."""
    shapes = {"ws0": (feat, SIGMA_WIDTH), "ws1": (SIGMA_WIDTH, GEO),
              "wc0": (SH_DIM + GEO - 1, COLOR_WIDTH),
              "wc1": (COLOR_WIDTH, COLOR_WIDTH), "wc2": (COLOR_WIDTH, 3)}
    return {k: shapes[k] for k in W_KEYS[:2 if sigma_only else 5]}


def check_field_args(x01, sh, ulines, Ws, *, sigma_only: bool) -> None:
    """Raise on anything csrc/field_fused.cu does not take."""
    tensors = [x01, ulines] + [Ws[k] for k in W_KEYS[:2 if sigma_only else 5]]
    if not sigma_only:
        tensors.append(sh)
    if any(t is None for t in tensors):
        raise ValueError("cp_field_fused: missing operand (sh is required "
                         "unless sigma_only)")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("cp_field_fused: operands lie on different devices")
    check_points_and_lines("cp_field_fused", x01, ulines)
    n, feat = x01.shape[0], ulines.shape[2]
    if feat > MAX_FEAT:
        raise ValueError(f"cp_field_fused: F = {feat} exceeds the kernels' "
                         f"{MAX_FEAT} (their shared memory)")
    shapes = weight_shapes(feat, sigma_only=sigma_only)
    for k in shapes:
        if tuple(Ws[k].shape) != shapes[k]:
            raise ValueError(f"cp_field_fused: {k} must be {shapes[k]}, got "
                             f"{tuple(Ws[k].shape)}")
    if not sigma_only:
        if sh.dtype != torch.float32 or tuple(sh.shape) != (n, SH_DIM):
            raise ValueError(f"cp_field_fused: sh must be [{n}, {SH_DIM}] "
                             f"float32, got {tuple(sh.shape)} {sh.dtype}")
        if not sh.is_contiguous() or sh.data_ptr() % 16:
            raise ValueError("cp_field_fused: sh must be contiguous and "
                             "16-byte aligned (the kernel reads float4s)")


def _row_stride(cols: int) -> int:
    """csrc/mma_common.cuh::row_stride: an odd number of 16-byte chunks."""
    return ((cols // 8) | 1) * 8


def _chunk_order(w: torch.Tensor, *, inverse: bool = False) -> torch.Tensor:
    """Rows [Fp, …] (Fp a multiple of 16) from feature order into the
    kernels' k-chunk order (csrc/field_tile.cuh::feat_pos), or back:
    feature 16c + 4t + 2j + e sits at row 16c + 8j + 2t + e, so that the
    four A entries of lane t (rows 2t, 2t + 1, 2t + 8, 2t + 9) are four
    neighbouring features. A view and one copy on the tensor's device
    (nothing copied from the host, so it also runs in a CUDA graph's
    capture)."""
    n, rest = w.shape[0], w.shape[1:]
    shape = (n // 16, 4, 2, 2) if not inverse else (n // 16, 2, 4, 2)
    return w.reshape(*shape, *rest).transpose(1, 2).reshape(n, *rest)


def weight_layout(feat: int, *, sigma_only: bool) -> Dict[str, tuple]:
    """csrc/field_tile.cuh::weight_layout: {key: (offset, rows, stride)} of
    the packed bf16 weights, and "total". ws0 [Fp][72] (Fp = F rounded up
    to 16; rows in ``_chunk_order``), ws1 [64][24], wc0 [32][72]
    (rows SH 0–15, a zero row, geo 1–15), wc1 [64][72], wc2 [64][8];
    σ-only stops after ws1."""
    fp = -(-feat // 16) * 16
    rows = {"ws0": fp, "ws1": SIGMA_WIDTH, "wc0": 32, "wc1": COLOR_WIDTH,
            "wc2": COLOR_WIDTH}
    cols = {"ws0": SIGMA_WIDTH, "ws1": GEO, "wc0": COLOR_WIDTH,
            "wc1": COLOR_WIDTH, "wc2": 8}
    out, off = {}, 0
    for k in W_KEYS[:2 if sigma_only else 5]:
        out[k] = (off, rows[k], _row_stride(cols[k]))
        off += rows[k] * _row_stride(cols[k])
    out["total"] = off
    return out


# (feat, sigma_only, device) → (index [total] int64, a zero [1]): the
# packed buffer as positions in the flat weights (W_KEYS order, each
# row-major) with one zero appended, which every padding entry takes
_PACK_INDEX: Dict[tuple, tuple] = {}


def _pack_index(feat: int, sigma_only: bool, device: torch.device) -> tuple:
    """``pack_weights``' gather map, made with device operations alone (no
    copy from the host) and cached per shape and device; inside a CUDA
    graph's capture it is made anew (a capture runs no kernel)."""
    key = (feat, sigma_only, device)
    hit = _PACK_INDEX.get(key)
    if hit is not None:
        return hit
    lay = weight_layout(feat, sigma_only=sigma_only)
    shapes = weight_shapes(feat, sigma_only=sigma_only)
    n_flat = sum(a * b for a, b in shapes.values())
    index = torch.full((lay["total"],), n_flat, dtype=torch.int64,
                       device=device)
    start = 0
    for k, (a, b) in shapes.items():
        off, rows, stride = lay[k]
        view = index[off:off + rows * stride].view(rows, stride)
        src = torch.arange(start, start + a * b, device=device).view(a, b)
        if k == "wc0":
            view[:SH_DIM, :COLOR_WIDTH] = src[:SH_DIM]
            view[SH_DIM + 1:, :COLOR_WIDTH] = src[SH_DIM:]
        elif k == "ws0":
            view[:, :SIGMA_WIDTH] = _chunk_order(torch.nn.functional.pad(
                src, (0, 0, 0, rows - feat), value=n_flat))
        else:
            view[:a, :b] = src
        start += a * b
    hit = (index, torch.zeros(1, dtype=torch.float32, device=device))
    if not (device.type == "cuda"
            and torch.cuda.is_current_stream_capturing()):
        _PACK_INDEX[key] = hit
    return hit


def pack_weights(Ws: Dict[str, torch.Tensor], *, sigma_only: bool
                 ) -> torch.Tensor:
    """The kernels' weight buffer (csrc/field_tile.cuh): bf16, each weight
    row-major [in][out] with padded rows (``weight_layout``), every padding
    entry zero. ws0's rows follow ``_chunk_order``; wc0's go SH (0–15), a
    zero row, geo (17–31): the kernels multiply it with h1 as it stands,
    σ column zeroed. Three launches: the flat weights and a zero
    concatenated, cast to bf16 and gathered by ``_pack_index``."""
    w0 = Ws["ws0"]
    index, zero = _pack_index(w0.shape[0], sigma_only, w0.device)
    flat = torch.cat([Ws[k].detach().reshape(-1)
                      for k in W_KEYS[:2 if sigma_only else 5]] + [zero])
    return flat.to(torch.bfloat16)[index]


def unpack_weights(buf: torch.Tensor, feat: int, *, sigma_only: bool
                   ) -> Dict[str, torch.Tensor]:
    """pack_weights' inverse: {key: bf16-rounded weight as f32}."""
    lay = weight_layout(feat, sigma_only=sigma_only)
    out = {}
    for k, (a, b) in weight_shapes(feat, sigma_only=sigma_only).items():
        off, rows, stride = lay[k]
        view = buf[off:off + rows * stride].view(rows, stride).float()
        if k == "wc0":
            out[k] = torch.cat([view[:SH_DIM, :b], view[SH_DIM + 1:, :b]])
        elif k == "ws0":
            out[k] = _chunk_order(view[:, :b], inverse=True)[:a]
        else:
            out[k] = view[:a, :b].clone()
    return out


def _launch(x01, sh, ulines, Ws, *, sigma_only: bool) -> torch.Tensor:
    check_field_args(x01, sh, ulines, Ws, sigma_only=sigma_only)
    n, r_max, feat = x01.shape[0], ulines.shape[1], ulines.shape[2]
    lines = ulines.detach().to(torch.bfloat16).contiguous()
    wpack = pack_weights(Ws, sigma_only=sigma_only)
    out = torch.empty((n, 4), dtype=torch.float32, device=x01.device)
    fn = kernel_function("gbnerf_field_fused", [ctypes.c_void_p] * 5
                         + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    with torch.cuda.device(x01.device):
        err = fn(x01.data_ptr(), None if sigma_only else sh.data_ptr(),
                 lines.data_ptr(), wpack.data_ptr(), out.data_ptr(),
                 n, r_max, feat, int(sigma_only),
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"field_fused kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["field_fused_sigma" if sigma_only else "field_fused"] += 1
    return out


def check_bwd_args(x01, sh, ulines, Ws, g, *, sigma_only: bool) -> None:
    """Raise on anything csrc/field_fused_bwd.cu does not take."""
    check_field_args(x01, sh, ulines, Ws, sigma_only=sigma_only)
    n = x01.shape[0]
    if g.device != x01.device:
        raise ValueError("field_fused_bwd: the cotangent must lie on the "
                         "points' device")
    if g.dtype != torch.float32 or tuple(g.shape) != (n, 4):
        raise ValueError(f"field_fused_bwd: the cotangent must be [{n}, 4] "
                         f"float32, got {tuple(g.shape)} {g.dtype}")


@functools.lru_cache(maxsize=None)
def _bwd_grid(n: int, r_max: int, feat: int, sigma_only: bool,
              device: int) -> tuple:
    del device                # the key: the card the query ran on
    fn = kernel_function("gbnerf_field_fused_bwd_grid", [ctypes.c_int] * 4)
    grid = fn(n, r_max, feat, int(sigma_only))
    if grid <= 0:
        raise RuntimeError(f"field_fused_bwd: occupancy query failed: CUDA "
                           f"error {-grid}")
    row = kernel_function("gbnerf_field_fused_bwd_row", [ctypes.c_int] * 3)(
        r_max, feat, int(sigma_only))
    return grid, row


def bwd_grid(n: int, r_max: int, feat: int, sigma_only: bool) -> tuple:
    """(grid, row): the persistent blocks K4/K5 run for n points on the
    current card and the floats of each block's row of their scratch
    buffer, its two dimensions (queried once a shape)."""
    return _bwd_grid(n, r_max, feat, sigma_only, torch.cuda.current_device())


def _launch_bwd(x01, sh, ulines, Ws, g, *, sigma_only: bool, need_dx: bool,
                need_dsh: bool):
    check_bwd_args(x01, sh, ulines, Ws, g, sigma_only=sigma_only)
    n, r_max, feat = x01.shape[0], ulines.shape[1], ulines.shape[2]
    dev = x01.device
    g = g.contiguous()        # autograd may hand over a strided view
    if g.data_ptr() % 16:     # the kernel reads float4s
        g = g.clone()
    lines = ulines.detach().to(torch.bfloat16).contiguous()
    wpack = pack_weights(Ws, sigma_only=sigma_only)
    shapes = weight_shapes(feat, sigma_only=sigma_only)
    n_dl = 3 * r_max * feat
    # the blocks' partials (each block's dlines slice, dW and the dlines
    # units it touched), summed in block order into out = dlines ⊕ dW by
    # the kernel's second launch
    with torch.cuda.device(dev):
        grid, row = bwd_grid(n, r_max, feat, sigma_only)
        scratch = torch.empty((grid, row), dtype=torch.float32, device=dev)
        out = torch.empty(n_dl + sum(a * b for a, b in shapes.values()),
                          dtype=torch.float32, device=dev)
        dx = (torch.empty((n, 3), dtype=torch.float32, device=dev)
              if need_dx else None)
        dsh = (torch.empty((n, SH_DIM), dtype=torch.float32, device=dev)
               if need_dsh and not sigma_only else None)
        fn = kernel_function("gbnerf_field_fused_bwd", [ctypes.c_void_p] * 9
                             + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        err = fn(x01.data_ptr(), None if sigma_only else sh.data_ptr(),
                 g.data_ptr(), lines.data_ptr(), wpack.data_ptr(),
                 None if dx is None else dx.data_ptr(),
                 None if dsh is None else dsh.data_ptr(),
                 scratch.data_ptr(), out.data_ptr(), n, r_max, feat,
                 int(sigma_only), grid,
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"field_fused_bwd kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES["field_fused_bwd_sigma" if sigma_only else "field_fused_bwd"] += 1
    dlines, dw = out[:n_dl].view(3, r_max, feat), out[n_dl:]
    dWs, off = {}, 0
    for k, (a, b) in shapes.items():
        dWs[k] = dw[off:off + a * b].view(a, b)
        off += a * b
    return dx, dsh, dlines, dWs


BWD_INFO_KEYS = ("registers", "spill_bytes", "smem_bytes", "blocks_per_sm",
                 "warps", "cluster", "dw_smem_floats", "tile")
FWD_INFO_KEYS = BWD_INFO_KEYS[:4] + ("warpgroups", "tile")


def kernel_info(*, backward: bool, sigma_only: bool, r_max: int, feat: int
                ) -> Dict[str, int]:
    """Registers and local (spill) bytes a thread, dynamic shared memory a
    block and blocks an SM of K1/K2 (K4/K5 when ``backward``) at this
    shape, from the CUDA runtime (cudaFuncGetAttributes and the occupancy
    query) on the current card; K1/K2 also their warpgroups a block and
    points a warpgroup step (``FWD_INFO_KEYS``), K4/K5 their warps a
    block, blocks a cluster, the dW floats a block sums in shared memory
    and points a tile (``BWD_INFO_KEYS``)."""
    keys = BWD_INFO_KEYS if backward else FWD_INFO_KEYS
    info = (ctypes.c_int * len(keys))()
    fn = kernel_function("gbnerf_field_fused_bwd_info" if backward
                         else "gbnerf_field_fused_info",
                         [ctypes.c_int] * 3 + [ctypes.c_void_p])
    err = fn(r_max, feat, int(sigma_only), ctypes.addressof(info))
    if err:
        raise RuntimeError(f"field kernel info: CUDA error {err}")
    return dict(zip(keys, list(info)))


# ---------------------------------------------------------------------------
# The kernels' algorithms in plain PyTorch (the CPU tests' mirror of
# csrc/field_tile.cuh, field_fused.cu and field_fused_bwd.cu)
# ---------------------------------------------------------------------------


def _taps(x01: torch.Tensor, r_max: int):
    """field_common.cuh::cp_tap for every point and axis: i0 [N, 3] int64,
    the signed distances d0, d1 and the bf16 tap weights w0, w1 [N, 3]."""
    u = x01.clamp(0.0, 1.0) * (r_max - 1)
    i0 = torch.clamp(torch.floor(u), max=r_max - 2)
    d0, d1 = i0 - u, i0 + 1.0 - u
    return (i0.long(), d0, d1, _bf16(1.0 - d0.abs()), _bf16(1.0 - d1.abs()))


def _tie_sign(d: torch.Tensor) -> torch.Tensor:
    """field_common.cuh::tie_sign: sign(d)·[|d| < 1], 0 at d = 0."""
    return torch.sign(d) * (d.abs() < 1.0).float()


def _lerps(x01, ulines):
    """The 2-tap lerps fa [3, N, F], the tap rows l0, l1 [3, N, F] (bf16
    values) and the taps, as the kernels gather them."""
    r_max = ulines.shape[1]
    lines = _bf16(ulines)
    i0, d0, d1, w0, w1 = _taps(x01.float(), r_max)
    l0 = torch.stack([lines[a][i0[:, a]] for a in range(3)])
    l1 = torch.stack([lines[a][i0[:, a] + 1] for a in range(3)])
    fa = torch.addcmul(w0.t()[..., None] * l0, w1.t()[..., None], l1)
    return fa, l0, l1, (i0, d0, d1, w0, w1)


def _wc0_packed(wc0: torch.Tensor) -> torch.Tensor:
    """wc0 as the kernels pack it: rows SH, a zero row, geo (32 × 64)."""
    zero = torch.zeros_like(wc0[:1])
    return torch.cat([wc0[:SH_DIM], zero, wc0[SH_DIM:]])


def _heads_tiled(prod, sh, Ws, sigma_only):
    """The kernels' head chain: every product's operands bf16, sums f32,
    relu masks kept. hc is [SH, 0, h1[1:]] against the packed wc0."""
    dot = lambda a, w: _bf16(a) @ _bf16(w)            # noqa: E731
    h0 = dot(prod, Ws["ws0"])
    m0 = h0 > 0
    a0 = torch.relu(h0)
    h1 = dot(a0, Ws["ws1"])
    acts = {"prod": _bf16(prod), "a0": _bf16(a0), "m0": m0, "h1": h1}
    if sigma_only:
        return acts
    hc = torch.cat([sh.float(), torch.zeros_like(h1[:, :1]), h1[:, 1:]], 1)
    h2 = dot(hc, _wc0_packed(Ws["wc0"]))
    a2 = torch.relu(h2)
    h3 = dot(a2, Ws["wc1"])
    a3 = torch.relu(h3)
    acts.update(hc=_bf16(hc), a2=_bf16(a2), m2=h2 > 0, a3=_bf16(a3),
                m3=h3 > 0, rgb=dot(a3, Ws["wc2"]))
    return acts


def field_tiled_plain(x01, sh, ulines, Ws, *, sigma_only: bool = False):
    """K1/K2's algorithm in plain PyTorch: the 2-tap encode straight into
    bf16(enc), the head chain of csrc/field_tile.cuh. Returns raw [N, 4]."""
    fa, _, _, _ = _lerps(x01, ulines)
    acts = _heads_tiled((fa[0] * fa[1]) * fa[2], sh, Ws, sigma_only)
    sigma = acts["h1"][:, :1]
    rgb = (torch.zeros_like(sigma).expand(-1, 3) if sigma_only
           else acts["rgb"])
    return torch.cat([rgb, sigma], dim=1)


def _block_sums(parts, grid: int):
    """Σ over tiles as K4/K5 take it: tile t's part into block t % grid's
    running sum (in tile order), then the blocks' sums in block order.
    (The kernels keep a block's dW sum in shared memory and write a lines
    unit only once a tile touches it, skipping the units a block never
    touched in the block-order sum: adding those zeros changes no value.)"""
    blocks = [None] * grid
    for t, part in enumerate(parts):
        b = t % grid
        blocks[b] = part.clone() if blocks[b] is None else blocks[b] + part
    total = None
    for s in blocks:
        if s is not None:
            total = s if total is None else total + s
    return total


def field_bwd_tiled_plain(x01, sh, ulines, Ws, g, *, sigma_only: bool,
                          grid: int = PLAIN_GRID, tile: int = BWD_TILE):
    """K4/K5's algorithm in plain PyTorch: every cotangent of
    ``field_tiled_plain`` for the output cotangent g [N, 4].

    The head backward with bf16 operands and f32 sums (dh1 = [g_σ,
    dhc[16:]]); dW = Σ actᵀ·cot per tile of ``tile`` points, summed per
    block (tile t to block t % grid) and in block order; dlines per tile
    as the dense contraction maskᵀ [R_max, tile] · dfa [tile, F] of the
    bf16 triangle mask with bf16 dfa, summed the same way; du from the
    tap rows, dx = du·(R_max − 1)·[0 < x < 1]. Returns what
    ``field_bwd_plain`` returns.
    """
    x = x01.float()
    n, r_max, feat = x.shape[0], ulines.shape[1], ulines.shape[2]
    fa, l0, l1, (i0, d0, d1, w0, w1) = _lerps(x, ulines)
    acts = _heads_tiled((fa[0] * fa[1]) * fa[2], sh, Ws, sigma_only)
    dot = lambda a, w: _bf16(a) @ _bf16(w)            # noqa: E731
    g = g.float()
    cots = {}
    if sigma_only:
        dh1 = torch.cat([g[:, 3:], torch.zeros_like(g[:, :1]).expand(-1, 15)],
                        1)
        dsh = None
    else:
        grgb = g[:, :3]
        dh3 = torch.where(acts["m3"], dot(grgb, Ws["wc2"].t()), 0.0)
        dh2 = torch.where(acts["m2"], dot(dh3, Ws["wc1"].t()), 0.0)
        dhc = dot(dh2, _wc0_packed(Ws["wc0"]).t())           # [N, 32]
        dsh = dhc[:, :SH_DIM]
        dh1 = torch.cat([g[:, 3:], dhc[:, SH_DIM + 1:]], 1)
        cots.update(g=_bf16(grgb), dh3=_bf16(dh3), dh2=_bf16(dh2))
    dh0 = torch.where(acts["m0"], dot(dh1, Ws["ws1"].t()), 0.0)
    cots.update(dh1=_bf16(dh1), dh0=_bf16(dh0))
    dprod = dot(dh0, Ws["ws0"].t())                          # [N, F]
    others = ((1, 2), (0, 2), (0, 1))
    dfa = torch.stack([_bf16((dprod * fa[b]) * fa[c]) for b, c in others])
    du = ((l0 * dfa).sum(-1) * _tie_sign(d0).t()
          + (l1 * dfa).sum(-1) * _tie_sign(d1).t()).t()     # [N, 3]
    in01 = (x > 0.0) & (x < 1.0)
    dx = du * torch.where(in01, float(r_max - 1), 0.0)

    pairs = [("ws0", "prod", "dh0"), ("ws1", "a0", "dh1")]
    if not sigma_only:
        pairs += [("wc0", "hc", "dh2"), ("wc1", "a2", "dh3"),
                  ("wc2", "a3", "g")]
    rows = torch.arange(r_max, device=x.device)
    dw_parts, dl_parts = [], []
    for t0 in range(0, n, tile):
        sl = slice(t0, min(n, t0 + tile))
        dw_parts.append([acts[a][sl].t() @ cots[c][sl] for _, a, c in pairs])
        masks = [(rows[:, None] == i0[sl, a]) * w0[sl, a]
                 + (rows[:, None] == i0[sl, a] + 1) * w1[sl, a]
                 for a in range(3)]                          # [R, tile]
        dl_parts.append(torch.stack([masks[a] @ dfa[a, sl]
                                     for a in range(3)]))
    dWs = {}
    for j, (k, _, _) in enumerate(pairs):
        s = _block_sums([p[j] for p in dw_parts], grid)
        if k == "wc0":            # the packed zero row 16 carries no weight
            s = torch.cat([s[:SH_DIM], s[SH_DIM + 1:]])
        dWs[k] = s
    dlines = _block_sums(dl_parts, grid)
    return dx, dsh, dlines, dWs
