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
  (K4, or K5 when ``sigma_only``), which recomputes the forward per point
  and emits all the cotangents in one pass, as the TPU kernel does. Its
  sums run in an order fixed by the inputs (per-block partials in a
  scratch buffer, summed in block order by a second kernel), so the same
  inputs give bit-equal cotangents on every call. Anything the kernels do
  not take raises. There is no fallback.

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


def pack_weights(Ws: Dict[str, torch.Tensor], *, sigma_only: bool
                 ) -> torch.Tensor:
    """The kernel's weight buffer: bf16-rounded f32, rows of 4-float units.

    ws0 [F][64] | ws1 [64][16] | wc0 [31][64] | wc1ᵀ [64 out][64 in] |
    wc2 [64][4] (column 3 zero); sigma_only stops after ws1.
    """
    parts = [_bf16(Ws["ws0"]), _bf16(Ws["ws1"])]
    if not sigma_only:
        parts += [_bf16(Ws["wc0"]), _bf16(Ws["wc1"]).t(),
                  torch.nn.functional.pad(_bf16(Ws["wc2"]), (0, 1))]
    return torch.cat([p.reshape(-1) for p in parts]).contiguous()


def _launch(x01, sh, ulines, Ws, *, sigma_only: bool) -> torch.Tensor:
    check_field_args(x01, sh, ulines, Ws, sigma_only=sigma_only)
    n, r_max, feat = x01.shape[0], ulines.shape[1], ulines.shape[2]
    lines = ulines.detach().to(torch.bfloat16).contiguous()
    wpack = pack_weights({k: w.detach() for k, w in Ws.items()
                          if w is not None}, sigma_only=sigma_only)
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
def _bwd_grid(n: int, feat: int, sigma_only: bool, device: int) -> int:
    del device                # the key: the card the query ran on
    fn = kernel_function("gbnerf_field_fused_bwd_grid", [ctypes.c_int] * 3)
    grid = fn(n, feat, int(sigma_only))
    if grid <= 0:
        raise RuntimeError(f"field_fused_bwd: occupancy query failed: CUDA "
                           f"error {-grid}")
    return grid


def bwd_grid(n: int, feat: int, sigma_only: bool) -> int:
    """The persistent blocks K4/K5 run for n points on the current card:
    the first dimension of their scratch buffer (queried once a shape)."""
    return _bwd_grid(n, feat, sigma_only, torch.cuda.current_device())


def _launch_bwd(x01, sh, ulines, Ws, g, *, sigma_only: bool, need_dx: bool,
                need_dsh: bool):
    check_bwd_args(x01, sh, ulines, Ws, g, sigma_only=sigma_only)
    n, r_max, feat = x01.shape[0], ulines.shape[1], ulines.shape[2]
    dev = x01.device
    g = g.contiguous()        # autograd may hand over a strided view
    if g.data_ptr() % 16:     # the kernel reads float4s
        g = g.clone()
    lines = ulines.detach().to(torch.bfloat16).contiguous()
    wpack = pack_weights({k: w.detach() for k, w in Ws.items()
                          if w is not None}, sigma_only=sigma_only)
    shapes = weight_shapes(feat, sigma_only=sigma_only)
    n_dl = 3 * r_max * feat
    row = n_dl + sum(a * b for a, b in shapes.values())
    # the blocks' partials (each block's dlines slice and dW), summed in
    # block order into out = dlines ⊕ dW by the kernel's second launch
    with torch.cuda.device(dev):
        grid = bwd_grid(n, feat, sigma_only)
        scratch = torch.empty((grid, row), dtype=torch.float32, device=dev)
        out = torch.empty(row, dtype=torch.float32, device=dev)
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
