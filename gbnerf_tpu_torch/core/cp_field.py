"""CP-factorized multiresolution grid field (the flagship field).

Port of gbnerf_tpu/core/cp_field.py. Per level l and axis a, a line
L_a^l ∈ R^{R_l × rank} is linearly interpolated at x_a and the three axes'
features multiply (TensoRF-CP). With nested resolutions every level
upsamples exactly onto the finest grid (ops/cp_pallas.py) and the whole
field — encode, σ-net, colour net — is one fused call (ops/field_fused.py),
a CUDA kernel on the card. Non-nested resolutions take the per-level
two-hot path below.

Parameter names and shapes are those of the flax module: ``lines_{l}``
[3, R_l, rank] and ``ws0 … wc2`` in Dense [in, out] orientation, so the
JAX package's params load one to one (convert.py).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.cp_pallas import check_nested, upsample_lines
from ..ops.field_fused import W_KEYS, cp_field_fused, heads_apply
from .encoding import sh_encode


def twohot_interp(x01: torch.Tensor, line: torch.Tensor, *,
                  compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Linear interpolation on a 1-D feature line via a two-hot matmul.

    x01: [N] in [0, 1]; line: [R, rank] → [N, rank] f32. The two-hot
    weights are built in compute_dtype, as in JAX, and the product
    accumulates in f32.
    """
    R = line.shape[0]
    u = torch.clamp(x01.float(), 0.0, 1.0) * (R - 1)
    i0 = torch.floor(u)
    f = (u - i0).to(compute_dtype)
    pos = torch.arange(R, dtype=torch.float32, device=x01.device)
    w0 = (pos[None, :] == i0[:, None]).to(compute_dtype)
    w1 = (pos[None, :] == (i0[:, None] + 1.0)).to(compute_dtype)
    W = w0 * (1.0 - f[:, None]) + w1 * f[:, None]
    return W.float() @ line.to(compute_dtype).float()


def cp_encode(x01: torch.Tensor, lines: Sequence[torch.Tensor], *,
              compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Multi-level CP encoding: [N, 3] → [N, L·rank]."""
    outs = []
    for line3 in lines:
        fx = twohot_interp(x01[:, 0], line3[0], compute_dtype=compute_dtype)
        fy = twohot_interp(x01[:, 1], line3[1], compute_dtype=compute_dtype)
        fz = twohot_interp(x01[:, 2], line3[2], compute_dtype=compute_dtype)
        outs.append(fx * fy * fz)
    return torch.cat(outs, dim=-1)


def lecun_normal(shape: Tuple[int, int],
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's lecun_normal for a Dense kernel [in, out]: a normal of
    variance 1/fan_in truncated at ±2σ (σ corrected for the truncation)."""
    std = math.sqrt(1.0 / shape[0]) / 0.87962566103423978
    t = torch.empty(shape, device=generator.device if generator else None)
    return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


class CPGridField(nn.Module):
    """Multiresolution CP grid + tcnn-topology heads → raw [..., 4].

    Head widths are fixed by the fused kernel's topology: 2×64 σ-net with a
    15-dim geometry feature, SH-degree-4 directions, 3×64 colour net.
    Parameters are drawn from ``generator`` (on its device) and moved to
    ``device``.
    """

    def __init__(self, bound: float = 100.0,
                 resolutions: Tuple[int, ...] = (17, 33, 65, 129, 257),
                 rank: int = 16, fused: bool = True, sigma_width: int = 64,
                 geo_feat_dim: int = 15, color_width: int = 64,
                 sh_degree: int = 4, compute_dtype=torch.bfloat16, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.bound = bound
        self.resolutions = tuple(resolutions)
        self.rank = rank
        self.fused = fused
        self.sh_degree = sh_degree
        self.compute_dtype = compute_dtype
        gdev = generator.device if generator is not None else None
        for l, R in enumerate(self.resolutions):
            # CP products multiply three factors; init around ±0.5 keeps
            # products O(0.1) with healthy gradients to every factor.
            lines = 0.5 * torch.randn((3, R, rank), generator=generator,
                                      device=gdev)
            self.register_parameter(f"lines_{l}",
                                    nn.Parameter(lines.to(device)))
        feat = len(self.resolutions) * rank
        sh_dim = sh_degree ** 2
        shapes = {"ws0": (feat, sigma_width),
                  "ws1": (sigma_width, 1 + geo_feat_dim),
                  "wc0": (sh_dim + geo_feat_dim, color_width),
                  "wc1": (color_width, color_width),
                  "wc2": (color_width, 3)}
        for k in W_KEYS:
            self.register_parameter(
                k, nn.Parameter(lecun_normal(shapes[k], generator).to(device)))

    def lines(self):
        return [getattr(self, f"lines_{l}")
                for l in range(len(self.resolutions))]

    def forward(self, pts: torch.Tensor, viewdirs: Optional[torch.Tensor],
                sigma_only: bool = False) -> torch.Tensor:
        x01 = (pts + self.bound) / (2.0 * self.bound)
        flat = x01.reshape(-1, 3).float().contiguous()
        Ws = {k: getattr(self, k) for k in W_KEYS}
        sh_dim = self.sh_degree ** 2
        if sigma_only:
            sh = None                                     # never read
        else:
            # viewdirs may be per-ray ([..., 1, 3] against [..., S, 3] pts):
            # SH is computed per ray and broadcast over the samples. The
            # kernel reads sh as dense rows: for one ray the broadcast is a
            # stride-0 view that reshape keeps, so it is copied here.
            d = sh_encode(viewdirs.float(), self.sh_degree)
            sh = d.expand(pts.shape[:-1] + (sh_dim,)).reshape(
                -1, sh_dim).contiguous()

        r_max = max(self.resolutions)
        nested = all((r_max - 1) % (r - 1) == 0 for r in self.resolutions)
        if self.fused and nested:
            check_nested(self.resolutions)
            ulines = upsample_lines(self.lines(), r_max)
            raw = cp_field_fused(flat, sh, ulines, Ws, sigma_only=sigma_only)
        else:
            enc = cp_encode(flat, self.lines(),
                            compute_dtype=self.compute_dtype)
            raw = heads_apply(enc, sh, Ws, sigma_only=sigma_only)
        return raw.reshape(*pts.shape[:-1], 4).float()
