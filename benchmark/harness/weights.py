"""Seeded weights, made on the device in one draw a module.

The parameters are taken in the order of their sorted names, so that the
port's module and the reference's, which carry the same names, receive the
same values. One normal draw covers them all; each is then scaled by its
kind, as flax initialises it (the distributions, not the bits): Linear and
Conv kernels N(0, 1/fan_in), biases 0, norm scales 1 and shifts 0, token
embeddings N(0, 1/width), position embeddings N(0, 0.01²). The values are
rounded to ``dtype`` (the type the port serves them in) and the reference
gets that rounding too.
"""
from __future__ import annotations

import math
import re

import torch
from torch import nn


def _scale(name: str, p: torch.Tensor) -> float:
    if name.endswith("position_embedding.weight"):
        return 0.01
    if name.endswith("token_embedding.weight"):
        return 1.0 / math.sqrt(p.shape[-1])
    if p.dim() in (2, 4) and name.endswith(".weight"):
        return 1.0 / math.sqrt(p[0].numel())
    return 0.0


def _norm_scale(name: str) -> bool:
    return bool(re.search(r"(norm[^.]*|layer_norm\d?)\.weight$", name))


@torch.no_grad()
def fill(module: nn.Module, seed: int, dtype=None) -> None:
    """Overwrite every parameter of ``module`` (on its device) from seed;
    with ``dtype`` the values are first rounded to it."""
    named = sorted(module.named_parameters(), key=lambda kv: kv[0])
    dev = named[0][1].device
    total = sum(p.numel() for _, p in named)
    g = torch.Generator(device=dev).manual_seed(int(seed))
    flat = torch.randn(total, generator=g, device=dev)
    off = 0
    for name, p in named:
        n = p.numel()
        if _norm_scale(name) and p.dim() == 1:
            v = torch.ones_like(p, dtype=torch.float32)
        else:
            v = flat[off:off + n].view(p.shape) * _scale(name, p)
        off += n
        if dtype is not None:
            v = v.to(dtype)
        p.copy_(v.to(p.dtype))
    del flat


@torch.no_grad()
def fill_field(module: nn.Module, seed: int) -> None:
    """A NeRF field's parameters from seed, in one draw: a hash table
    U(−1e-4, 1e-4) (tcnn's init), CP lines 0.5·N(0, 1), the heads
    N(0, 1/fan_in) (flax's Dense kernels [in, out] by their first axis,
    torch's Linear weights [out, in] by their second)."""
    named = sorted(module.named_parameters(), key=lambda kv: kv[0])
    dev = named[0][1].device
    g = torch.Generator(device=dev).manual_seed(int(seed))
    flat = torch.rand(sum(p.numel() for _, p in named), generator=g,
                      device=dev)
    off = 0
    for name, p in named:
        u = flat[off:off + p.numel()].view(p.shape)
        off += p.numel()
        if name == "hash_table":
            v = (2.0 * u - 1.0) * 1e-4
        else:
            z = torch.erfinv(2.0 * u.clamp(1e-7, 1 - 1e-7) - 1.0) * 2 ** 0.5
            if name.startswith("lines_"):
                v = 0.5 * z
            elif name.endswith(".weight"):        # torch Linear [out, in]
                v = z / math.sqrt(p.shape[1])
            else:                                 # flax Dense [in, out]
                v = z / math.sqrt(p.shape[0])
        p.copy_(v)
