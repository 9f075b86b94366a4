"""Tensor parallelism for the diffusion guidance models (UNet, VAE).

Port of gbnerf_tpu/parallel/tp.py. The guidance step's batch axis is 1, so
data parallelism cannot split it; its scaling axis is the channels. The
rules are the JAX package's (tp.py:14-21 there):
  - every Conv2d and Linear whose output-channel count divides by n keeps
    its slice of output channels (weight and bias) on each rank of the
    ``model`` axis;
  - norm parameters (a name fragment of ``_NORM_KEYS`` in the flax path)
    and everything else stay replicated.
Where GSPMD places the collectives in the JAX package, each sharded layer
here (``ColumnShard``) computes its channels and gathers the rest, so that
GroupNorm, LayerNorm and the attention kernel (K7) see whole activations;
its input's cotangent is averaged over the axis (mesh.py::mean_grad),
which with the gather's summed backward gives every rank the one-process
cotangent.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..convert import flax_key
from .mesh import (DeviceMesh, all_reduce_max, axis_rank, axis_size, gather,
                   mean_grad)

# param-name fragments that stay replicated although their leaves look
# shardable (a norm's [C] parameters follow the replicated statistics)
_NORM_KEYS = ("norm", "ln_", "layernorm", "groupnorm")


def _is_norm_path(name: str, ndim: int) -> bool:
    path = flax_key(name, ndim).lower()
    return any(k in path for k in _NORM_KEYS)


def tp_param_specs(module: nn.Module, n: int) -> Dict[str, Optional[int]]:
    """Parameter name → the dim sharded over an n-rank ``model`` axis (0,
    the output channels of a Conv2d or Linear weight and of its bias), or
    None (replicated). The names are the port's; convert.tp_names_from_jax
    maps the JAX package's spec tree onto them."""
    specs = {}
    for name, p in module.named_parameters():
        shard = (p.ndim in (1, 2, 4) and p.shape[0] % n == 0
                 and not _is_norm_path(name, p.ndim))
        specs[name] = 0 if shard else None
    return specs


class ColumnShard(nn.Module):
    """A Conv2d or Linear that holds this rank's slice of the output
    channels (``weight``, ``bias``: the wrapped layer's names), computes
    it, and gathers the channels of every rank of the axis."""

    def __init__(self, layer: nn.Module, mesh: DeviceMesh, axis: str):
        super().__init__()
        n, i = axis_size(mesh, axis), axis_rank(mesh, axis)
        rows = layer.weight.shape[0] // n
        part = slice(i * rows, (i + 1) * rows)
        self.weight = nn.Parameter(layer.weight.detach()[part].clone(),
                                   requires_grad=layer.weight.requires_grad)
        self.bias = (None if layer.bias is None else nn.Parameter(
            layer.bias.detach()[part].clone(),
            requires_grad=layer.bias.requires_grad))
        self.conv = isinstance(layer, nn.Conv2d)
        if self.conv:
            if layer.groups != 1:
                raise ValueError("a grouped conv cannot shard its outputs")
            self.conv_kw = dict(stride=layer.stride, padding=layer.padding,
                                dilation=layer.dilation)
        self.mesh, self.axis = mesh, axis

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = mean_grad(x, self.mesh, self.axis)
        if self.conv:
            y = F.conv2d(x, self.weight, self.bias, **self.conv_kw)
            return gather(y, self.mesh, self.axis, dim=1)
        y = F.linear(x, self.weight, self.bias)
        return gather(y, self.mesh, self.axis, dim=-1)


def shard_params_tp(module: nn.Module, mesh: DeviceMesh,
                    axis: str = "model") -> nn.Module:
    """Replace, in place, every Conv2d and Linear that ``tp_param_specs``
    shards by a ColumnShard of it; returns the module. Its parameter names
    are unchanged. A trainable sharded layer is refused: the port's steps
    average gradients over every rank (mesh.py::average_grads), which is
    right for replicated parameters only."""
    n = axis_size(mesh, axis)
    if n == 1:
        return module
    specs = tp_param_specs(module, n)
    for name, layer in list(module.named_modules()):
        if not isinstance(layer, (nn.Conv2d, nn.Linear)):
            continue
        if specs.get(f"{name}.weight") is None:
            continue
        if layer.weight.requires_grad:
            raise ValueError(f"{name} trains: tensor parallelism shards "
                             "frozen towers only")
        parent_name, _, child = name.rpartition(".")
        parent = module.get_submodule(parent_name) if parent_name else module
        setattr(parent, child, ColumnShard(layer, mesh, axis))
    return module


def sharded_bytes_per_device(module: nn.Module,
                             mesh: Optional[DeviceMesh] = None) -> int:
    """The most parameter bytes any rank holds (this rank's without a
    mesh)."""
    local = sum(p.numel() * p.element_size() for p in module.parameters())
    if mesh is None:
        return local
    t = torch.tensor([float(local)], dtype=torch.float64,
                     device=next(module.parameters()).device)
    return int(all_reduce_max(t).item())
