"""Weights carried across from the JAX package.

The JAX package's params are a nested dict ``{"coarse": {...}, "fine":
{...}}`` of arrays (pass them through ``np.asarray``; no JAX is needed
here). Per field:

- ``CPGridField``: the keys map one to one (``lines_{l}`` [3, R_l, rank],
  ``ws0 … wc2`` [in, out]).
- ``NeRFMLP``: each flax Dense ``{"kernel" [in, out], "bias"}`` under
  ``<name>`` becomes ``<name>.weight`` [out, in] and ``<name>.bias``
  (tools/convert_ref_ckpt.py::torch_nerf_to_flax has the inverse map).
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn


def field_state_dict(tree: Mapping) -> Dict[str, torch.Tensor]:
    """One field's JAX params → the port module's state dict."""
    out = {}
    for name, v in tree.items():
        if isinstance(v, Mapping):                      # flax Dense
            out[f"{name}.weight"] = torch.from_numpy(
                np.array(np.asarray(v["kernel"]).T, order="C"))
            out[f"{name}.bias"] = torch.from_numpy(np.array(v["bias"]))
        else:
            out[name] = torch.from_numpy(np.array(v))
    return out


def params_from_jax(tree: Mapping) -> Dict[str, Dict[str, torch.Tensor]]:
    """{"coarse": jax params, "fine": ...} → {"coarse": state dict, ...}."""
    return {name: field_state_dict(sub) for name, sub in tree.items()}


def load_jax_params(module: nn.Module, tree: Mapping) -> nn.Module:
    """Load one field's JAX params into ``module`` (strict: every key must
    match). Values are cast to the module's parameter dtype."""
    module.load_state_dict(field_state_dict(tree))
    return module


def params_to_jax(state_dicts: Mapping) -> Dict[str, Dict]:
    """The inverse of ``params_from_jax`` → nested dict of numpy arrays."""
    out = {}
    for name, sd in state_dicts.items():
        field = {}
        for key, t in sd.items():
            a = t.detach().cpu().numpy()
            if "." in key:                              # Linear → Dense
                layer, kind = key.rsplit(".", 1)
                dense = field.setdefault(layer, {})
                if kind == "weight":
                    dense["kernel"] = np.ascontiguousarray(a.T)
                else:
                    dense["bias"] = a
            else:
                field[key] = a
        out[name] = field
    return out
