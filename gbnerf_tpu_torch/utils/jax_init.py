"""The JAX package's initial parameters, recomputed without JAX or Flax.

Flax derives each parameter's key from the ``init`` key by folding in the
SHA-1 of the parameter's scope path and a per-scope counter
(``flax/core/scope.py``: ``LazyRng``, ``_fold_in_static``; the counter is
``Scope.make_rng``'s, one per ``self.param`` call of that scope), and draws
the value with the initializer the module declares. Both are pure
functions, so here:

- ``param_key`` is Flax's key of a parameter (flax 0.12.3, the default
  ``flax_fix_rng_separator = False``);
- the initializers are those the JAX package's modules declare: Dense and
  Conv kernels ``lecun_normal`` (a truncated normal at 1/fan_in), biases
  zeros, norm scales ones, ``nn.Embed``'s normal at 1/features,
  ``0.5 · normal`` for the CP lines (``gbnerf_tpu/core/cp_field.py``),
  ``normal(0.01)`` for the text tower's position embedding, uniform
  ±1e-4 for the hash table;
- ``init_field``, ``init_sd`` and ``init_clip_guidance`` fill the port's
  modules in place: the
  tree's names and shapes come from the port's own modules through
  ``convert.py``'s name maps, its values from the twin of the module's
  ``init``; the result is what ``convert.py`` makes of the JAX package's
  ``module.init(key, …)`` (within the ulp of ``jax_random``'s normals).
"""
from __future__ import annotations

import hashlib
import math
from typing import Callable, Dict, Mapping, Sequence, Tuple, Union

import numpy as np
import torch

from .jax_random import (JaxKey, key_fold_in, key_split, normal,
                         truncated_normal, uniform)

Foldable = Union[str, int]


def fold_in_static(key: JaxKey, data: Sequence[Foldable]) -> JaxKey:
    """Flax's ``_fold_in_static``: fold the first 4 bytes (big-endian) of
    the SHA-1 of the strings and ints of ``data`` into ``key``."""
    if not data:
        return key
    m = hashlib.sha1()
    for x in data:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        elif isinstance(x, int):
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
        else:
            raise ValueError(f"expected an int or a str, got {x!r}")
    return key_fold_in(key, int.from_bytes(m.digest()[:4], byteorder="big"))


def param_key(root: JaxKey, path: Sequence[str], counter: int) -> JaxKey:
    """The key Flax hands the ``counter``-th ``self.param`` of the scope at
    ``path`` (module names from the root) under ``module.init(root, …)``."""
    return fold_in_static(root, tuple(path) + (int(counter),))


# ---- initializers (flax / jax.nn.initializers, float32) -----------------

def _fans(shape: Tuple[int, ...]) -> Tuple[int, int]:
    """jax.nn.initializers' fans with in_axis −2, out_axis −1."""
    receptive = math.prod(shape) // (shape[-2] * shape[-1])
    return shape[-2] * receptive, shape[-1] * receptive


def lecun_normal(key: JaxKey, shape, device=None) -> torch.Tensor:
    """variance_scaling(1, "fan_in", "truncated_normal"): a normal
    truncated to ±2 scaled by √(1/fan_in) / 0.8796…, in f32 as jax
    does."""
    shape = tuple(shape)
    var = torch.tensor(1.0 / _fans(shape)[0], dtype=torch.float32)
    std = torch.sqrt(var) / torch.tensor(.87962566103423978,
                                         dtype=torch.float32)
    return truncated_normal(key, -2.0, 2.0, shape, torch.float32,
                            device) * std.to(device)


def embed_normal(key: JaxKey, shape, device=None) -> torch.Tensor:
    """nn.Embed's default: variance_scaling(1, "fan_in", "normal",
    out_axis=0) on [num_embeddings, features] → normal · √(1/features)."""
    shape = tuple(shape)
    fan_in = shape[-2] * (math.prod(shape) / shape[-2] / shape[0])
    var = torch.tensor(1.0 / fan_in, dtype=torch.float32)
    return normal(key, shape, torch.float32, device) * torch.sqrt(var).to(
        device)


def scaled_normal(scale: float) -> Callable:
    """``scale · normal`` (nn.initializers.normal(scale) and the CP lines'
    ``0.5 · jax.random.normal``)."""
    def init(key: JaxKey, shape, device=None) -> torch.Tensor:
        return normal(key, tuple(shape), torch.float32, device) * \
            torch.tensor(scale, dtype=torch.float32, device=device)
    return init


def uniform_init(lo: float, hi: float) -> Callable:
    def init(key: JaxKey, shape, device=None) -> torch.Tensor:
        return uniform(key, tuple(shape), torch.float32, device, lo, hi)
    return init


def zeros(key, shape, device=None) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=torch.float32, device=device)


def ones(key, shape, device=None) -> torch.Tensor:
    return torch.ones(tuple(shape), dtype=torch.float32, device=device)


# a Flax layer's leaves: (its self.param order, its initializer)
_LAYER_LEAVES = {"kernel": (1, lecun_normal), "scale": (1, ones),
                 "embedding": (1, embed_normal), "bias": (2, zeros)}


def fill_tree(template: Mapping, root: JaxKey,
              custom: Mapping[Tuple[str, ...], Tuple[int, Callable]] = (),
              device=None, path: Tuple[str, ...] = ()) -> Dict:
    """A Flax param tree of ``template``'s names and shapes (numpy leaves)
    with the values ``module.init(root, …)`` gives them. A leaf of a Flax
    layer (kernel, bias, scale, embedding) takes that layer's order and
    initializer; a module's own ``self.param`` leaf is looked up in
    ``custom`` by its full path → (its order in the scope, initializer).
    A bias is the layer's first parameter when the layer has no kernel
    or scale."""
    out = {}
    has_first = any(k in template for k in ("kernel", "scale", "embedding"))
    for name, v in template.items():
        here = path + (name,)
        if isinstance(v, Mapping):
            out[name] = fill_tree(v, root, custom, device, here)
            continue
        shape = tuple(np.shape(v))
        if here in dict(custom):
            counter, init = dict(custom)[here]
        elif name in _LAYER_LEAVES:
            counter, init = _LAYER_LEAVES[name]
            if name == "bias" and not has_first:
                counter = 1
        else:
            raise KeyError(f"no initializer for the parameter "
                           f"{'/'.join(here)}")
        out[name] = init(param_key(root, path, counter), shape, device)
    return out


# ---- the port's modules ---------------------------------------------------

def field_custom(template: Mapping) -> Dict[Tuple[str, ...], Tuple]:
    """The fields' own parameters in their ``self.param`` order: the CP
    field's lines, then ws0, ws1, wc0, wc1, wc2; the hash field's table."""
    lines = sorted((k for k in template if k.startswith("lines_")),
                   key=lambda k: int(k.split("_")[1]))
    custom = {(k,): (i + 1, scaled_normal(0.5)) for i, k in enumerate(lines)}
    for j, k in enumerate(("ws0", "ws1", "wc0", "wc1", "wc2")):
        if k in template:
            custom[(k,)] = (len(lines) + j + 1, lecun_normal)
    if "hash_table" in template:
        custom[("hash_table",)] = (1, uniform_init(-1e-4, 1e-4))
    return custom


def _numpy(tree: Mapping) -> Dict:
    return {k: (_numpy(v) if isinstance(v, Mapping) else v.cpu().numpy())
            for k, v in tree.items()}


@torch.no_grad()
def init_field(module: torch.nn.Module, key: JaxKey) -> torch.nn.Module:
    """Give a port field (CP grid, NeRF MLP, hash grid) the JAX package's
    ``module.init(key, …)["params"]``, in place."""
    from ..convert import field_state_dict, params_to_jax

    template = params_to_jax({"f": module.state_dict()})["f"]
    dev = next(module.parameters()).device
    tree = fill_tree(template, key, field_custom(template), dev)
    module.load_state_dict(field_state_dict(_numpy(tree)))
    return module


def init_train_fields(coarse, fine, key: JaxKey):
    """``create_train_state(cfg, key)``'s fields: split(key) → (k1, k2),
    the coarse field from k1, the fine from k2."""
    k1, k2 = key_split(key)
    init_field(coarse, k1)
    if fine is not None:
        init_field(fine, k2)
    return coarse, fine


# the towers' own ``self.param`` leaves: (order in the scope, initializer)
_TEXT_CUSTOM = {("position_embedding",): (1, scaled_normal(0.01))}
_VISION_CUSTOM = {("class_embedding",): (1, scaled_normal(0.02)),
                  ("position_embedding",): (2, scaled_normal(0.01))}


@torch.no_grad()
def init_sd(unet: torch.nn.Module, vae: torch.nn.Module,
            text: torch.nn.Module, key: JaxKey) -> None:
    """Give the port's SD towers the JAX package's random init, in place:
    ``build_sd_modules`` splits its key in three, k1 → the UNet, k2 → the
    VAE, k3 → the CLIP text tower (``gbnerf_tpu/guidance/stable.py``)."""
    from ..convert import sd_params_from_jax, sd_params_to_jax

    keys = key_split(key, 3)
    customs = ({}, {}, _TEXT_CUSTOM)
    trees = [_numpy(fill_tree(t, k, c, next(m.parameters()).device))
             for t, k, c, m in zip(sd_params_to_jax(unet, vae, text), keys,
                                   customs, (unet, vae, text))]
    for module, sd in zip((unet, vae, text), sd_params_from_jax(*trees)):
        module.load_state_dict(sd)


@torch.no_grad()
def init_clip_guidance(vision: torch.nn.Module, text, key: JaxKey
                       ) -> JaxKey:
    """``CLIPGuidance``'s init (``gbnerf_tpu/guidance/clip_guidance.py``):
    its key splits in three, k1 → the vision tower, k2 → the text tower
    (skipped when ``text`` is None: a tower the caller built), k3 → the
    random text projection, which is returned for the caller to draw."""
    from ..convert import (_TEXT_RULES, _TEXT_RULES_INV,
                           clip_vision_params_from_jax,
                           clip_vision_params_to_jax, flax_to_state_dict,
                           state_dict_to_flax)

    k1, k2, k3 = key_split(key, 3)
    dev = next(vision.parameters()).device
    tree = fill_tree(clip_vision_params_to_jax(vision), k1, _VISION_CUSTOM,
                     dev)
    vision.load_state_dict(clip_vision_params_from_jax(_numpy(tree)))
    if text is not None:
        tree = fill_tree(state_dict_to_flax(text.state_dict(),
                                            _TEXT_RULES_INV), k2,
                         _TEXT_CUSTOM, dev)
        text.load_state_dict(flax_to_state_dict(_numpy(tree), _TEXT_RULES))
    return k3
