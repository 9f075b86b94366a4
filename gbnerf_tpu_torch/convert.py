"""Weights carried across from the JAX package.

The JAX package's params are a nested dict ``{"coarse": {...}, "fine":
{...}}`` of arrays (pass them through ``np.asarray``; no JAX is needed
here). Per field:

- ``CPGridField``: the keys map one to one (``lines_{l}`` [3, R_l, rank],
  ``ws0 … wc2`` [in, out]).
- ``NeRFMLP``: each flax Dense ``{"kernel" [in, out], "bias"}`` under
  ``<name>`` becomes ``<name>.weight`` [out, in] and ``<name>.bias``
  (tools/convert_ref_ckpt.py::torch_nerf_to_flax has the inverse map).
- ``HashGridField``: ``hash_table`` [L, T, F] maps one to one; its Dense
  layers have no bias, so ``{"kernel"}`` becomes ``<name>.weight`` alone.

A whole train state carries across too (``train_state_from_jax`` and
``train_state_to_jax``): optax's Adam moments ``mu``/``nu`` have the
params' tree structure and map to torch Adam's ``exp_avg``/``exp_avg_sq``
by the same key rules; optax's ``count`` (updates done) is torch's
per-parameter ``step``.

The SD guidance stack carries across with ``sd_params_from_jax``: the flax
module names (``down_0_resnets_1``, ``to_out_0``, ``net_0``) map to the
port's diffusers names, and the leaves to torch's layouts. LPIPS's VGG16
carries across with ``lpips_params_from_jax``, CLIP guidance's vision
tower with ``clip_vision_params_from_jax``. ``state_dict_to_flax`` is
the inverse of ``flax_to_state_dict`` (the prior checkpoints of
guidance/weights.py are written in the flax tree's names and layouts), and
``flax_key`` names a port parameter by its flax path (the LoRA adapter
files of guidance/lora.py are keyed by it).
"""
from __future__ import annotations

import re
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
            if "bias" in v:                             # use_bias=False: none
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


def _adam_moments(opt_state):
    """The (count, mu, nu) of optax.adam's state — a tuple holding a
    ScaleByAdamState (a NamedTuple, or a dict with the same keys after
    ``train_state_to_jax``) and a ScaleByScheduleState."""
    for part in opt_state:
        get = part.get if isinstance(part, Mapping) else (
            lambda k, p=part: getattr(p, k, None))
        if get("mu") is not None and get("nu") is not None:
            return int(np.asarray(get("count"))), get("mu"), get("nu")
    raise ValueError("no Adam moments (mu, nu) in the optimizer state")


def train_state_from_jax(params: Mapping, opt_state, step, *, cfg,
                         device=None):
    """A JAX train state (numpy trees, as ``jax.device_get(state)`` gives
    them: ``state.params``, ``state.opt_state``, ``state.step``) → the
    port's TrainState on ``device``, which then continues the run."""
    from .train.state import create_train_state

    state, coarse, fine = create_train_state(
        cfg, torch.Generator().manual_seed(0), device)
    count, mu, nu = _adam_moments(opt_state)
    for name, module in (("coarse", coarse), ("fine", fine)):
        if module is None:
            continue
        load_jax_params(module, params[name])
        m_sd, v_sd = field_state_dict(mu[name]), field_state_dict(nu[name])
        for key, p in module.named_parameters():
            state.optimizer.state[p] = {
                "step": torch.tensor(float(count)),
                "exp_avg": m_sd[key].to(p.device, p.dtype),
                "exp_avg_sq": v_sd[key].to(p.device, p.dtype)}
    state.step = int(np.asarray(step))
    return state


def train_state_to_jax(state):
    """The inverse: TrainState → (params, opt_state, step) as numpy trees.

    opt_state mirrors optax.adam's tuple with dicts in place of its
    NamedTuples: ({"count", "mu", "nu"}, {"count"}); ``ScaleByAdamState(
    **opt_state[0])`` rebuilds the optax state on the JAX side.
    """
    names = [("coarse", state.coarse)]
    if state.fine is not None:
        names.append(("fine", state.fine))
    params = params_to_jax({n: m.state_dict() for n, m in names})
    mu, nu = {}, {}
    for n, m in names:
        m_sd, v_sd = {}, {}
        for key, p in m.named_parameters():
            st = state.optimizer.state.get(p, {})
            m_sd[key] = st.get("exp_avg", torch.zeros_like(p))
            v_sd[key] = st.get("exp_avg_sq", torch.zeros_like(p))
        mu.update(params_to_jax({n: m_sd}))
        nu.update(params_to_jax({n: v_sd}))
    # one update advances every parameter: optax's count is the step
    count = np.asarray(state.step, np.int32)
    return params, ({"count": count, "mu": mu, "nu": nu}, {"count": count}), count


# ---- the SD stack: flax module names → the port's diffusers names ----
# (the inverse of gbnerf_tpu/guidance/weights.py's rules, written here: that
# module imports JAX)
_SD_RULES = [
    (r"\b(down|up)_(\d+)_(resnets|attentions)_(\d+)\b", r"\1_blocks.\2.\3.\4"),
    (r"\bdown_(\d+)_downsamplers_0\b", r"down_blocks.\1.downsamplers.0"),
    (r"\bup_(\d+)_upsamplers_0\b", r"up_blocks.\1.upsamplers.0"),
    (r"\bmid_(resnets|attentions)_(\d+)\b", r"mid_block.\1.\2"),
    (r"\btransformer_blocks_(\d+)\b", r"transformer_blocks.\1"),
    (r"\bto_out_0\b", "to_out.0"),
    (r"\bnet_(\d+)\b", r"net.\1"),
]
_TEXT_RULES = [
    (r"^token_embedding\.embedding$",
     "text_model.embeddings.token_embedding.weight"),
    (r"^position_embedding$", "text_model.embeddings.position_embedding.weight"),
    (r"^layers_(\d+)\.(q_proj|k_proj|v_proj|out_proj)\.",
     r"text_model.encoder.layers.\1.self_attn.\2."),
    (r"^layers_(\d+)\.(fc1|fc2)\.", r"text_model.encoder.layers.\1.mlp.\2."),
    (r"^layers_(\d+)\.", r"text_model.encoder.layers.\1."),
    (r"^final_layer_norm\.", "text_model.final_layer_norm."),
]


def _flatten(tree: Mapping, prefix: str = ""):
    for name, v in tree.items():
        key = f"{prefix}{name}"
        if isinstance(v, Mapping):
            yield from _flatten(v, key + ".")
        else:
            yield key, np.asarray(v)


def flax_to_state_dict(tree: Mapping, rules=_SD_RULES
                       ) -> Dict[str, torch.Tensor]:
    """A flax param tree (numpy leaves) → a torch state dict: module names
    by ``rules``; Conv ``kernel`` [kh, kw, in, out] → ``weight`` [out, in,
    kh, kw], Dense ``kernel`` [in, out] → ``weight`` [out, in], norm
    ``scale`` → ``weight``, Embed ``embedding`` → ``weight`` (by rule)."""
    out = {}
    for key, a in _flatten(tree):
        if key.endswith(".kernel"):
            a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
        out[state_dict_key(key, rules)] = torch.from_numpy(
            np.array(a, np.float32, order="C"))
    return out


def state_dict_key(key: str, rules=_SD_RULES) -> str:
    """A flax path joined by "." → the port's parameter name: module names
    by ``rules``, ``kernel`` and ``scale`` → ``weight``."""
    for pat, rep in rules:
        key = re.sub(pat, rep, key)
    head, _, kind = key.rpartition(".")
    if kind in ("kernel", "scale"):
        kind = "weight"
    return f"{head}.{kind}" if head else kind


def tp_names_from_jax(specs: Mapping, prefix: str = "") -> set:
    """The leaves that gbnerf_tpu/parallel/tp.py::tp_param_specs shards (a
    PartitionSpec other than P()) → the port's names of those parameters,
    which parallel/tp.py::tp_param_specs must shard alike."""
    out = set()
    for name, v in specs.items():
        if isinstance(v, Mapping):
            out |= tp_names_from_jax(v, f"{prefix}{name}.")
        elif any(a is not None for a in v):
            out.add(state_dict_key(prefix + name))
    return out


# the inverse rules: the port's diffusers / transformers names → flax's
_SD_RULES_INV = [
    (r"\b(down|up)_blocks\.(\d+)\.(resnets|attentions)\.(\d+)\b",
     r"\1_\2_\3_\4"),
    (r"\bdown_blocks\.(\d+)\.downsamplers\.0\b", r"down_\1_downsamplers_0"),
    (r"\bup_blocks\.(\d+)\.upsamplers\.0\b", r"up_\1_upsamplers_0"),
    (r"\bmid_block\.(resnets|attentions)\.(\d+)\b", r"mid_\1_\2"),
    (r"\btransformer_blocks\.(\d+)\b", r"transformer_blocks_\1"),
    (r"\bto_out\.0\b", "to_out_0"),
    (r"\bnet\.(\d+)\b", r"net_\1"),
]
_TEXT_RULES_INV = [
    (r"^text_model\.embeddings\.token_embedding\.weight$",
     "token_embedding.embedding"),
    (r"^text_model\.embeddings\.position_embedding\.weight$",
     "position_embedding"),
    (r"^text_model\.encoder\.layers\.(\d+)\.(self_attn|mlp)\.", r"layers_\1."),
    (r"^text_model\.encoder\.layers\.(\d+)\.", r"layers_\1."),
    (r"^text_model\.final_layer_norm\.", "final_layer_norm."),
]


def flax_key(key: str, ndim: int, rules=_SD_RULES_INV) -> str:
    """A port parameter's name and rank → its flax path joined by ".": the
    module names by ``rules``, then ``weight`` → ``kernel`` (a Conv or
    Dense weight, rank 4 or 2) or ``scale`` (a norm's, rank 1); a name the
    rules rewrite whole (the text embeddings) keeps its leaf."""
    new = key
    for pat, rep in rules:
        new = re.sub(pat, rep, new)
    head, _, kind = new.rpartition(".")
    if kind != "weight":
        return new
    return f"{head}.{'scale' if ndim == 1 else 'kernel'}"


def state_dict_to_flax(sd: Mapping, rules=_SD_RULES_INV) -> Dict:
    """The inverse of ``flax_to_state_dict``: a torch state dict → a
    nested flax param tree of f32 numpy arrays (``weight`` [out, in, kh,
    kw] → ``kernel`` [kh, kw, in, out], [out, in] → [in, out], a norm's
    ``weight`` → ``scale``)."""
    tree: Dict = {}
    for key, v in sd.items():
        a = v.detach().float().cpu().numpy()
        path = flax_key(key, a.ndim, rules)
        if path.endswith(".kernel"):
            a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
        node = tree
        parts = path.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.ascontiguousarray(a)
    return tree


def sd_params_from_jax(unet_tree: Mapping, vae_tree: Mapping,
                       text_tree: Mapping):
    """The JAX package's SD param trees (UNet, VAE, CLIP text) → the state
    dicts of the port's UNet2DCondition, AutoencoderKL and
    CLIPTextEncoder, in that order."""
    return (flax_to_state_dict(unet_tree), flax_to_state_dict(vae_tree),
            flax_to_state_dict(text_tree, _TEXT_RULES))


def sd_params_to_jax(unet: nn.Module, vae: nn.Module, text: nn.Module):
    """The inverse of ``sd_params_from_jax``: the port's three modules →
    the JAX package's flax trees (numpy), in that order."""
    return (state_dict_to_flax(unet.state_dict()),
            state_dict_to_flax(vae.state_dict()),
            state_dict_to_flax(text.state_dict(), _TEXT_RULES_INV))


_CLIP_VISION_RULES = [
    (r"^layers_(\d+)\.(q_proj|k_proj|v_proj|out_proj)\.",
     r"layers.\1.self_attn.\2."),
    (r"^layers_(\d+)\.(fc1|fc2)\.", r"layers.\1.mlp.\2."),
    (r"^layers_(\d+)\.", r"layers.\1."),
]


def clip_vision_params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's CLIP vision tower (guidance/clip_guidance.py
    there) → the state dict of the port's ``CLIPVisionEncoder``: the
    layers as the text tower's (``self_attn``/``mlp`` submodules), the
    patch Conv's HWIO kernel as OIHW, the Dense kernels transposed."""
    return flax_to_state_dict(tree, _CLIP_VISION_RULES)


def lpips_params_from_jax(tree: Mapping):
    """LPIPS weights in the JAX package's layout (utils/lpips.py there, or
    the npz of the port's tools/convert_vgg.py through ``load_vgg16_npz``)
    → (the port's ``VGG16Features`` state dict, the five ``lin_k`` stage
    vectors or None).
    Conv kernels go from flax's HWIO to torch's OIHW."""
    sd, lins = {}, {}
    for name, v in tree.items():
        if isinstance(v, Mapping):                       # conv_{i}
            sd[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(
                np.asarray(v["kernel"], np.float32).transpose(3, 2, 0, 1)))
            sd[f"{name}.bias"] = torch.from_numpy(
                np.array(v["bias"], np.float32))
        else:                                            # lin_{k}
            lins[name] = torch.from_numpy(np.array(v, np.float32))
    stages = [lins.get(f"lin_{k}") for k in range(5)]
    return sd, (stages if all(l is not None for l in stages) else None)
