"""Load a local diffusers-layout Stable Diffusion checkpoint into the
port's modules.

Port of gbnerf_tpu/guidance/weights.py::load_sd_weights. The layout:

    <dir>/unet/diffusion_pytorch_model.{safetensors,bin}
    <dir>/vae/diffusion_pytorch_model.{safetensors,bin}
    <dir>/text_encoder/model.{safetensors,bin}
    <dir>/tokenizer/...

The port's modules carry diffusers' and transformers' names, so a state
dict loads with ``load_state_dict``; the JAX package's key rules and
layout transposes are not needed. Two renames remain: the original SD1.x
VAE dumps name the mid-block attention ``query``/``key``/``value``/
``proj_attn`` (re-exports use ``to_q``/``to_k``/``to_v``/``to_out.0``), and
transformers' ``position_ids`` buffer is not a parameter. ``.safetensors``
is read by ``read_safetensors`` below (the machine with the card has no
safetensors package), ``.bin`` by ``torch.load(weights_only=True)``.

Not ported yet, and refused: the PEFT-LoRA merge (``lora_dir``, the
config's ``model_path``) and the prior checkpoints (``save_prior_ckpt``,
``load_prior_ckpt``).
"""
from __future__ import annotations

import json
import os
import re
import struct
from typing import Dict, Optional

import torch
from torch import nn

_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}

_VAE_LEGACY = [(r"(mid_block\.attentions\.\d+)\.query", r"\1.to_q"),
               (r"(mid_block\.attentions\.\d+)\.key", r"\1.to_k"),
               (r"(mid_block\.attentions\.\d+)\.value", r"\1.to_v"),
               (r"(mid_block\.attentions\.\d+)\.proj_attn", r"\1.to_out.0")]


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A .safetensors file → {name: CPU tensor}.

    The format: an 8-byte little-endian header length, a JSON header of
    {name: {dtype, shape, data_offsets [begin, end)}} (plus an optional
    ``__metadata__``), then the raw little-endian buffers.
    """
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(f.read())
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        if end == begin:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        count = (end - begin) // torch.empty((), dtype=dtype).element_size()
        out[name] = torch.frombuffer(data, dtype=dtype, count=count,
                                     offset=begin).reshape(shape)
    return out


def load_state_dict(path_base: str) -> Optional[Dict[str, torch.Tensor]]:
    """<path_base>.safetensors or <path_base>.bin → state dict, or None."""
    if os.path.exists(path_base + ".safetensors"):
        return read_safetensors(path_base + ".safetensors")
    if os.path.exists(path_base + ".bin"):
        return torch.load(path_base + ".bin", map_location="cpu",
                          weights_only=True)
    return None


def _vae_keys(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    out = {}
    for key, val in sd.items():
        for pat, rep in _VAE_LEGACY:
            key = re.sub(pat, rep, key)
        out[key] = val
    return out


def _load(module: nn.Module, sd: Dict[str, torch.Tensor], name: str,
          strict: bool):
    res = module.load_state_dict(sd, strict=False)
    msg = (f"[weights] {name}: {len(sd) - len(res.unexpected_keys)} tensors "
           f"loaded, {len(res.unexpected_keys)} unmatched, "
           f"{len(res.missing_keys)} parameters not in the checkpoint")
    print(msg)
    if res.unexpected_keys[:5]:
        print(f"[weights]   e.g. {res.unexpected_keys[:5]}")
    if strict and (res.unexpected_keys or res.missing_keys):
        raise ValueError(msg)


def load_sd_weights(weights_dir: str, unet: nn.Module, vae: nn.Module,
                    text: nn.Module, *, lora_dir: Optional[str] = None,
                    strict: bool = False) -> None:
    """Load a local diffusers checkpoint dir into the three modules in
    place (values cast to each module's dtype); a missing subdir leaves its
    module as it is. strict: raise on any unmatched key or missing
    parameter."""
    if lora_dir:
        raise NotImplementedError("the PEFT-LoRA merge (model_path) is not "
                                  "ported yet")
    sd = load_state_dict(os.path.join(weights_dir, "unet",
                                      "diffusion_pytorch_model"))
    if sd is not None:
        _load(unet, sd, "unet", strict)
    sd = load_state_dict(os.path.join(weights_dir, "vae",
                                      "diffusion_pytorch_model"))
    if sd is not None:
        _load(vae, _vae_keys(sd), "vae", strict)
    sd = load_state_dict(os.path.join(weights_dir, "text_encoder", "model"))
    if sd is not None:
        sd = {k: v for k, v in sd.items() if not k.endswith("position_ids")}
        _load(text, sd, "text", strict)


def save_prior_ckpt(path: str, mods) -> None:
    raise NotImplementedError("prior checkpoints (sd_prior_ckpt) are not "
                              "ported yet")


def load_prior_ckpt(path: str, mods):
    raise NotImplementedError("prior checkpoints (sd_prior_ckpt) are not "
                              "ported yet")
