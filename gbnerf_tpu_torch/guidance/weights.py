"""Load a local diffusers-layout Stable Diffusion checkpoint into the
port's modules.

Port of gbnerf_tpu/guidance/weights.py::load_sd_weights. The layout:

    <dir>/unet/diffusion_pytorch_model.{safetensors,bin}
    <dir>/vae/diffusion_pytorch_model.{safetensors,bin}
    <dir>/text_encoder/model.{safetensors,bin}
    <dir>/text_encoder_2/model.{safetensors,bin}   (SDXL)
    <dir>/tokenizer/...  (SDXL also tokenizer_2/)

The port's modules carry diffusers' and transformers' names, so a state
dict loads with ``load_state_dict``; the JAX package's key rules and
layout transposes are not needed (SDXL's ``add_embedding.*``, its Linear
``proj_in``/``proj_out`` and its second tower's ``text_projection`` load
by name too). Two renames remain: the original SD1.x
VAE dumps name the mid-block attention ``query``/``key``/``value``/
``proj_attn`` (re-exports use ``to_q``/``to_k``/``to_v``/``to_out.0``), and
transformers' ``position_ids`` buffer is not a parameter. ``.safetensors``
is read by ``read_safetensors`` below (the machine with the card has no
safetensors package) and written by ``write_safetensors``, ``.bin`` read by
``torch.load(weights_only=True)``.

``merge_lora_state_dict`` merges a PEFT-LoRA checkpoint (``lora_dir``, the
config's ``model_path``) into the UNet's state dict before it loads: W ←
W + (α/r)·B@A, summed in f32. ``save_prior_ckpt`` / ``load_prior_ckpt``
write and read a self-trained prior (tools/train_tiny_prior.py) in the JAX
package's file format: flax msgpack (utils/msgpack.py) of ``{unet, vae,
embeds_rgb, embeds_normal}`` in the flax trees' names and layouts
(convert.state_dict_to_flax), so one prior file serves both packages.
"""
from __future__ import annotations

import json
import os
import re
import struct
from typing import Dict, Optional

import torch
from torch import nn

from .. import convert
from ..utils import msgpack

_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}

_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}

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


def write_safetensors(path: str, tensors: Dict[str, torch.Tensor]) -> None:
    """{name: tensor} → a .safetensors file (the format of
    ``read_safetensors``; names in sorted order, as the safetensors
    package writes them, each buffer little-endian and C-ordered)."""
    header, blobs, off = {}, [], 0
    for name in sorted(tensors):
        t = tensors[name].detach().cpu().contiguous()
        raw = (t.view(torch.int16).numpy().tobytes()
               if t.dtype == torch.bfloat16 else t.numpy().tobytes())
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    h = json.dumps(header, separators=(",", ":")).encode()
    h += b" " * (-len(h) % 8)            # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(h)) + h)
        for b in blobs:
            f.write(b)


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
                    lora_rank: int = 32, strict: bool = False,
                    text_2: Optional[nn.Module] = None) -> None:
    """Load a local diffusers checkpoint dir into the modules in place
    (values cast to each module's dtype); a missing subdir leaves its
    module as it is. text_2: SDXL's second tower, from text_encoder_2/.
    lora_dir: a PEFT-LoRA checkpoint dir merged into the UNet's weights
    first. strict: raise on any unmatched key or missing parameter."""
    sd = load_state_dict(os.path.join(weights_dir, "unet",
                                      "diffusion_pytorch_model"))
    if sd is not None:
        if lora_dir:
            sd = merge_lora_state_dict(sd, lora_dir, rank=lora_rank)
        _load(unet, sd, "unet", strict)
    sd = load_state_dict(os.path.join(weights_dir, "vae",
                                      "diffusion_pytorch_model"))
    if sd is not None:
        _load(vae, _vae_keys(sd), "vae", strict)
    towers = [("text_encoder", text, "text")]
    if text_2 is not None:
        towers.append(("text_encoder_2", text_2, "text_2"))
    for sub, module, name in towers:
        sd = load_state_dict(os.path.join(weights_dir, sub, "model"))
        if sd is not None:
            sd = {k: v for k, v in sd.items()
                  if not k.endswith("position_ids")}
            _load(module, sd, name, strict)


def merge_lora_state_dict(base_sd: Dict[str, torch.Tensor], lora_dir: str,
                          *, rank: int = 32, alpha: Optional[float] = None
                          ) -> Dict[str, torch.Tensor]:
    """Merge a PEFT-LoRA checkpoint (``adapter_model`` or
    ``pytorch_lora_weights``, .safetensors or .bin, under lora_dir) into a
    UNet state dict: W ← W + (α/r)·B@A, summed in f32 and cast back to W's
    dtype; a conv's delta is reshaped to [O, I, kh, kw]. PEFT's and
    diffusers' keys (``base_model.model.``, ``unet.`` prefixes; lora_A/B
    or lora_down/up) name the base weight once stripped."""
    lora = None
    for name in ("adapter_model", "pytorch_lora_weights"):
        lora = load_state_dict(os.path.join(lora_dir, name))
        if lora is not None:
            break
    if lora is None:
        print(f"[weights] no LoRA checkpoint found under {lora_dir}")
        return base_sd
    scale = (alpha or rank) / rank
    merged = dict(base_sd)
    n = 0
    for key, a in lora.items():
        if "lora_A" not in key and "lora_down" not in key:
            continue
        b_key = key.replace("lora_A", "lora_B").replace("lora_down",
                                                        "lora_up")
        base_key = (key.replace("base_model.model.", "")
                    .replace(".lora_A.weight", ".weight")
                    .replace(".lora_down.weight", ".weight"))
        if base_key.startswith("unet."):
            base_key = base_key[len("unet."):]
        if b_key not in lora or base_key not in merged:
            continue
        A, B, W = a.float(), lora[b_key].float(), merged[base_key]
        delta = (B.reshape(B.shape[0], -1) @ A.reshape(A.shape[0], -1))
        merged[base_key] = (W.float() + scale * delta.reshape(W.shape)
                            ).to(W.dtype)
        n += 1
    print(f"[weights] merged {n} LoRA deltas (scale {scale})")
    return merged


def save_prior_ckpt(path: str, mods) -> None:
    """Write a self-trained prior (tools/train_tiny_prior.py): the UNet and
    VAE as flax trees and the prompt embeddings the trainer's text tower
    computed (they ship in the file, so a consumer need not rebuild the
    trainer's text tower), as flax msgpack."""
    payload = {
        "unet": convert.state_dict_to_flax(mods.unet.state_dict()),
        "vae": convert.state_dict_to_flax(mods.vae.state_dict()),
        "embeds_rgb": mods.embeds_rgb.detach().float().cpu().numpy(),
        "embeds_normal": mods.embeds_normal.detach().float().cpu().numpy()}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    msgpack.save(path, payload)


def load_prior_ckpt(path: str, mods):
    """Load a prior file over the stack of ``mods`` in place (the UNet and
    VAE must have the trainer's configuration: a missing, extra or
    reshaped leaf is refused) and set its prompt embeddings. Returns
    ``mods``."""
    tree = msgpack.load(path)
    missing = {"unet", "vae", "embeds_rgb", "embeds_normal"} - set(tree)
    if missing:
        raise ValueError(f"{path}: not a prior checkpoint (no "
                         f"{sorted(missing)})")
    for name, module in (("unet", mods.unet), ("vae", mods.vae)):
        try:
            module.load_state_dict(convert.flax_to_state_dict(tree[name]))
        except RuntimeError as e:
            raise ValueError(
                f"{path}: the {name} does not fit the stack it is loaded "
                "into (build the stack with the trainer's configuration "
                f"and latent size): {str(e)[:300]}") from None
    dev = mods.embeds_rgb.device
    mods.embeds_rgb = torch.as_tensor(tree["embeds_rgb"], dtype=torch.float32,
                                      device=dev)
    mods.embeds_normal = torch.as_tensor(tree["embeds_normal"],
                                         dtype=torch.float32, device=dev)
    return mods
