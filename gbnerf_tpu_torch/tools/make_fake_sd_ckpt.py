"""Write a diffusers-layout SD1.x-inpainting checkpoint directory with the
real torch key names (the diffusers UNet2DConditionModel / AutoencoderKL
and transformers CLIPTextModel state-dict layouts) and config-derived
shapes, filled with seeded random values.

The twin of tools/make_fake_sd_ckpt.py: the same CLI, key names, shapes
and values (``np.random.default_rng(seed)`` normals × 0.02 in f32, drawn
in the same key order; the text encoder from seed + 1), written through
``guidance/weights.py::write_safetensors``, so it needs no safetensors
package. No real SD weights are in the repository: this checkpoint lets
``load_sd_weights(strict=True)`` (and ``tools/check_weights.py``) prove
that every key maps and every parameter is covered, at the tiny widths
or at the full SD1.5-inpainting widths (≈ 1.07 G values, ≈ 4.3 GB on
disk), before a real checkpoint arrives.

    python -m gbnerf_tpu_torch.tools.make_fake_sd_ckpt OUT --tiny
    python -m gbnerf_tpu_torch.tools.make_fake_sd_ckpt OUT     # SD1.5 widths
    python -m gbnerf_tpu_torch.tools.make_fake_sd_ckpt OUT --vae_legacy_attn
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, Tuple

import numpy as np
import torch


def _resnet(prefix: str, cin: int, cout: int, temb: int | None,
            sd: Dict[str, Tuple[int, ...]]):
    sd[f"{prefix}.norm1.weight"] = (cin,)
    sd[f"{prefix}.norm1.bias"] = (cin,)
    sd[f"{prefix}.conv1.weight"] = (cout, cin, 3, 3)
    sd[f"{prefix}.conv1.bias"] = (cout,)
    if temb:
        sd[f"{prefix}.time_emb_proj.weight"] = (cout, temb)
        sd[f"{prefix}.time_emb_proj.bias"] = (cout,)
    sd[f"{prefix}.norm2.weight"] = (cout,)
    sd[f"{prefix}.norm2.bias"] = (cout,)
    sd[f"{prefix}.conv2.weight"] = (cout, cout, 3, 3)
    sd[f"{prefix}.conv2.bias"] = (cout,)
    if cin != cout:
        sd[f"{prefix}.conv_shortcut.weight"] = (cout, cin, 1, 1)
        sd[f"{prefix}.conv_shortcut.bias"] = (cout,)


def _transformer(prefix: str, c: int, cross: int,
                 sd: Dict[str, Tuple[int, ...]]):
    sd[f"{prefix}.norm.weight"] = (c,)
    sd[f"{prefix}.norm.bias"] = (c,)
    sd[f"{prefix}.proj_in.weight"] = (c, c, 1, 1)
    sd[f"{prefix}.proj_in.bias"] = (c,)
    tb = f"{prefix}.transformer_blocks.0"
    for n in ("norm1", "norm2", "norm3"):
        sd[f"{tb}.{n}.weight"] = (c,)
        sd[f"{tb}.{n}.bias"] = (c,)
    for attn, kdim in (("attn1", c), ("attn2", cross)):
        sd[f"{tb}.{attn}.to_q.weight"] = (c, c)
        sd[f"{tb}.{attn}.to_k.weight"] = (c, kdim)
        sd[f"{tb}.{attn}.to_v.weight"] = (c, kdim)
        sd[f"{tb}.{attn}.to_out.0.weight"] = (c, c)
        sd[f"{tb}.{attn}.to_out.0.bias"] = (c,)
    sd[f"{tb}.ff.net.0.proj.weight"] = (8 * c, c)
    sd[f"{tb}.ff.net.0.proj.bias"] = (8 * c,)
    sd[f"{tb}.ff.net.2.weight"] = (c, 4 * c)
    sd[f"{tb}.ff.net.2.bias"] = (c,)
    sd[f"{prefix}.proj_out.weight"] = (c, c, 1, 1)
    sd[f"{prefix}.proj_out.bias"] = (c,)


def unet_state_shapes(blocks=(320, 640, 1280, 1280), layers=2, cross=768,
                      in_ch=9, out_ch=4) -> Dict[str, Tuple[int, ...]]:
    sd: Dict[str, Tuple[int, ...]] = {}
    c0 = blocks[0]
    temb = 4 * c0
    sd["conv_in.weight"] = (c0, in_ch, 3, 3)
    sd["conv_in.bias"] = (c0,)
    sd["time_embedding.linear_1.weight"] = (temb, c0)
    sd["time_embedding.linear_1.bias"] = (temb,)
    sd["time_embedding.linear_2.weight"] = (temb, temb)
    sd["time_embedding.linear_2.bias"] = (temb,)

    # down path + skip-channel bookkeeping (mirrors the module exactly:
    # skips = [conv_in] + per-resnet + per-downsampler outputs)
    skips = [c0]
    for i, c in enumerate(blocks):
        cin = blocks[i - 1] if i > 0 else c0
        has_attn = i < len(blocks) - 1
        for j in range(layers):
            _resnet(f"down_blocks.{i}.resnets.{j}", cin if j == 0 else c, c,
                    temb, sd)
            if has_attn:
                _transformer(f"down_blocks.{i}.attentions.{j}", c, cross, sd)
            skips.append(c)
        if i < len(blocks) - 1:
            sd[f"down_blocks.{i}.downsamplers.0.conv.weight"] = (c, c, 3, 3)
            sd[f"down_blocks.{i}.downsamplers.0.conv.bias"] = (c,)
            skips.append(c)

    cm = blocks[-1]
    _resnet("mid_block.resnets.0", cm, cm, temb, sd)
    _transformer("mid_block.attentions.0", cm, cross, sd)
    _resnet("mid_block.resnets.1", cm, cm, temb, sd)

    rev = list(reversed(blocks))
    h = cm
    for i, c in enumerate(rev):
        has_attn = i > 0
        for j in range(layers + 1):
            skip = skips.pop()
            _resnet(f"up_blocks.{i}.resnets.{j}", h + skip, c, temb, sd)
            h = c
            if has_attn:
                _transformer(f"up_blocks.{i}.attentions.{j}", c, cross, sd)
        if i < len(rev) - 1:
            sd[f"up_blocks.{i}.upsamplers.0.conv.weight"] = (c, c, 3, 3)
            sd[f"up_blocks.{i}.upsamplers.0.conv.bias"] = (c,)

    sd["conv_norm_out.weight"] = (c0,)
    sd["conv_norm_out.bias"] = (c0,)
    sd["conv_out.weight"] = (out_ch, c0, 3, 3)
    sd["conv_out.bias"] = (out_ch,)
    return sd


def vae_state_shapes(blocks=(128, 256, 512, 512), layers=2, latent=4,
                     legacy_attn=False) -> Dict[str, Tuple[int, ...]]:
    sd: Dict[str, Tuple[int, ...]] = {}
    c0, cm = blocks[0], blocks[-1]

    def attn(prefix: str, c: int):
        sd[f"{prefix}.group_norm.weight"] = (c,)
        sd[f"{prefix}.group_norm.bias"] = (c,)
        # original SD1.x VAE dumps name these query/key/value/proj_attn;
        # re-exports use to_q/to_k/to_v/to_out.0 — both must convert.
        names = (("query", "key", "value", "proj_attn") if legacy_attn
                 else ("to_q", "to_k", "to_v", "to_out.0"))
        for n in names:
            sd[f"{prefix}.{n}.weight"] = (c, c)
            sd[f"{prefix}.{n}.bias"] = (c,)

    # encoder
    sd["encoder.conv_in.weight"] = (c0, 3, 3, 3)
    sd["encoder.conv_in.bias"] = (c0,)
    for i, c in enumerate(blocks):
        cin = blocks[i - 1] if i > 0 else c0
        for j in range(layers):
            _resnet(f"encoder.down_blocks.{i}.resnets.{j}",
                    cin if j == 0 else c, c, None, sd)
        if i < len(blocks) - 1:
            sd[f"encoder.down_blocks.{i}.downsamplers.0.conv.weight"] = \
                (c, c, 3, 3)
            sd[f"encoder.down_blocks.{i}.downsamplers.0.conv.bias"] = (c,)
    _resnet("encoder.mid_block.resnets.0", cm, cm, None, sd)
    attn("encoder.mid_block.attentions.0", cm)
    _resnet("encoder.mid_block.resnets.1", cm, cm, None, sd)
    sd["encoder.conv_norm_out.weight"] = (cm,)
    sd["encoder.conv_norm_out.bias"] = (cm,)
    sd["encoder.conv_out.weight"] = (2 * latent, cm, 3, 3)
    sd["encoder.conv_out.bias"] = (2 * latent,)

    # decoder
    sd["decoder.conv_in.weight"] = (cm, latent, 3, 3)
    sd["decoder.conv_in.bias"] = (cm,)
    _resnet("decoder.mid_block.resnets.0", cm, cm, None, sd)
    attn("decoder.mid_block.attentions.0", cm)
    _resnet("decoder.mid_block.resnets.1", cm, cm, None, sd)
    h = cm
    rev = list(reversed(blocks))
    for i, c in enumerate(rev):
        for j in range(layers + 1):
            _resnet(f"decoder.up_blocks.{i}.resnets.{j}", h, c, None, sd)
            h = c
        if i < len(rev) - 1:
            sd[f"decoder.up_blocks.{i}.upsamplers.0.conv.weight"] = \
                (c, c, 3, 3)
            sd[f"decoder.up_blocks.{i}.upsamplers.0.conv.bias"] = (c,)
    sd["decoder.conv_norm_out.weight"] = (c0,)
    sd["decoder.conv_norm_out.bias"] = (c0,)
    sd["decoder.conv_out.weight"] = (3, c0, 3, 3)
    sd["decoder.conv_out.bias"] = (3,)

    sd["quant_conv.weight"] = (2 * latent, 2 * latent, 1, 1)
    sd["quant_conv.bias"] = (2 * latent,)
    sd["post_quant_conv.weight"] = (latent, latent, 1, 1)
    sd["post_quant_conv.bias"] = (latent,)
    return sd


def text_state_shapes(vocab=49408, width=768, layers=12, max_len=77,
                      with_position_ids=True) -> Dict[str, Tuple[int, ...]]:
    sd: Dict[str, Tuple[int, ...]] = {}
    sd["text_model.embeddings.token_embedding.weight"] = (vocab, width)
    sd["text_model.embeddings.position_embedding.weight"] = (max_len, width)
    if with_position_ids:
        # non-parameter buffer present in many transformers dumps; the
        # converter must skip it without counting it unmatched
        sd["text_model.embeddings.position_ids"] = (1, max_len)
    for i in range(layers):
        p = f"text_model.encoder.layers.{i}"
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[f"{p}.self_attn.{n}.weight"] = (width, width)
            sd[f"{p}.self_attn.{n}.bias"] = (width,)
        for n in ("layer_norm1", "layer_norm2"):
            sd[f"{p}.{n}.weight"] = (width,)
            sd[f"{p}.{n}.bias"] = (width,)
        sd[f"{p}.mlp.fc1.weight"] = (4 * width, width)
        sd[f"{p}.mlp.fc1.bias"] = (4 * width,)
        sd[f"{p}.mlp.fc2.weight"] = (width, 4 * width)
        sd[f"{p}.mlp.fc2.bias"] = (width,)
    sd["text_model.final_layer_norm.weight"] = (width,)
    sd["text_model.final_layer_norm.bias"] = (width,)
    return sd


def materialize(shapes: Dict[str, Tuple[int, ...]], seed: int
                ) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {k: rng.normal(0, 0.02, v).astype(np.float32)
            for k, v in shapes.items()}


def save_ckpt(outdir: str, *, tiny=False, seed=0, legacy_attn=False):
    from ..guidance.weights import write_safetensors

    if tiny:
        unet = unet_state_shapes(blocks=(32, 64, 64, 64), cross=32)
        vae = vae_state_shapes(blocks=(16, 16, 32, 32), layers=1,
                               legacy_attn=legacy_attn)
        text = text_state_shapes(vocab=49408, width=32, layers=2)
    else:
        unet = unet_state_shapes()
        vae = vae_state_shapes(legacy_attn=legacy_attn)
        text = text_state_shapes()
    files = (("unet", "diffusion_pytorch_model", unet, seed),
             ("vae", "diffusion_pytorch_model", vae, seed),
             ("text_encoder", "model", text, seed + 1))
    for sub, name, shapes, s in files:
        os.makedirs(os.path.join(outdir, sub), exist_ok=True)
        arrays = materialize(shapes, s)
        write_safetensors(os.path.join(outdir, sub, name + ".safetensors"),
                          {k: torch.from_numpy(v) for k, v in arrays.items()})
        del arrays
    n = len(unet) + len(vae) + len(text)
    print(f"wrote fake diffusers ckpt ({n} tensors) to {outdir}")


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("out")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--vae_legacy_attn", action="store_true",
                    help="use the original SD1.x query/key/value VAE "
                         "attention key names")
    args = ap.parse_args(argv)
    save_ckpt(args.out, tiny=args.tiny, seed=args.seed,
              legacy_attn=args.vae_legacy_attn)


if __name__ == "__main__":
    main()
