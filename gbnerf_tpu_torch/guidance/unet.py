"""UNet2DCondition — Stable Diffusion v1.x and SDXL (inpainting: 9 input
channels).

Port of gbnerf_tpu/guidance/unet.py. The submodules carry diffusers' names
(``down_blocks.0.resnets.1.conv1``, ``mid_block.attentions.0``,
``up_blocks.2.upsamplers.0.conv``, ``add_embedding.linear_1``, …).
``forward`` takes and returns the JAX package's NHWC layout and computes
in NCHW inside, in the modules' dtype (bf16 on the card); it returns f32,
as the JAX UNet does.

``UNetConfig.sdxl_inpaint()`` is diffusers' SDXL-inpainting UNet
(stable-diffusion-xl-1.0-inpainting-0.1's unet/config.json): three levels
of 320/640/1280, the first without attention, transformer depths [1, 2,
10] (the mid block 10 deep), heads [5, 10, 20] of 64, Linear projections,
cross width 2048, and the "text_time" added embedding: the six size and
crop ids each embedded sinusoidally to 256, appended to the pooled text
embedding (1280 + 1536 = 2816), through ``add_embedding`` and added to the
time embedding. It has no JAX twin, so it takes diffusers' numerics
(LayerNorm ε 1e-5, exact GELU) where the SD1.x UNet keeps the JAX
package's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import (LAYER_NORM_EPS, Downsample2D, ResnetBlock2D,
                     TimestepEmbedding, Transformer2D, Upsample2D,
                     group_norm, timestep_embedding)

PerLevel = Union[int, Tuple[int, ...]]


@dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 9                 # 4 for txt2img, 9 for inpainting
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    # heads (diffusers names this "head dim"), one for all levels or one a
    # level; the mid block takes the last level's
    attention_head_dim: PerLevel = 8
    cross_attention_dim: int = 768
    # down block i has cross-attention unless it's the last; the up blocks
    # mirror them (diffusers' up_block_types, in SD1.x and SDXL alike)
    down_types: Tuple[str, ...] = ("CrossAttnDownBlock2D",) * 3 + ("DownBlock2D",)
    # blocks a transformer, one for all levels or one a level
    transformer_layers_per_block: PerLevel = 1
    use_linear_projection: bool = False
    # "text_time" (SDXL): pooled text + sinusoidal size/crop ids → add_embedding
    addition_embed_type: Optional[str] = None
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 2816
    layer_norm_eps: float = LAYER_NORM_EPS
    gelu_approximate: str = "tanh"

    def per_level(self, value: PerLevel) -> Tuple[int, ...]:
        n = len(self.block_out_channels)
        return (value,) * n if isinstance(value, int) else tuple(value)

    def has_attention(self) -> Tuple[bool, ...]:
        """Whether each level's blocks have cross-attention."""
        return tuple(t == "CrossAttnDownBlock2D" for t in self.down_types)

    @staticmethod
    def sd15_inpaint() -> "UNetConfig":
        return UNetConfig(in_channels=9)

    @staticmethod
    def sd15() -> "UNetConfig":
        return UNetConfig(in_channels=4)

    @staticmethod
    def tiny(in_channels: int = 9) -> "UNetConfig":
        """Small config for tests (same topology, tiny widths)."""
        return UNetConfig(in_channels=in_channels,
                          block_out_channels=(32, 64, 64, 64),
                          attention_head_dim=2, cross_attention_dim=32)

    @staticmethod
    def sdxl_inpaint() -> "UNetConfig":
        """diffusers/stable-diffusion-xl-1.0-inpainting-0.1's UNet."""
        return UNetConfig(
            in_channels=9, block_out_channels=(320, 640, 1280),
            attention_head_dim=(5, 10, 20), cross_attention_dim=2048,
            down_types=("DownBlock2D", "CrossAttnDownBlock2D",
                        "CrossAttnDownBlock2D"),
            transformer_layers_per_block=(1, 2, 10),
            use_linear_projection=True, addition_embed_type="text_time",
            addition_time_embed_dim=256,
            projection_class_embeddings_input_dim=2816,
            layer_norm_eps=1e-5, gelu_approximate="none")

    @staticmethod
    def sdxl_tiny() -> "UNetConfig":
        """The SDXL topology at test widths: three levels, the first
        without attention, depths [1, 2, 3], heads by level at one head
        width (8), the text-time embedding over a pooled width of 16; two
        and three channels a GroupNorm group at the attention levels, so
        that the time embedding's add is not normalised away."""
        return UNetConfig(
            in_channels=9, block_out_channels=(32, 64, 96),
            attention_head_dim=(4, 8, 12), cross_attention_dim=40,
            down_types=("DownBlock2D", "CrossAttnDownBlock2D",
                        "CrossAttnDownBlock2D"),
            transformer_layers_per_block=(1, 2, 3),
            use_linear_projection=True, addition_embed_type="text_time",
            addition_time_embed_dim=8,
            projection_class_embeddings_input_dim=16 + 6 * 8,
            layer_norm_eps=1e-5, gelu_approximate="none")


class _Block(nn.Module):
    """A down, mid or up block: diffusers' ``resnets``, ``attentions``,
    ``downsamplers`` / ``upsamplers`` lists (empty ones hold no keys)."""

    def __init__(self):
        super().__init__()
        self.resnets = nn.ModuleList()
        self.attentions = nn.ModuleList()


class UNet2DCondition(nn.Module):
    def __init__(self, config: UNetConfig = UNetConfig()):
        super().__init__()
        self.config = cfg = config
        ch0 = cfg.block_out_channels[0]
        temb = ch0 * 4
        cross = cfg.cross_attention_dim
        heads = cfg.per_level(cfg.attention_head_dim)
        depth = cfg.per_level(cfg.transformer_layers_per_block)
        n_blocks = len(cfg.block_out_channels)

        def transformer(c: int, level: int) -> Transformer2D:
            # diffusers' "attention_head_dim" is the head count
            return Transformer2D(c, heads[level], c // heads[level], cross,
                                 depth[level],
                                 linear=cfg.use_linear_projection,
                                 eps=cfg.layer_norm_eps,
                                 approximate=cfg.gelu_approximate)

        self.time_embedding = TimestepEmbedding(ch0, temb)
        if cfg.addition_embed_type == "text_time":
            self.add_embedding = TimestepEmbedding(
                cfg.projection_class_embeddings_input_dim, temb)
        elif cfg.addition_embed_type is not None:
            raise ValueError(f"addition_embed_type "
                             f"{cfg.addition_embed_type!r} is not built")
        self.conv_in = nn.Conv2d(cfg.in_channels, ch0, 3, padding=1)

        self.down_blocks = nn.ModuleList()
        skips, h = [ch0], ch0
        for i, (c, has_attn) in enumerate(zip(cfg.block_out_channels,
                                              cfg.has_attention())):
            blk = _Block()
            for _ in range(cfg.layers_per_block):
                blk.resnets.append(ResnetBlock2D(h, c, temb))
                h = c
                if has_attn:
                    blk.attentions.append(transformer(c, i))
                skips.append(c)
            if i < n_blocks - 1:
                # the UNet's down blocks pad symmetrically (only the VAE
                # encoder pads asymmetrically)
                blk.downsamplers = nn.ModuleList(
                    [Downsample2D(c, c, asymmetric=False)])
                skips.append(c)
            self.down_blocks.append(blk)

        cm = cfg.block_out_channels[-1]
        self.mid_block = _Block()
        self.mid_block.resnets.append(ResnetBlock2D(cm, cm, temb))
        self.mid_block.attentions.append(transformer(cm, n_blocks - 1))
        self.mid_block.resnets.append(ResnetBlock2D(cm, cm, temb))

        self.up_blocks = nn.ModuleList()
        for i, (c, has_attn) in enumerate(zip(
                reversed(cfg.block_out_channels),
                reversed(cfg.has_attention()))):
            blk = _Block()
            for _ in range(cfg.layers_per_block + 1):
                blk.resnets.append(ResnetBlock2D(h + skips.pop(), c, temb))
                h = c
                if has_attn:
                    blk.attentions.append(transformer(c, n_blocks - 1 - i))
            if i < n_blocks - 1:
                blk.upsamplers = nn.ModuleList([Upsample2D(c, c)])
            self.up_blocks.append(blk)

        self.conv_norm_out = group_norm(ch0)
        self.conv_out = nn.Conv2d(ch0, cfg.out_channels, 3, padding=1)

    def forward(self, sample, timesteps, encoder_hidden_states,
                added_cond: Optional[dict] = None):
        """sample: [B, H, W, C_in]; timesteps: a number or [B];
        encoder_hidden_states: [B, L, cross_dim]; added_cond (the
        "text_time" UNet's, diffusers' added_cond_kwargs): {"text_embeds":
        the pooled text embedding [B, P], "time_ids": [B, 6]} → ε [B, H,
        W, 4] f32."""
        cfg = self.config
        dtype = self.conv_in.weight.dtype
        dev = sample.device
        x = sample.permute(0, 3, 1, 2).to(dtype)
        ctx = encoder_hidden_states.to(dtype)
        t = torch.as_tensor(timesteps, dtype=torch.float32, device=dev)
        t = t.expand(sample.shape[0])
        temb = self.time_embedding(
            timestep_embedding(t, cfg.block_out_channels[0]).to(dtype))
        if cfg.addition_embed_type == "text_time":
            if added_cond is None:
                raise ValueError("this UNet takes added_cond (text_embeds, "
                                 "time_ids): the pooled prompt and the "
                                 "size and crop ids")
            ids = added_cond["time_ids"].float()
            ids_emb = timestep_embedding(
                ids.reshape(-1), cfg.addition_time_embed_dim
            ).reshape(ids.shape[0], -1)
            add = torch.cat([added_cond["text_embeds"].float(), ids_emb],
                            dim=-1)
            temb = temb + self.add_embedding(add.to(dtype))

        h = self.conv_in(x)
        skips = [h]
        for blk in self.down_blocks:
            for j, res in enumerate(blk.resnets):
                h = res(h, temb)
                if len(blk.attentions):
                    h = blk.attentions[j](h, ctx)
                skips.append(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h)
                skips.append(h)

        mid = self.mid_block
        h = mid.resnets[0](h, temb)
        h = mid.attentions[0](h, ctx)
        h = mid.resnets[1](h, temb)

        for blk in self.up_blocks:
            for j, res in enumerate(blk.resnets):
                h = res(torch.cat([h, skips.pop()], dim=1), temb)
                if len(blk.attentions):
                    h = blk.attentions[j](h, ctx)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h)

        h = self.conv_out(F.silu(self.conv_norm_out(h)))
        return h.permute(0, 2, 3, 1).float()
