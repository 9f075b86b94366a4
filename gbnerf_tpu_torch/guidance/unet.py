"""UNet2DCondition — Stable Diffusion v1.x (inpainting: 9 input channels).

Port of gbnerf_tpu/guidance/unet.py. The submodules carry diffusers' names
(``down_blocks.0.resnets.1.conv1``, ``mid_block.attentions.0``,
``up_blocks.2.upsamplers.0.conv``, …). ``forward`` takes and returns the
JAX package's NHWC layout and computes in NCHW inside, in the modules'
dtype (bf16 on the card); it returns f32, as the JAX UNet does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import (Downsample2D, ResnetBlock2D, TimestepEmbedding,
                     Transformer2D, Upsample2D, group_norm,
                     timestep_embedding)


@dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 9                 # 4 for txt2img, 9 for inpainting
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    attention_head_dim: int = 8          # heads (SD1.x names this "head dim")
    cross_attention_dim: int = 768
    # down block i has cross-attention unless it's the last
    down_types: Tuple[str, ...] = ("CrossAttnDownBlock2D",) * 3 + ("DownBlock2D",)

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
        heads, cross = cfg.attention_head_dim, cfg.cross_attention_dim
        n_blocks = len(cfg.block_out_channels)
        self.time_embedding = TimestepEmbedding(ch0, temb)
        self.conv_in = nn.Conv2d(cfg.in_channels, ch0, 3, padding=1)

        self.down_blocks = nn.ModuleList()
        skips, h = [ch0], ch0
        for i, c in enumerate(cfg.block_out_channels):
            blk = _Block()
            has_attn = cfg.down_types[i] == "CrossAttnDownBlock2D"
            for _ in range(cfg.layers_per_block):
                blk.resnets.append(ResnetBlock2D(h, c, temb))
                h = c
                if has_attn:
                    # diffusers' SD1.x "attention_head_dim" is the head count
                    blk.attentions.append(Transformer2D(c, heads, c // heads,
                                                        cross))
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
        self.mid_block.attentions.append(Transformer2D(cm, heads, cm // heads,
                                                       cross))
        self.mid_block.resnets.append(ResnetBlock2D(cm, cm, temb))

        self.up_blocks = nn.ModuleList()
        up_types = list(reversed(cfg.down_types))
        for i, c in enumerate(reversed(cfg.block_out_channels)):
            blk = _Block()
            has_attn = up_types[i] == "CrossAttnDownBlock2D"
            for _ in range(cfg.layers_per_block + 1):
                blk.resnets.append(ResnetBlock2D(h + skips.pop(), c, temb))
                h = c
                if has_attn:
                    blk.attentions.append(Transformer2D(c, heads, c // heads,
                                                        cross))
            if i < n_blocks - 1:
                blk.upsamplers = nn.ModuleList([Upsample2D(c, c)])
            self.up_blocks.append(blk)

        self.conv_norm_out = group_norm(ch0)
        self.conv_out = nn.Conv2d(ch0, cfg.out_channels, 3, padding=1)

    def forward(self, sample, timesteps, encoder_hidden_states):
        """sample: [B, H, W, C_in]; timesteps: a number or [B];
        encoder_hidden_states: [B, L, cross_dim] → ε [B, H, W, 4] f32."""
        dtype = self.conv_in.weight.dtype
        dev = sample.device
        x = sample.permute(0, 3, 1, 2).to(dtype)
        ctx = encoder_hidden_states.to(dtype)
        t = torch.as_tensor(timesteps, dtype=torch.float32, device=dev)
        t = t.expand(sample.shape[0])
        temb = self.time_embedding(
            timestep_embedding(t, self.config.block_out_channels[0]).to(dtype))

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
