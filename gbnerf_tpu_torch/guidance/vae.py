"""AutoencoderKL (the SD VAE): encoder, decoder, diagonal posterior.

Port of gbnerf_tpu/guidance/vae.py, with diffusers' submodule names
(``encoder.down_blocks.0.resnets.0``, ``encoder.mid_block.attentions.0
.to_q``, ``quant_conv``, …). The public calls take and return the JAX
package's NHWC layout. The guidance path differentiates the encoder (the
SDS gradient flows render → VAE latents); the decoder serves the offline
inpainting pipeline. The latents' scaling factor is the configuration's:
0.18215 (SD1.x), 0.13025 (SDXL's VAE, the same widths).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import self_attention
from .blocks import Downsample2D, ResnetBlock2D, Upsample2D, group_norm

SD_VAE_SCALING = 0.18215
SDXL_VAE_SCALING = 0.13025


@dataclass(frozen=True)
class VAEConfig:
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    latent_channels: int = 4
    scaling_factor: float = SD_VAE_SCALING

    @staticmethod
    def sdxl() -> "VAEConfig":
        return VAEConfig(scaling_factor=SDXL_VAE_SCALING)

    @staticmethod
    def tiny() -> "VAEConfig":
        return VAEConfig(block_out_channels=(16, 16, 32, 32), layers_per_block=1)


class VAEAttention(nn.Module):
    """Single-head spatial self-attention of the VAE mid block (N = H·W,
    D = channels: 4096 × 512 at a 512² image, 16,384 × 512 at 1024²: K7
    on the card)."""

    def __init__(self, channels: int):
        super().__init__()
        self.group_norm = group_norm(channels, eps=1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        y = self_attention(self.to_q(y), self.to_k(y), self.to_v(y),
                           scale=c ** -0.5)
        y = self.to_out[0](y)
        return x + y.reshape(b, h, w, c).permute(0, 3, 1, 2)


class _Block(nn.Module):
    def __init__(self):
        super().__init__()
        self.resnets = nn.ModuleList()


def _mid_block(ch: int) -> nn.Module:
    mid = _Block()
    mid.resnets.append(ResnetBlock2D(ch, ch))
    mid.attentions = nn.ModuleList([VAEAttention(ch)])
    mid.resnets.append(ResnetBlock2D(ch, ch))
    return mid


def _run_mid(mid: nn.Module, h):
    return mid.resnets[1](mid.attentions[0](mid.resnets[0](h)))


class Encoder(nn.Module):
    def __init__(self, config: VAEConfig, in_channels: int = 3):
        super().__init__()
        chs = config.block_out_channels
        self.conv_in = nn.Conv2d(in_channels, chs[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        h = chs[0]
        for i, c in enumerate(chs):
            blk = _Block()
            for _ in range(config.layers_per_block):
                blk.resnets.append(ResnetBlock2D(h, c))
                h = c
            if i < len(chs) - 1:
                blk.downsamplers = nn.ModuleList([Downsample2D(c, c)])
            self.down_blocks.append(blk)
        self.mid_block = _mid_block(chs[-1])
        self.conv_norm_out = group_norm(chs[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(chs[-1], 2 * config.latent_channels, 3,
                                  padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for blk in self.down_blocks:
            for res in blk.resnets:
                h = res(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h)
        h = _run_mid(self.mid_block, h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, config: VAEConfig, out_channels: int = 3):
        super().__init__()
        chs = config.block_out_channels
        h = chs[-1]
        self.conv_in = nn.Conv2d(config.latent_channels, h, 3, padding=1)
        self.mid_block = _mid_block(h)
        self.up_blocks = nn.ModuleList()
        for i, c in enumerate(reversed(chs)):
            blk = _Block()
            for _ in range(config.layers_per_block + 1):
                blk.resnets.append(ResnetBlock2D(h, c))
                h = c
            if i < len(chs) - 1:
                blk.upsamplers = nn.ModuleList([Upsample2D(c, c)])
            self.up_blocks.append(blk)
        self.conv_norm_out = group_norm(chs[0], eps=1e-6)
        self.conv_out = nn.Conv2d(chs[0], out_channels, 3, padding=1)

    def forward(self, z):
        h = _run_mid(self.mid_block, self.conv_in(z))
        for blk in self.up_blocks:
            for res in blk.resnets:
                h = res(h)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class AutoencoderKL(nn.Module):
    def __init__(self, config: VAEConfig = VAEConfig()):
        super().__init__()
        self.config = config
        lc = config.latent_channels
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        self.quant_conv = nn.Conv2d(2 * lc, 2 * lc, 1)
        self.post_quant_conv = nn.Conv2d(lc, lc, 1)

    def encode_moments(self, x):
        """[B, H, W, 3] in [-1, 1] → (mean, logvar), each [B, H/8, W/8, 4],
        in the modules' dtype."""
        x = x.permute(0, 3, 1, 2).to(self.quant_conv.weight.dtype)
        moments = self.quant_conv(self.encoder(x)).permute(0, 2, 3, 1)
        mean, logvar = moments.chunk(2, dim=-1)
        return mean, torch.clamp(logvar, -30.0, 20.0)

    def encode(self, x, eps: Optional[torch.Tensor] = None):
        """Posterior sample mean + σ·eps (the mode when eps is None),
        scaled by the configuration's scaling factor. eps: standard
        normal, the latents' shape (the callers draw it in the modules'
        dtype, the latents' dtype, as the JAX package's encode draws
        ``normal(key, mean.shape, mean.dtype)``: bf16 in the bf16 stack)."""
        mean, logvar = self.encode_moments(x)
        if eps is not None:
            mean = mean + torch.exp(0.5 * logvar) * eps.to(mean.dtype)
        return mean * self.config.scaling_factor

    def decode(self, z):
        """Scaled latents [B, h, w, 4] → image [B, 8h, 8w, 3] in [-1, 1]."""
        z = (z / self.config.scaling_factor).permute(0, 3, 1, 2).to(
            self.post_quant_conv.weight.dtype)
        return self.decoder(self.post_quant_conv(z)).permute(0, 2, 3, 1)

    def forward(self, x, eps: Optional[torch.Tensor] = None):
        return self.decode(self.encode(x, eps))
