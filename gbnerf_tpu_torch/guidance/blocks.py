"""Shared building blocks of the diffusion models (UNet, VAE).

Port of gbnerf_tpu/guidance/blocks.py: ResNet block, spatial transformer
with self- and cross-attention, GEGLU feed-forward, up/down sampling,
sinusoidal time embeddings. The blocks take NCHW tensors, as torch's
convolutions want; the models' public calls keep the JAX package's NHWC.

The submodules carry diffusers' names (``norm1``, ``conv1``,
``time_emb_proj``, ``attn1.to_q``, ``to_out.0``, ``ff.net.0.proj``, …), so
a diffusers state dict loads with ``load_state_dict``
(guidance/weights.py).

Numerics follow the JAX package, where it departs from torch's and
diffusers' defaults (ROADMAP C lists the departures from diffusers):
GroupNorm ε is passed explicitly (1e-5, or 1e-6 in the transformer and the
VAE attention) with the group count clamped for tiny test widths; the
transformer's LayerNorm ε is flax's 1e-6 (torch's default is 1e-5); GEGLU's
GELU is the tanh approximation (flax ``nn.gelu``). Both are arguments: the
SDXL UNet, which has no JAX twin, takes diffusers' 1e-5 and exact GELU
(unet.py). ``Transformer2D`` takes diffusers' ``use_linear_projection``
(Linear ``proj_in``/``proj_out`` on [B, HW, C], SDXL's) and a depth of
blocks.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import self_attention
from ..utils.profiling import SPAN_UNET_TRANSFORMER, annotate

LAYER_NORM_EPS = 1e-6      # flax nn.LayerNorm's default


def group_norm(channels: int, groups: int = 32, *, eps: float = 1e-5
               ) -> nn.GroupNorm:
    """GroupNorm with the group count clamped to divide tiny test channels
    (real SD channels are all multiples of 32)."""
    g = groups if channels % groups == 0 else channels
    return nn.GroupNorm(g, channels, eps=eps)


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding [..., dim] in f32, diffusers'
    convention (flip_sin_to_cos: [cos, sin]; freq_shift 0)."""
    half = dim // 2
    dev = t.device
    log_max = torch.log(torch.tensor(max_period, dtype=torch.float32,
                                     device=dev))
    freqs = torch.exp(-log_max * torch.arange(half, dtype=torch.float32,
                                              device=dev) / half)
    args = t.float()[..., None] * freqs
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class TimestepEmbedding(nn.Module):
    """linear_1 → silu → linear_2 (320 → 1280 for SD1.x)."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, out_dim)
        self.linear_2 = nn.Linear(out_dim, out_dim)

    def forward(self, emb):
        return self.linear_2(F.silu(self.linear_1(emb)))


class ResnetBlock2D(nn.Module):
    """GN→SiLU→Conv + time-emb add + GN→SiLU→Conv, 1×1 shortcut on a
    change of channels."""

    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: Optional[int] = None, *, groups: int = 32,
                 eps: float = 1e-5):
        super().__init__()
        self.norm1 = group_norm(in_channels, groups, eps=eps)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        if temb_channels:
            self.time_emb_proj = nn.Linear(temb_channels, out_channels)
        self.norm2 = group_norm(out_channels, groups, eps=eps)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.conv_shortcut = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x, temb: Optional[torch.Tensor] = None):
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class Attention(nn.Module):
    """Multi-head attention, self when context is None, else cross.

    q/k/v projections without bias, out projection with bias (SD1.x). With
    no mask it goes through ops/attention.py::self_attention, whose routing
    sends long self-attention to K7 and cross or short attention to the
    plain version; a mask takes the plain einsum, as in the JAX package.
    """

    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 context_dim: Optional[int] = None):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim or query_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim or query_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, inner)])

    def forward(self, x, context=None, mask=None):
        ctx = x if context is None else context
        b, n, _ = x.shape
        m = ctx.shape[1]
        h, dh = self.heads, self.dim_head
        q = self.to_q(x).view(b, n, h, dh)
        k = self.to_k(ctx).view(b, m, h, dh)
        v = self.to_v(ctx).view(b, m, h, dh)
        scale = dh ** -0.5
        if mask is None:
            out = self_attention(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), scale=scale)
            out = out.transpose(1, 2).reshape(b, n, h * dh)
            return self.to_out[0](out)
        attn = torch.einsum("bnhd,bmhd->bhnm", q, k) * scale + mask
        attn = torch.softmax(attn.float(), dim=-1).to(q.dtype)
        out = torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(b, n, h * dh)
        return self.to_out[0](out)


class GEGLU(nn.Module):
    """proj → (h, gate) → h · GELU(gate); ``approximate`` as F.gelu's
    ("tanh", flax's, or "none", diffusers' exact GELU)."""

    def __init__(self, dim_in: int, dim_out: int, approximate: str = "tanh"):
        super().__init__()
        self.approximate = approximate
        self.proj = nn.Linear(dim_in, dim_out * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate, approximate=self.approximate)


class FeedForward(nn.Module):
    """GEGLU 4× expansion (diffusers' ff.net.0 / ff.net.2; net.1 is a
    dropout there, an identity here)."""

    def __init__(self, dim: int, approximate: str = "tanh"):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * 4, approximate),
                                  nn.Identity(), nn.Linear(dim * 4, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    """LN → self-attn → LN → cross-attn → LN → GEGLU-FF, all residual."""

    def __init__(self, dim: int, heads: int, dim_head: int,
                 context_dim: int, *, eps: float = LAYER_NORM_EPS,
                 approximate: str = "tanh"):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.attn1 = Attention(dim, heads, dim_head)
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.attn2 = Attention(dim, heads, dim_head, context_dim)
        self.norm3 = nn.LayerNorm(dim, eps=eps)
        self.ff = FeedForward(dim, approximate)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    """Spatial transformer: GN → proj_in → ``depth`` blocks → proj_out,
    plus the residual. The projections are 1×1 convs on NCHW (SD1.x) or,
    with ``linear``, Linear layers on the [B, HW, C] tokens (SDXL). The
    forward runs in the span ``gbnerf.unet.transformer``."""

    def __init__(self, channels: int, heads: int, dim_head: int,
                 context_dim: int, depth: int = 1, *, linear: bool = False,
                 eps: float = LAYER_NORM_EPS, approximate: str = "tanh"):
        super().__init__()
        self.linear = linear
        self.norm = group_norm(channels, eps=1e-6)
        self.proj_in = (nn.Linear(channels, channels) if linear
                        else nn.Conv2d(channels, channels, 1))
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(channels, heads, dim_head, context_dim,
                                  eps=eps, approximate=approximate)
            for _ in range(depth)])
        self.proj_out = (nn.Linear(channels, channels) if linear
                         else nn.Conv2d(channels, channels, 1))

    def forward(self, x, context):
        with annotate(SPAN_UNET_TRANSFORMER):
            b, c, h, w = x.shape
            residual = x
            x = self.norm(x)
            if not self.linear:
                x = self.proj_in(x)
            x = x.permute(0, 2, 3, 1).reshape(b, h * w, c)
            if self.linear:
                x = self.proj_in(x)
            for block in self.transformer_blocks:
                x = block(x, context)
            if self.linear:
                x = self.proj_out(x)
            x = x.reshape(b, h, w, c).permute(0, 3, 1, 2)
            if not self.linear:
                x = self.proj_out(x)
            return x + residual


class Downsample2D(nn.Module):
    """Stride-2 3×3 conv. The VAE encoder pads asymmetrically (0, 1) — its
    diffusers blocks pass downsample_padding=0, which pads right and bottom
    by one — and the UNet symmetrically by 1."""

    def __init__(self, channels: int, out_channels: int, *,
                 asymmetric: bool = True):
        super().__init__()
        self.asymmetric = asymmetric
        self.conv = nn.Conv2d(channels, out_channels, 3, stride=2,
                              padding=0 if asymmetric else 1)

    def forward(self, x):
        if self.asymmetric:
            x = F.pad(x, (0, 1, 0, 1))
        return self.conv(x)


class Upsample2D(nn.Module):
    """2× nearest upsampling (pixel i ← i // 2, which is also
    jax.image.resize's half-pixel nearest at this factor) → 3×3 conv."""

    def __init__(self, channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, out_channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


def init_weights_(module: nn.Module, generator: torch.Generator) -> None:
    """Flax's default inits, drawn from ``generator`` (which lies on the
    parameters' device): Linear and Conv kernels ``lecun_normal``, a normal
    truncated at ±2 of its σ with σ = (1/√fan_in) / 0.87962566 so that the
    std is 1/√fan_in (fan_in = kh·kw·c_in for a conv, flax's HWIO fan-in);
    biases 0; norms' scale 1 and shift 0; embeddings ``nn.Embed``'s normal
    of std 1/√width. A module with parameters of its own initializer (the
    JAX package's explicit ``self.param``) sets them in ``init_own_``,
    called after this pass. The distributions are the JAX package's, not
    its bits: utils/jax_init.py replays those from a JaxKey."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                fan_in = m.weight[0].numel()
                std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std,
                                      2.0 * std, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                m.weight.normal_(0.0, 1.0 / math.sqrt(m.embedding_dim),
                                 generator=generator)
        for m in module.modules():
            own = getattr(m, "init_own_", None)
            if own is not None:
                own(generator)
