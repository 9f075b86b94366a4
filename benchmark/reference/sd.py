"""Plain reference of the SD1.5-inpainting stack: the UNet, the VAE and the
CLIP ViT-L/14 text tower, with their parameter names, and the LoRA
fine-tune's loss.

A frozen copy of the port's plain equations (gbnerf_tpu_torch/guidance/
blocks.py, unet.py, vae.py, text.py, schedule.py and
train/lora_trainer.py at commit e283e2e), in float32 with plain softmax
attention and no kernel. It imports nothing of the port. The modules carry
the same (diffusers') parameter names as the port's, so one seeded set of
weights loads into both.

``PRECISION`` switches every product (each Linear and Conv, and the two
products of each attention) between float32 and fp8 (e4m3 with one scale
a tensor): the fp8 setting is the control that a correct run must beat.
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

LAYER_NORM_EPS = 1e-6
VAE_SCALING = 0.18215
PRECISION = {"products": "f32"}


def quant(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the products' precision: f32 as is, or fp8 e4m3 with
    a per-tensor scale that maps |x|max onto e4m3's largest value."""
    if PRECISION["products"] == "f32":
        return x
    if PRECISION["products"] == "bf16":
        return x + (x.to(torch.bfloat16).to(x.dtype) - x).detach()
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = amax / 448.0
    q = (x.float() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x).detach()          # rounding is not differentiated


class Linear(nn.Linear):
    def forward(self, x):
        return F.linear(quant(x), quant(self.weight), self.bias)


class Conv2d(nn.Conv2d):
    def forward(self, x):
        return self._conv_forward(quant(x), quant(self.weight), self.bias)


def attention(q, k, v, scale):
    """softmax(q·kᵀ·scale)·v in f32; [..., N, D]."""
    s = quant(q) @ quant(k).transpose(-1, -2) * scale
    p = torch.softmax(s.float(), dim=-1)
    return quant(p) @ quant(v)


def group_norm(channels, groups=32, eps=1e-5):
    g = groups if channels % groups == 0 else channels
    return nn.GroupNorm(g, channels, eps=eps)


def timestep_embedding(t, dim, max_period=10000.0):
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class TimestepEmbedding(nn.Module):
    def __init__(self, i, o):
        super().__init__()
        self.linear_1, self.linear_2 = Linear(i, o), Linear(o, o)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class ResnetBlock2D(nn.Module):
    def __init__(self, cin, cout, temb=None, eps=1e-5):
        super().__init__()
        self.norm1 = group_norm(cin, eps=eps)
        self.conv1 = Conv2d(cin, cout, 3, padding=1)
        if temb:
            self.time_emb_proj = Linear(temb, cout)
        self.norm2 = group_norm(cout, eps=eps)
        self.conv2 = Conv2d(cout, cout, 3, padding=1)
        if cin != cout:
            self.conv_shortcut = Conv2d(cin, cout, 1)

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class Attention(nn.Module):
    def __init__(self, dim, heads, dim_head, context_dim=None):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.to_q = Linear(dim, inner, bias=False)
        self.to_k = Linear(context_dim or dim, inner, bias=False)
        self.to_v = Linear(context_dim or dim, inner, bias=False)
        self.to_out = nn.ModuleList([Linear(inner, inner)])

    def forward(self, x, context=None):
        ctx = x if context is None else context
        b, n, _ = x.shape
        h, d = self.heads, self.dim_head
        q = self.to_q(x).view(b, n, h, d).transpose(1, 2)
        k = self.to_k(ctx).view(b, -1, h, d).transpose(1, 2)
        v = self.to_v(ctx).view(b, -1, h, d).transpose(1, 2)
        o = attention(q, k, v, d ** -0.5).transpose(1, 2).reshape(b, n, h * d)
        return self.to_out[0](o)


class GEGLU(nn.Module):
    def __init__(self, i, o):
        super().__init__()
        self.proj = Linear(i, o * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate, approximate="tanh")


class FeedForward(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * 4), nn.Identity(),
                                  Linear(dim * 4, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim, heads, dim_head, context_dim):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.attn1 = Attention(dim, heads, dim_head)
        self.norm2 = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.attn2 = Attention(dim, heads, dim_head, context_dim)
        self.norm3 = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.ff = FeedForward(dim)

    def forward(self, x, ctx):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), ctx)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    def __init__(self, c, heads, dim_head, context_dim):
        super().__init__()
        self.norm = group_norm(c, eps=1e-6)
        self.proj_in = Conv2d(c, c, 1)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(c, heads, dim_head, context_dim)])
        self.proj_out = Conv2d(c, c, 1)

    def forward(self, x, ctx):
        b, c, h, w = x.shape
        y = self.proj_in(self.norm(x)).permute(0, 2, 3, 1).reshape(b, h * w, c)
        for blk in self.transformer_blocks:
            y = blk(y, ctx)
        return self.proj_out(y.reshape(b, h, w, c).permute(0, 3, 1, 2)) + x


class Downsample2D(nn.Module):
    def __init__(self, c, asymmetric=True):
        super().__init__()
        self.asymmetric = asymmetric
        self.conv = Conv2d(c, c, 3, stride=2, padding=0 if asymmetric else 1)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)) if self.asymmetric else x)


class Upsample2D(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv = Conv2d(c, c, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class _Block(nn.Module):
    def __init__(self):
        super().__init__()
        self.resnets = nn.ModuleList()
        self.attentions = nn.ModuleList()


class UNet(nn.Module):
    """UNet2DConditionModel of SD1.x (inpainting: 9 input channels);
    NHWC in and out, as the port's."""

    def __init__(self, c: dict):
        super().__init__()
        chs = tuple(c["block_out_channels"])
        heads, cross = c["attention_head_dim"], c["cross_attention_dim"]
        lpb = c["layers_per_block"]
        attn = [t == "CrossAttnDownBlock2D" for t in c["down_block_types"]]
        temb = chs[0] * 4
        self.chs = chs
        self.time_embedding = TimestepEmbedding(chs[0], temb)
        self.conv_in = Conv2d(c["in_channels"], chs[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        skips, h = [chs[0]], chs[0]
        for i, ch in enumerate(chs):
            blk = _Block()
            for _ in range(lpb):
                blk.resnets.append(ResnetBlock2D(h, ch, temb))
                h = ch
                if attn[i]:
                    blk.attentions.append(Transformer2D(ch, heads,
                                                        ch // heads, cross))
                skips.append(ch)
            if i < len(chs) - 1:
                blk.downsamplers = nn.ModuleList([Downsample2D(ch, False)])
                skips.append(ch)
            self.down_blocks.append(blk)
        cm = chs[-1]
        self.mid_block = _Block()
        self.mid_block.resnets.append(ResnetBlock2D(cm, cm, temb))
        self.mid_block.attentions.append(Transformer2D(cm, heads, cm // heads,
                                                       cross))
        self.mid_block.resnets.append(ResnetBlock2D(cm, cm, temb))
        self.up_blocks = nn.ModuleList()
        for i, ch in enumerate(reversed(chs)):
            blk = _Block()
            for _ in range(lpb + 1):
                blk.resnets.append(ResnetBlock2D(h + skips.pop(), ch, temb))
                h = ch
                if attn[len(chs) - 1 - i]:
                    blk.attentions.append(Transformer2D(ch, heads,
                                                        ch // heads, cross))
            if i < len(chs) - 1:
                blk.upsamplers = nn.ModuleList([Upsample2D(ch)])
            self.up_blocks.append(blk)
        self.conv_norm_out = group_norm(chs[0])
        self.conv_out = Conv2d(chs[0], c["out_channels"], 3, padding=1)

    def forward(self, sample, t, ctx):
        x = sample.permute(0, 3, 1, 2)
        temb = self.time_embedding(timestep_embedding(
            t.expand(sample.shape[0]), self.chs[0]))
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
        m = self.mid_block
        h = m.resnets[1](m.attentions[0](m.resnets[0](h, temb), ctx), temb)
        for blk in self.up_blocks:
            for j, res in enumerate(blk.resnets):
                h = res(torch.cat([h, skips.pop()], dim=1), temb)
                if len(blk.attentions):
                    h = blk.attentions[j](h, ctx)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h)
        h = self.conv_out(F.silu(self.conv_norm_out(h)))
        return h.permute(0, 2, 3, 1)


class VAEAttention(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.group_norm = group_norm(c, eps=1e-6)
        self.to_q, self.to_k, self.to_v = Linear(c, c), Linear(c, c), \
            Linear(c, c)
        self.to_out = nn.ModuleList([Linear(c, c)])

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        y = attention(self.to_q(y), self.to_k(y), self.to_v(y), c ** -0.5)
        return x + self.to_out[0](y).reshape(b, h, w, c).permute(0, 3, 1, 2)


def _mid(c):
    m = _Block()
    m.resnets.append(ResnetBlock2D(c, c))
    m.attentions = nn.ModuleList([VAEAttention(c)])
    m.resnets.append(ResnetBlock2D(c, c))
    return m


class Encoder(nn.Module):
    def __init__(self, chs, lpb, latent):
        super().__init__()
        self.conv_in = Conv2d(3, chs[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        h = chs[0]
        for i, c in enumerate(chs):
            blk = nn.Module()
            blk.resnets = nn.ModuleList()
            for _ in range(lpb):
                blk.resnets.append(ResnetBlock2D(h, c))
                h = c
            if i < len(chs) - 1:
                blk.downsamplers = nn.ModuleList([Downsample2D(c)])
            self.down_blocks.append(blk)
        self.mid_block = _mid(chs[-1])
        self.conv_norm_out = group_norm(chs[-1], eps=1e-6)
        self.conv_out = Conv2d(chs[-1], 2 * latent, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for blk in self.down_blocks:
            for r in blk.resnets:
                h = r(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h)
        m = self.mid_block
        h = m.resnets[1](m.attentions[0](m.resnets[0](h)))
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class Decoder(nn.Module):
    """Present for its parameter names only (the weights are drawn over
    the whole VAE); the LoRA loss never decodes."""

    def __init__(self, chs, lpb, latent):
        super().__init__()
        h = chs[-1]
        self.conv_in = Conv2d(latent, h, 3, padding=1)
        self.mid_block = _mid(h)
        self.up_blocks = nn.ModuleList()
        for i, c in enumerate(reversed(chs)):
            blk = nn.Module()
            blk.resnets = nn.ModuleList()
            for _ in range(lpb + 1):
                blk.resnets.append(ResnetBlock2D(h, c))
                h = c
            if i < len(chs) - 1:
                blk.upsamplers = nn.ModuleList([Upsample2D(c)])
            self.up_blocks.append(blk)
        self.conv_norm_out = group_norm(chs[0], eps=1e-6)
        self.conv_out = Conv2d(chs[0], 3, 3, padding=1)


class VAE(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        chs, lpb, lc = (tuple(c["block_out_channels"]), c["layers_per_block"],
                        c["latent_channels"])
        self.encoder = Encoder(chs, lpb, lc)
        self.decoder = Decoder(chs, lpb, lc)
        self.quant_conv = Conv2d(2 * lc, 2 * lc, 1)
        self.post_quant_conv = Conv2d(lc, lc, 1)

    def encode(self, x, eps):
        """[B, H, W, 3] in [-1, 1] → the posterior sample · 0.18215."""
        m = self.quant_conv(self.encoder(x.permute(0, 3, 1, 2)))
        mean, logvar = m.permute(0, 2, 3, 1).chunk(2, dim=-1)
        logvar = torch.clamp(logvar, -30.0, 20.0)
        return (mean + torch.exp(0.5 * logvar) * eps) * VAE_SCALING


class CLIPLayer(nn.Module):
    def __init__(self, w, heads):
        super().__init__()
        self.heads = heads
        self.layer_norm1 = nn.LayerNorm(w, eps=LAYER_NORM_EPS)
        self.self_attn = nn.Module()
        for k in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self.self_attn, k, Linear(w, w))
        self.layer_norm2 = nn.LayerNorm(w, eps=LAYER_NORM_EPS)
        self.mlp = nn.Module()
        self.mlp.fc1, self.mlp.fc2 = Linear(w, 4 * w), Linear(4 * w, w)

    def forward(self, x, mask):
        b, n, w = x.shape
        d, a = w // self.heads, self.self_attn
        h = self.layer_norm1(x)
        q, k, v = (getattr(a, p)(h).view(b, n, self.heads, d).transpose(1, 2)
                   for p in ("q_proj", "k_proj", "v_proj"))
        s = quant(q) @ quant(k).transpose(-1, -2) * d ** -0.5 + mask
        o = quant(torch.softmax(s, -1)) @ quant(v)
        x = x + a.out_proj(o.transpose(1, 2).reshape(b, n, w))
        h = self.mlp.fc1(self.layer_norm2(x))
        return x + self.mlp.fc2(h * torch.sigmoid(1.702 * h))


class CLIPText(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        w = c["hidden_size"]
        self.text_model = nn.Module()
        tm = self.text_model
        tm.embeddings = nn.Module()
        tm.embeddings.token_embedding = nn.Embedding(c["vocab_size"], w)
        tm.embeddings.position_embedding = nn.Embedding(
            c["max_position_embeddings"], w)
        tm.encoder = nn.Module()
        tm.encoder.layers = nn.ModuleList([
            CLIPLayer(w, c["num_attention_heads"])
            for _ in range(c["num_hidden_layers"])])
        tm.final_layer_norm = nn.LayerNorm(w, eps=LAYER_NORM_EPS)

    def forward(self, ids):
        tm = self.text_model
        L = ids.shape[1]
        x = (tm.embeddings.token_embedding(ids)
             + tm.embeddings.position_embedding.weight[None, :L])
        mask = torch.triu(torch.full((L, L), -1e9, device=ids.device), 1)
        for layer in tm.encoder.layers:
            x = layer(x, mask)
        return tm.final_layer_norm(x)


def tokenize(texts: Sequence[str], max_length: int = 77,
             vocab_size: int = 49408) -> np.ndarray:
    """The hash fallback tokenizer (no BPE vocabulary is in the repo):
    BOS, one id a lower-cased word (md5's first 4 bytes, little-endian,
    mod vocab − 3, + 1), EOS, padded with EOS to max_length."""
    bos = 49406 if vocab_size > 49406 else vocab_size - 2
    eos = 49407 if vocab_size > 49407 else vocab_size - 1
    out = []
    for t in texts:
        ids = [bos] + [int.from_bytes(hashlib.md5(w.encode()).digest()[:4],
                                      "little") % (vocab_size - 3) + 1
                       for w in t.lower().split()[:max_length - 2]] + [eos]
        ids += [eos] * (max_length - len(ids))
        out.append(ids[:max_length])
    return np.asarray(out, np.int64)


def alphas_cumprod(T: int = 1000, b0: float = 0.00085, b1: float = 0.012
                   ) -> np.ndarray:
    """SD v1's scaled-linear schedule's ᾱ, f32."""
    betas = np.linspace(b0 ** 0.5, b1 ** 0.5, T, dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas).astype(np.float32)


# ---------------- LoRA ----------------

LORA_TARGETS = ("attn1.to_q.weight", "attn1.to_k.weight", "attn1.to_v.weight",
                "attn1.to_out.0.weight", "attn2.to_q.weight",
                "attn2.to_k.weight", "attn2.to_v.weight",
                "attn2.to_out.0.weight", "ff.net.0.proj.weight",
                "ff.net.2.weight", "proj_in.weight", "proj_out.weight")


def lora_targets(unet: nn.Module) -> List[str]:
    """The UNet weights that carry adapters: each transformer's attention
    projections, its feed-forward and its 1×1 projection convs."""
    return [n for n, _ in unet.named_parameters()
            if n.endswith(LORA_TARGETS)]


def lora_weights(unet: nn.Module, adapters: Dict[str, torch.Tensor],
                 scale: float) -> Dict[str, torch.Tensor]:
    """{name: W + scale·(A@B)ᵀ} with A [fan-in, r] and B [r, O] keyed by
    name + '.A' / '.B' (a 1×1 conv's delta gets its two unit axes)."""
    params = dict(unet.named_parameters())
    out = {}
    for name in lora_targets(unet):
        w = params[name]
        d = (adapters[name + ".A"] @ adapters[name + ".B"]).t()
        out[name] = w + scale * d.reshape(w.shape)
    return out


def lora_loss(unet: UNet, vae: VAE, adapters, scale: float, sample: dict,
              ac: torch.Tensor) -> torch.Tensor:
    """The masked ε-MSE of one sample (batch of one): image u8 [S, S, 3],
    mask [S, S] (1 = masked), instance mask [S, S] (1 = object), embeds
    [L, D], t [], noise and the two posterior ε [S/8, S/8, 4]."""
    img = sample["image"].float()[None] / 127.5 - 1.0
    mask = sample["mask"].float()[None]
    with torch.no_grad():
        lat = vae.encode(img, sample["enc_eps"][None])
        mlat = vae.encode(img * (mask[..., None] < 0.5),
                          sample["enc_masked_eps"][None])
    f = img.shape[1] // lat.shape[1]
    mlat_res = mask[:, f // 2::f, f // 2::f, None]       # nearest-exact
    a = ac[sample["t"].reshape(1)].reshape(())
    noisy = a.sqrt() * lat + (1 - a).sqrt() * sample["noise"][None]
    x = torch.cat([noisy, mlat_res, mlat], dim=-1)
    pred = torch.func.functional_call(
        unet, lora_weights(unet, adapters, scale),
        (x, sample["t"].reshape(1).float(), sample["embeds"][None]))
    err = (pred - sample["noise"][None]) ** 2
    w = 1.0 - sample["instance_mask"].float()[None, f // 2::f, f // 2::f,
                                               None]
    return (err * w).mean()
