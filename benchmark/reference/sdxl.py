"""Plain reference of the SDXL-inpainting stack: the UNet, the two CLIP text
towers and the LoRA fine-tune's loss, with their parameter names.

The architecture of diffusers/stable-diffusion-xl-1.0-inpainting-0.1's
published unet/, text_encoder/, text_encoder_2/ and vae/ config.json
(SDXL, arXiv 2307.01952), written from those configs and diffusers' and
transformers' equations, in float32 with plain softmax attention and no
kernel. It imports nothing of the port; the VAE, the ResNet block, the
plain products and ``PRECISION`` (f32, or the fp8 control) are reference/
sd.py's. The modules carry diffusers' and transformers' parameter names,
so one seeded set of weights loads into the port's modules and these.

- UNet: three levels (320, 640, 1280), the first without attention;
  transformer depths [1, 2, 10] by level (the mid block 10 deep), heads
  [5, 10, 20] of 64; Linear ``proj_in``/``proj_out`` on the tokens; cross
  width 2048; LayerNorm ε 1e-5 and exact GELU in GEGLU (diffusers'); the
  "text_time" embedding: the six size and crop ids each embedded
  sinusoidally to 256 ([cos, sin], as the time step), appended to the
  pooled text embedding, through ``add_embedding`` and added to the time
  embedding.
- Text: each tower's context is its penultimate layer's output without
  the final LayerNorm; the two concatenate to 768 + 1280 = 2048. The
  pooled embedding is the second tower's final-LayerNormed state at the
  first EOS token through ``text_projection`` (no bias). Tower 1 quick
  GELU, tower 2 exact GELU, both LayerNorm ε 1e-5.
- The latents are scaled by the configuration's ``scaling_factor``
  (0.13025).

Departures from the published model, each also the port's: the
tokenizer is reference/sd.py's hash fallback for both towers (no BPE
vocabulary is in the repository; tokenizer_2 pads with "!" where this
pads with EOS); the VAE is reference/sd.py's, with the SD1.5 port's
GroupNorm ε; the attention's softmax is taken in f32 throughout.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

# PRECISION, alphas_cumprod and tokenize are the traffic's through here
from .sd import (PRECISION, Attention, Conv2d, Downsample2D,  # noqa: F401
                 Linear, ResnetBlock2D, TimestepEmbedding, Upsample2D, VAE,
                 alphas_cumprod, group_norm, lora_targets, lora_weights,
                 quant, timestep_embedding, tokenize)

EPS = 1e-5                   # diffusers' and transformers' LayerNorm ε


class GEGLU(nn.Module):
    def __init__(self, i, o):
        super().__init__()
        self.proj = Linear(i, o * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


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
        self.norm1 = nn.LayerNorm(dim, eps=EPS)
        self.attn1 = Attention(dim, heads, dim_head)
        self.norm2 = nn.LayerNorm(dim, eps=EPS)
        self.attn2 = Attention(dim, heads, dim_head, context_dim)
        self.norm3 = nn.LayerNorm(dim, eps=EPS)
        self.ff = FeedForward(dim)

    def forward(self, x, ctx):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), ctx)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    """GroupNorm → Linear proj_in on the tokens → depth blocks → Linear
    proj_out, plus the residual (use_linear_projection)."""

    def __init__(self, c, heads, context_dim, depth):
        super().__init__()
        self.norm = group_norm(c, eps=1e-6)
        self.proj_in = Linear(c, c)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(c, heads, c // heads, context_dim)
            for _ in range(depth)])
        self.proj_out = Linear(c, c)

    def forward(self, x, ctx):
        b, c, h, w = x.shape
        y = self.norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        y = self.proj_in(y)
        for blk in self.transformer_blocks:
            y = blk(y, ctx)
        y = self.proj_out(y)
        return y.reshape(b, h, w, c).permute(0, 3, 1, 2) + x


class _Block(nn.Module):
    def __init__(self):
        super().__init__()
        self.resnets = nn.ModuleList()
        self.attentions = nn.ModuleList()


class UNet(nn.Module):
    """UNet2DConditionModel of SDXL (inpainting: 9 input channels); NHWC
    in and out, as the port's. ``c``: diffusers' unet/config.json keys."""

    def __init__(self, c: dict):
        super().__init__()
        chs = tuple(c["block_out_channels"])
        n = len(chs)
        heads = c["attention_head_dim"]                # heads, by level
        depth = c["transformer_layers_per_block"]
        cross, lpb = c["cross_attention_dim"], c["layers_per_block"]
        down = [t.startswith("CrossAttn") for t in c["down_block_types"]]
        up = [t.startswith("CrossAttn") for t in c["up_block_types"]]
        temb = chs[0] * 4
        self.chs, self.time_dim = chs, c["addition_time_embed_dim"]
        self.time_embedding = TimestepEmbedding(chs[0], temb)
        self.add_embedding = TimestepEmbedding(
            c["projection_class_embeddings_input_dim"], temb)
        self.conv_in = Conv2d(c["in_channels"], chs[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        skips, h = [chs[0]], chs[0]
        for i, ch in enumerate(chs):
            blk = _Block()
            for _ in range(lpb):
                blk.resnets.append(ResnetBlock2D(h, ch, temb))
                h = ch
                if down[i]:
                    blk.attentions.append(Transformer2D(ch, heads[i], cross,
                                                        depth[i]))
                skips.append(ch)
            if i < n - 1:
                blk.downsamplers = nn.ModuleList([Downsample2D(ch, False)])
                skips.append(ch)
            self.down_blocks.append(blk)
        cm = chs[-1]
        self.mid_block = _Block()
        self.mid_block.resnets.append(ResnetBlock2D(cm, cm, temb))
        self.mid_block.attentions.append(Transformer2D(cm, heads[-1], cross,
                                                       depth[-1]))
        self.mid_block.resnets.append(ResnetBlock2D(cm, cm, temb))
        self.up_blocks = nn.ModuleList()
        for i, ch in enumerate(reversed(chs)):
            level = n - 1 - i
            blk = _Block()
            for _ in range(lpb + 1):
                blk.resnets.append(ResnetBlock2D(h + skips.pop(), ch, temb))
                h = ch
                if up[i]:
                    blk.attentions.append(Transformer2D(
                        ch, heads[level], cross, depth[level]))
            if i < n - 1:
                blk.upsamplers = nn.ModuleList([Upsample2D(ch)])
            self.up_blocks.append(blk)
        self.conv_norm_out = group_norm(chs[0])
        self.conv_out = Conv2d(chs[0], c["out_channels"], 3, padding=1)

    def forward(self, sample, t, ctx, pooled, time_ids):
        """sample [B, H, W, 9], t [B], ctx [B, L, 2048], pooled [B, P],
        time_ids [B, 6] → ε [B, H, W, 4]."""
        b = sample.shape[0]
        temb = self.time_embedding(timestep_embedding(t.expand(b),
                                                      self.chs[0]))
        ids = timestep_embedding(time_ids.reshape(-1), self.time_dim)
        temb = temb + self.add_embedding(
            torch.cat([pooled, ids.reshape(b, -1)], dim=-1))
        h = self.conv_in(sample.permute(0, 3, 1, 2))
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


def encode(vae: VAE, x, eps, scaling: float):
    """[B, H, W, 3] in [-1, 1] → the posterior sample · scaling."""
    m = vae.quant_conv(vae.encoder(x.permute(0, 3, 1, 2)))
    mean, logvar = m.permute(0, 2, 3, 1).chunk(2, dim=-1)
    logvar = torch.clamp(logvar, -30.0, 20.0)
    return (mean + torch.exp(0.5 * logvar) * eps) * scaling


# ---------------- text ----------------

def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


ACTS = {"quick_gelu": quick_gelu, "gelu": F.gelu}


class CLIPLayer(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        w = c["hidden_size"]
        self.heads = c["num_attention_heads"]
        self.act = ACTS[c["hidden_act"]]
        self.layer_norm1 = nn.LayerNorm(w, eps=c["layer_norm_eps"])
        self.self_attn = nn.Module()
        for k in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self.self_attn, k, Linear(w, w))
        self.layer_norm2 = nn.LayerNorm(w, eps=c["layer_norm_eps"])
        self.mlp = nn.Module()
        self.mlp.fc1 = Linear(w, c["intermediate_size"])
        self.mlp.fc2 = Linear(c["intermediate_size"], w)

    def forward(self, x, mask):
        b, n, w = x.shape
        d, a = w // self.heads, self.self_attn
        h = self.layer_norm1(x)
        q, k, v = (getattr(a, p)(h).view(b, n, self.heads, d).transpose(1, 2)
                   for p in ("q_proj", "k_proj", "v_proj"))
        s = quant(q) @ quant(k).transpose(-1, -2) * d ** -0.5 + mask
        o = quant(torch.softmax(s, -1)) @ quant(v)
        x = x + a.out_proj(o.transpose(1, 2).reshape(b, n, w))
        return x + self.mlp.fc2(self.act(self.mlp.fc1(self.layer_norm2(x))))


class CLIPText(nn.Module):
    """CLIPTextModel, or CLIPTextModelWithProjection where ``c``'s
    ``architectures`` names it; ``c``: transformers' config.json keys."""

    def __init__(self, c: dict):
        super().__init__()
        w = c["hidden_size"]
        self.eos = 49407 if c["vocab_size"] > 49407 else c["vocab_size"] - 1
        tm = self.text_model = nn.Module()
        tm.embeddings = nn.Module()
        tm.embeddings.token_embedding = nn.Embedding(c["vocab_size"], w)
        tm.embeddings.position_embedding = nn.Embedding(
            c["max_position_embeddings"], w)
        tm.encoder = nn.Module()
        tm.encoder.layers = nn.ModuleList([
            CLIPLayer(c) for _ in range(c["num_hidden_layers"])])
        tm.final_layer_norm = nn.LayerNorm(w, eps=c["layer_norm_eps"])
        if "CLIPTextModelWithProjection" in c.get("architectures", ()):
            self.text_projection = Linear(w, c["projection_dim"], bias=False)

    def forward(self, ids):
        """[B, L] ids → (the penultimate layer's output [B, L, w], the
        pooled embedding [B, projection_dim] or None)."""
        tm = self.text_model
        L = ids.shape[1]
        x = (tm.embeddings.token_embedding(ids)
             + tm.embeddings.position_embedding.weight[None, :L])
        mask = torch.triu(torch.full((L, L), -1e9, device=ids.device), 1)
        for layer in tm.encoder.layers[:-1]:
            x = layer(x, mask)
        if not hasattr(self, "text_projection"):
            return x, None
        last = tm.final_layer_norm(tm.encoder.layers[-1](x, mask))
        first_eos = (ids == self.eos).int().argmax(dim=-1)
        pooled = last[torch.arange(ids.shape[0], device=ids.device),
                      first_eos]
        return x, self.text_projection(pooled)


def encode_text(text_1: CLIPText, text_2: CLIPText, ids):
    """ids [B, L] → (the UNet's context [B, L, w1 + w2], pooled [B, P])."""
    c1, _ = text_1(ids)
    c2, pooled = text_2(ids)
    return torch.cat([c1, c2], dim=-1), pooled


# ---------------- LoRA ----------------

def lora_loss(unet: UNet, vae: VAE, adapters, scale: float, sample: dict,
              ac: torch.Tensor, scaling: float) -> torch.Tensor:
    """The masked ε-MSE of one sample (batch of one): image u8 [S, S, 3],
    mask [S, S] (1 = masked), instance mask [S, S] (1 = object), embeds
    [L, D], pooled [P], time_ids [6], t [], noise and the two posterior ε
    [S/8, S/8, 4]."""
    img = sample["image"].float()[None] / 127.5 - 1.0
    mask = sample["mask"].float()[None]
    with torch.no_grad():
        lat = encode(vae, img, sample["enc_eps"][None], scaling)
        mlat = encode(vae, img * (mask[..., None] < 0.5),
                      sample["enc_masked_eps"][None], scaling)
    f = img.shape[1] // lat.shape[1]
    mlat_res = mask[:, f // 2::f, f // 2::f, None]       # nearest-exact
    a = ac[sample["t"].reshape(1)].reshape(())
    noisy = a.sqrt() * lat + (1 - a).sqrt() * sample["noise"][None]
    x = torch.cat([noisy, mlat_res, mlat], dim=-1)
    pred = torch.func.functional_call(
        unet, lora_weights(unet, adapters, scale),
        (x, sample["t"].reshape(1).float(), sample["embeds"][None],
         sample["pooled"][None], sample["time_ids"][None]))
    err = (pred - sample["noise"][None]) ** 2
    w = 1.0 - sample["instance_mask"].float()[None, f // 2::f, f // 2::f,
                                               None]
    return (err * w).mean()
