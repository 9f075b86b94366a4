"""CLIP text encoder and tokenizer.

Port of gbnerf_tpu/guidance/text.py:

- ``CLIPTextEncoder``: the ViT-L/14 text tower (12 layers, width 768,
  quick-GELU, causal mask, final LayerNorm); SD1.x consumes the last hidden
  state. Its submodules carry transformers' names (``text_model.embeddings
  .token_embedding``, ``text_model.encoder.layers.0.self_attn.q_proj``,
  ``text_model.encoder.layers.0.mlp.fc1``, ``text_model.final_layer_norm``),
  so a CLIPTextModel state dict loads with ``load_state_dict``. LayerNorm ε
  is flax's 1e-6, as in the JAX package (transformers' CLIP uses 1e-5).
  The configuration gives the activation, the ε, the layer whose output
  is the context and a ``text_projection``: SDXL's two towers
  (``CLIPTextConfig.sdxl_l``, ``.sdxl_bigg``, transformers' numerics)
  give the penultimate layer's state without the final LayerNorm, and the
  second (a CLIPTextModelWithProjection) its pooled embedding, the final
  LayerNorm's state at the first EOS token through ``text_projection``.
- ``Tokenizer``: transformers' CLIPTokenizer when a vocab dir is given
  (imported only then: the machine with the card has no transformers), else
  the JAX package's deterministic hash fallback, bit for bit.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..utils.profiling import SPAN_TEXT_ENCODE, annotate
from .blocks import LAYER_NORM_EPS


@dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    max_length: int = 77
    width: int = 768
    layers: int = 12
    heads: int = 12
    hidden_act: str = "quick_gelu"       # or "gelu" (exact)
    layer_norm_eps: float = LAYER_NORM_EPS
    # the context: the final LayerNorm's state ("last") or the
    # penultimate layer's output without it ("penultimate", SDXL's)
    output: str = "last"
    projection_dim: int = 0              # > 0: a text_projection (pooled)

    @staticmethod
    def tiny() -> "CLIPTextConfig":
        return CLIPTextConfig(vocab_size=1000, width=32, layers=2, heads=2)

    @staticmethod
    def sdxl_l() -> "CLIPTextConfig":
        """SDXL's text_encoder: CLIP ViT-L/14's tower, its penultimate
        layer."""
        return CLIPTextConfig(layer_norm_eps=1e-5, output="penultimate")

    @staticmethod
    def sdxl_bigg() -> "CLIPTextConfig":
        """SDXL's text_encoder_2: OpenCLIP ViT-bigG/14's tower (1280 wide,
        32 layers, 20 heads, exact GELU), its penultimate layer and a 1280
        pooled projection."""
        return CLIPTextConfig(width=1280, layers=32, heads=20,
                              hidden_act="gelu", layer_norm_eps=1e-5,
                              output="penultimate", projection_dim=1280)


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


_ACTS = {"quick_gelu": quick_gelu, "gelu": torch.nn.functional.gelu}


class _Attention(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.q_proj = nn.Linear(width, width)
        self.k_proj = nn.Linear(width, width)
        self.v_proj = nn.Linear(width, width)
        self.out_proj = nn.Linear(width, width)


class _MLP(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.fc1 = nn.Linear(width, width * 4)
        self.fc2 = nn.Linear(width * 4, width)


class CLIPLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.heads = cfg.heads
        self.act = _ACTS[cfg.hidden_act]
        self.layer_norm1 = nn.LayerNorm(cfg.width, eps=cfg.layer_norm_eps)
        self.self_attn = _Attention(cfg.width)
        self.layer_norm2 = nn.LayerNorm(cfg.width, eps=cfg.layer_norm_eps)
        self.mlp = _MLP(cfg.width)

    def forward(self, x, mask):
        b, n, w = x.shape
        d = w // self.heads
        a = self.self_attn
        h = self.layer_norm1(x)
        q = a.q_proj(h).view(b, n, self.heads, d)
        k = a.k_proj(h).view(b, n, self.heads, d)
        v = a.v_proj(h).view(b, n, self.heads, d)
        attn = torch.einsum("bnhd,bmhd->bhnm", q, k) * (d ** -0.5) + mask
        attn = torch.softmax(attn.float(), dim=-1).to(q.dtype)
        o = torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(b, n, w)
        x = x + a.out_proj(o)
        h = self.mlp.fc2(self.act(self.mlp.fc1(self.layer_norm2(x))))
        return x + h


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.width)
        self.position_embedding = nn.Embedding(cfg.max_length, cfg.width)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList([CLIPLayer(cfg) for _ in range(cfg.layers)])


class _TextModel(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.width,
                                             eps=cfg.layer_norm_eps)


class CLIPTextEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig = CLIPTextConfig()):
        super().__init__()
        self.cfg = cfg
        self.text_model = _TextModel(cfg)
        if cfg.projection_dim:
            self.text_projection = nn.Linear(cfg.width, cfg.projection_dim,
                                             bias=False)

    def init_own_(self, generator: torch.Generator) -> None:
        """The JAX tower's own ``position_embedding`` parameter,
        normal(0.01) (blocks.init_weights_ draws the layers)."""
        with torch.no_grad():
            self.text_model.embeddings.position_embedding.weight.normal_(
                0.0, 0.01, generator=generator)

    def forward(self, input_ids, pooled: bool = False):
        """[B, L] token ids → the context [B, L, width]: last_hidden_state,
        or the penultimate layer's output (``cfg.output``). With
        ``pooled`` → (context, the pooled embedding [B, projection_dim]):
        the final LayerNorm's state at each row's first EOS token through
        ``text_projection``."""
        with annotate(SPAN_TEXT_ENCODE):
            tm = self.text_model
            ids = torch.as_tensor(input_ids, dtype=torch.long,
                                  device=tm.final_layer_norm.weight.device)
            L = ids.shape[1]
            x = (tm.embeddings.token_embedding(ids)
                 + tm.embeddings.position_embedding.weight[None, :L])
            causal = torch.triu(torch.full((L, L), -1e9,
                                           dtype=torch.float32,
                                           device=ids.device), diagonal=1)
            *layers, top = tm.encoder.layers
            for layer in layers:
                x = layer(x, causal[None, None])
            penultimate = self.cfg.output == "penultimate"
            if penultimate and not pooled:
                return x
            last = tm.final_layer_norm(top(x, causal[None, None]))
            context = x if penultimate else last
            if not pooled:
                return context
            # transformers' EOS position: the row's largest id, the first
            # where it repeats (the EOS id is the vocabulary's last)
            eos = ids.argmax(dim=-1)
            pool = last[torch.arange(ids.shape[0], device=ids.device), eos]
            return context, self.text_projection(pool)


class Tokenizer:
    """CLIP BPE tokenizer with a deterministic no-vocab fallback."""

    BOS, EOS = 49406, 49407  # real CLIP vocab; scaled for tiny test vocabs

    def __init__(self, vocab_dir: Optional[str] = None,
                 max_length: int = 77, vocab_size: int = 49408):
        self.max_length = max_length
        self.vocab_size = vocab_size
        self.bos = self.BOS if vocab_size > self.BOS else vocab_size - 2
        self.eos = self.EOS if vocab_size > self.EOS else vocab_size - 1
        self._hf = None
        if vocab_dir:
            # an explicit vocab dir that fails to load raises: the hash
            # fallback would silently turn every prompt into meaningless ids
            from transformers import CLIPTokenizer

            try:
                self._hf = CLIPTokenizer.from_pretrained(vocab_dir)
            except Exception as e:
                raise RuntimeError(
                    f"tokenizer vocab_dir={vocab_dir!r} was given but "
                    f"CLIPTokenizer failed to load from it: {e!r}. Refusing "
                    "the hash fallback — it would silently replace real "
                    "prompts with meaningless ids. Fix the vocab dir or "
                    "pass vocab_dir=None to opt into the fallback.") from e

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        if self._hf is not None:
            out = self._hf(list(texts), padding="max_length",
                           max_length=self.max_length, truncation=True,
                           return_tensors="np")
            return out["input_ids"].astype(np.int32)
        return np.stack([self._fallback(t) for t in texts])

    def _fallback(self, text: str) -> np.ndarray:
        """Deterministic per-word hashing into the vocab (no real BPE); the
        empty prompt maps to BOS/EOS padding exactly like real CLIP."""
        ids = [self.bos]
        for w in text.lower().split()[: self.max_length - 2]:
            h = int.from_bytes(
                hashlib.md5(w.encode("utf-8")).digest()[:4], "little")
            ids.append(h % (self.vocab_size - 3) + 1)
        ids.append(self.eos)
        ids += [self.eos] * (self.max_length - len(ids))
        return np.asarray(ids[: self.max_length], np.int32)
