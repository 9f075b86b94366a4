"""CLIP image-text guidance (an optional modality).

Port of gbnerf_tpu/guidance/clip_guidance.py: the rendered image and the
prompt are embedded by CLIP towers (ViT-B/16 size by default) and the loss
is their negative cosine similarity. ``CLIPVisionEncoder`` runs the text
tower's ``CLIPLayer`` with a zero mask (no causal mask: every patch sees
every other). The JAX package does not wire it into the train loop, and
neither does the port.

Parameter names are the flax module's (``patch_embedding``,
``class_embedding``, ``position_embedding``, ``pre_layernorm``,
``layers.{i}`` as the text tower's layers, ``post_layernorm``,
``visual_projection``), so ``convert.clip_vision_params_from_jax`` loads the
JAX package's tree one to one. Random towers keep the path runnable; the
random text projection is an argument (``text_projection``) or a draw from
the generator. A JaxKey gives the JAX package's towers and projection
(split in three: vision init, text init, projection; utils/jax_init.py).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..utils import jax_random as jr
from .blocks import LAYER_NORM_EPS, init_weights_
from .text import CLIPLayer, CLIPTextConfig, CLIPTextEncoder, Tokenizer

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 16
    width: int = 768
    layers: int = 12
    heads: int = 12
    projection_dim: int = 512

    @staticmethod
    def tiny() -> "CLIPVisionConfig":
        return CLIPVisionConfig(image_size=32, patch_size=8, width=32,
                                layers=2, heads=2, projection_dim=16)


class CLIPVisionEncoder(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig = CLIPVisionConfig()):
        super().__init__()
        self.cfg = cfg
        c = cfg
        n_tok = (c.image_size // c.patch_size) ** 2 + 1
        self.patch_embedding = nn.Conv2d(3, c.width, c.patch_size,
                                         stride=c.patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(c.width))
        self.position_embedding = nn.Parameter(torch.zeros(n_tok, c.width))
        self.pre_layernorm = nn.LayerNorm(c.width, eps=LAYER_NORM_EPS)
        tcfg = CLIPTextConfig(width=c.width, heads=c.heads, layers=c.layers)
        self.layers = nn.ModuleList([CLIPLayer(tcfg)
                                     for _ in range(c.layers)])
        self.post_layernorm = nn.LayerNorm(c.width, eps=LAYER_NORM_EPS)
        self.visual_projection = nn.Linear(c.width, c.projection_dim,
                                           bias=False)

    def init_own_(self, generator: torch.Generator) -> None:
        """The JAX tower's own parameters (blocks.init_weights_ draws the
        layers): the class embedding normal(0.02), the positions
        normal(0.01)."""
        with torch.no_grad():
            self.class_embedding.normal_(0.0, 0.02, generator=generator)
            self.position_embedding.normal_(0.0, 0.01, generator=generator)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] in [0, 1] → the pooled projection [B, proj_dim]."""
        from .stable import _resize

        c = self.cfg
        mean = torch.tensor(CLIP_MEAN, device=images.device)
        std = torch.tensor(CLIP_STD, device=images.device)
        x = _resize((images - mean) / std, c.image_size)
        x = self.patch_embedding(x.permute(0, 3, 1, 2))       # [B, W, h, w]
        b = x.shape[0]
        x = x.flatten(2).transpose(1, 2)                       # [B, h·w, W]
        x = torch.cat([self.class_embedding.expand(b, 1, c.width), x], dim=1)
        x = self.pre_layernorm(x + self.position_embedding[None])
        zero_mask = torch.zeros((1, 1, 1, 1), device=x.device)
        for layer in self.layers:
            x = layer(x, zero_mask)
        return self.visual_projection(self.post_layernorm(x[:, 0]))


class CLIPGuidance:
    """The towers and the prompt's embedding; ``loss`` is differentiable in
    the image.

    generator: draws the vision tower's init and whatever is not given
    (the text tower's init, the text projection), on ``device``; a
    JaxKey draws the JAX package's.
    text_model: a built text tower (default: a random one);
    text_projection: [text width, projection_dim] (default: normal / √width,
    as the JAX package draws). Weights load into ``vision`` afterwards.
    """

    def __init__(self, prompt: str,
                 generator: Optional[torch.Generator] = None, *,
                 vision_config: Optional[CLIPVisionConfig] = None,
                 text_config: Optional[CLIPTextConfig] = None,
                 tokenizer_dir: Optional[str] = None,
                 text_model: Optional[CLIPTextEncoder] = None,
                 text_projection: Optional[torch.Tensor] = None,
                 device=None):
        vcfg = vision_config or CLIPVisionConfig()
        tcfg = text_config or CLIPTextConfig()
        device = torch.device(device if device is not None else "cpu")
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        self.vision = CLIPVisionEncoder(vcfg).to(device)
        new_text = text_model is None
        if new_text:
            text_model = CLIPTextEncoder(tcfg).to(device)
        if jr.is_jax(generator):
            from ..utils.jax_init import init_clip_guidance

            k_proj = init_clip_guidance(self.vision,
                                        text_model if new_text else None,
                                        generator)
        else:
            init_weights_(self.vision, generator)
            if new_text:
                init_weights_(text_model, generator)
            k_proj = generator
        self.vision.eval().requires_grad_(False)
        tok = Tokenizer(tokenizer_dir, max_length=tcfg.max_length,
                        vocab_size=tcfg.vocab_size)
        ids = tok([prompt])
        with torch.no_grad():
            hidden = text_model.eval()(ids)
        # the EOS token's hidden state (its first position) → projection
        eos_pos = int((ids[0] == tok.eos).argmax())
        pooled = hidden[0, eos_pos]
        if text_projection is None:
            text_projection = jr.draw(
                "randn", (tcfg.width, vcfg.projection_dim), k_proj,
                device=device) / tcfg.width ** 0.5
        z = pooled @ text_projection.to(pooled.device)
        self.text_embed = z / torch.linalg.norm(z)

    def loss(self, image: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
        """−⟨z_image, z_text⟩·scale for one image [H, W, 3] in [0, 1]."""
        z = self.vision(image[None])[0]
        z = z / torch.clamp(torch.linalg.norm(z), min=1e-8)
        return -torch.dot(z, self.text_embed) * scale
