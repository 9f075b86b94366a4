"""LPIPS perceptual distance in VGG16 feature space (port of
gbnerf_tpu/utils/lpips.py).

The standard LPIPS recipe: per-stage unit-normalised feature differences,
spatially averaged, summed over the 5 conv stages with learned per-channel
weights (``lin_k``) or, without them, the channel mean. Without VGG
weights on disk the features are those of a random convnet (seeded, or
from a JaxKey the JAX package's ``VGG16Features().init(key, …)``), a
perceptual proxy; with ``load_vgg16_npz``'s weights it is LPIPS.

The public layout is the JAX package's, NHWC [B, H, W, 3] in [0, 1]; the
convolutions run in NCHW inside. Weights in the JAX package's layout
(flax ``conv_{i}/kernel`` HWIO, as tools/convert_vgg.py writes them) are
carried across by ``convert.lpips_params_from_jax``.
"""
from __future__ import annotations

from typing import List, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..guidance.stable import _resize
from . import jax_random as jr

VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512)
STAGE_ENDS = (1, 3, 6, 9, 12)  # conv indices ending each LPIPS stage
_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


class VGG16Features(nn.Module):
    """VGG16's 13 convs (``conv_0`` … ``conv_12``, 3×3, padding 1) with
    ReLU and 2×2 max pools; [B, H, W, 3] in [0, 1] → the 5 stage outputs,
    NCHW."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        c_in, i = 3, 0
        for v in VGG16_CFG:
            if v == "M":
                continue
            conv = nn.Conv2d(c_in, v, 3, padding=1)
            # flax's nn.Conv init: lecun_normal (a normal truncated at ±2σ,
            # std 1/√fan_in, fan_in 9·c_in), zero bias, from the generator
            std = (1.0 / (9 * c_in)) ** 0.5 / 0.87962566103423978
            with torch.no_grad():
                conv.weight.copy_(nn.init.trunc_normal_(
                    torch.empty(conv.weight.shape), 0.0, std, -2.0 * std,
                    2.0 * std, generator=generator))
                conv.bias.zero_()
            setattr(self, f"conv_{i}", conv)
            c_in, i = v, i + 1
        self.register_buffer("mean", torch.tensor(_MEAN).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("std", torch.tensor(_STD).view(1, 3, 1, 1),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        h = (x.permute(0, 3, 1, 2) - self.mean) / self.std
        feats, i = [], 0
        for v in VGG16_CFG:
            if v == "M":
                h = F.max_pool2d(h, 2, 2)
                continue
            h = F.relu(getattr(self, f"conv_{i}")(h))
            if i in STAGE_ENDS:
                feats.append(h)
            i += 1
        return feats


class LPIPS:
    """Perceptual distance between [B, H, W, 3] images in [0, 1] → [B].

    generator: draws the random VGG weights when ``weights`` is None (a
    CPU generator: the same weights on every device; a JaxKey: the JAX
    package's random VGG from that key, ``jax_vgg16_params``). weights: a
    tree in the JAX package's layout (``load_vgg16_npz``): ``conv_{i}``
    {kernel HWIO, bias} and optionally ``lin_0`` … ``lin_4`` per-channel
    stage weights. device: where the network lives.
    """

    MIN_SIZE = 32  # below this, the 4 max-pools collapse stages to 0×0
                   # (an empty mean → NaN): tiny patches are upsampled first

    def __init__(self, generator: Optional[torch.Generator] = None,
                 weights: Optional[Mapping] = None, device=None):
        from ..convert import lpips_params_from_jax

        if weights is None and jr.is_jax(generator):
            weights = jax_vgg16_params(generator, device)
            generator = None
        self.net = VGG16Features(generator)
        self.lins = None
        if weights is not None:
            sd, lins = lpips_params_from_jax(weights)
            self.net.load_state_dict(sd)
            if lins is not None:
                self.lins = [l.to(device) for l in lins]
        self.net.to(device).requires_grad_(False)

    @property
    def device(self) -> torch.device:
        return self.net.mean.device

    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if a.shape[1] < self.MIN_SIZE or a.shape[2] < self.MIN_SIZE:
            size = (max(a.shape[1], self.MIN_SIZE),
                    max(a.shape[2], self.MIN_SIZE))
            a, b = _resize(a, size), _resize(b, size)
        total = 0.0
        for k, (x, y) in enumerate(zip(self.net(a), self.net(b))):
            x = x / torch.linalg.norm(x, dim=1, keepdim=True).clamp_min(1e-8)
            y = y / torch.linalg.norm(y, dim=1, keepdim=True).clamp_min(1e-8)
            d2 = (x - y) ** 2
            if self.lins is not None:
                # 1×1 conv with the learned per-channel weights, spatial mean
                total = total + torch.mean(
                    torch.sum(self.lins[k].view(1, -1, 1, 1) * d2, 1),
                    dim=(1, 2))
            else:
                total = total + torch.mean(d2, dim=(1, 2, 3))
        return total


def jax_vgg16_params(key, device=None) -> dict:
    """The JAX package's random VGG16 (``VGG16Features().init(key, …)``,
    flax's Conv init: lecun-normal kernels, zero biases) in its layout,
    drawn on ``device``, as numpy arrays."""
    from .jax_init import fill_tree

    template, c_in, i = {}, 3, 0
    for v in VGG16_CFG:
        if v == "M":
            continue
        template[f"conv_{i}"] = {"kernel": np.zeros((3, 3, c_in, v)),
                                 "bias": np.zeros((v,))}
        c_in, i = v, i + 1
    tree = fill_tree(template, key, device=device)
    return {k: {n: a.cpu().numpy() for n, a in v.items()}
            for k, v in tree.items()}


def load_vgg16_npz(path: str) -> dict:
    """Converted VGG16 weights (tools/convert_vgg.py's npz: conv_{i}/kernel
    HWIO, conv_{i}/bias, optional flat lin_{k} stage vectors) → the JAX
    package's tree layout, as numpy arrays."""
    params = {}
    with np.load(path) as data:
        for key in data.files:
            if "/" not in key:                 # lin_{k} stage vectors
                params[key] = data[key]
                continue
            name, leaf = key.rsplit("/", 1)
            params.setdefault(name, {})[leaf] = data[key]
    return params
