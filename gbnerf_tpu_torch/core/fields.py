"""The classic NeRF MLP and the field-closure helper of the render path.

Port of gbnerf_tpu/core/fields.py: ``NeRFMLP`` (8×256 trunk with an
input-concat skip, σ from the trunk, rgb from a view branch),
``make_field_fn`` and ``make_frozen_sigma_field_fn`` (σ from a frozen
pretrained field, colour from the trainable one). The MLP has no kernel;
run in float64 it is the tight anchor for checks of the render pipeline
against the JAX package. ``HashGridField`` is not ported yet.

Layer names are flax's (``trunk_{i}``, ``sigma``, ``feature``,
``views_0``, ``rgb``, ``output``) as ``nn.Linear``s, so a flax Dense
``kernel [in, out]`` is this module's ``weight [out, in]`` (convert.py).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .cp_field import lecun_normal
from .encoding import freq_encode, freq_encode_dim

FieldFn = Callable[..., torch.Tensor]


class NeRFMLP(nn.Module):
    """Original-NeRF MLP with frequency-encoded inputs → raw [..., 4].

    Parameters are float32, drawn from ``generator`` as flax initialises a
    Dense (lecun-normal kernel, zero bias); the forward casts inputs and
    weights to ``compute_dtype``, as flax's ``dtype=`` does. For a float64
    run, also move the module to float64 (``.double()``) so that loaded
    weights keep their precision.
    """

    def __init__(self, depth: int = 8, width: int = 256,
                 skips: Sequence[int] = (4,), multires: int = 10,
                 multires_views: int = 4, use_viewdirs: bool = True,
                 compute_dtype=torch.float32, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.depth, self.width = depth, width
        self.skips = tuple(skips)
        self.multires, self.multires_views = multires, multires_views
        self.use_viewdirs = use_viewdirs
        self.compute_dtype = compute_dtype
        in_ch = freq_encode_dim(3, multires)
        in_views = freq_encode_dim(3, multires_views)

        def dense(name, n_in, n_out):
            layer = nn.Linear(n_in, n_out, device=device)
            with torch.no_grad():
                layer.weight.copy_(lecun_normal((n_in, n_out), generator).t())
                layer.bias.zero_()
            self.add_module(name, layer)

        for i in range(depth):
            n_in = in_ch if i == 0 else width + (in_ch if i - 1 in self.skips
                                                 else 0)
            dense(f"trunk_{i}", n_in, width)
        # a skip after the last trunk layer widens the heads' input, as
        # flax's shape inference does
        n_head = width + (in_ch if depth - 1 in self.skips else 0)
        if use_viewdirs:
            dense("sigma", n_head, 1)
            dense("feature", n_head, width)
            dense("views_0", width + in_views, width // 2)
            dense("rgb", width // 2, 3)
        else:
            dense("output", n_head, 4)

    def _dense(self, name: str, h: torch.Tensor) -> torch.Tensor:
        layer = getattr(self, name)
        cd = self.compute_dtype
        return F.linear(h.to(cd), layer.weight.to(cd), layer.bias.to(cd))

    def forward(self, pts: torch.Tensor, viewdirs: Optional[torch.Tensor],
                sigma_only: bool = False) -> torch.Tensor:
        """pts [..., 3], viewdirs [..., 3] or None → raw [..., 4]. sigma_only
        is accepted for the field contract; the MLP has no cheaper σ path."""
        del sigma_only
        cd = self.compute_dtype
        x = freq_encode(pts.to(cd), self.multires)
        h = x
        for i in range(self.depth):
            h = torch.relu(self._dense(f"trunk_{i}", h))
            if i in self.skips:
                h = torch.cat([x, h], dim=-1)
        if self.use_viewdirs:
            sigma = self._dense("sigma", h)
            feat = self._dense("feature", h)
            v = freq_encode(viewdirs.to(cd), self.multires_views)
            v = v.expand(feat.shape[:-1] + (v.shape[-1],))
            h = torch.relu(self._dense("views_0", torch.cat([feat, v], -1)))
            rgb = self._dense("rgb", h)
            out = torch.cat([rgb, sigma], dim=-1)
        else:
            out = self._dense("output", h)
        return out.float()      # f32 out even from a float64 run, as in flax


def make_field_fn(model: nn.Module) -> FieldFn:
    """Close over a field module → FieldFn(pts, viewdirs, sigma_only).

    viewdirs stay per ray ([..., 1, 3] against pts [..., S, 3]): fields
    encode directions per ray and broadcast the encoding over the samples.
    """

    def field_fn(pts, viewdirs, sigma_only: bool = False):
        vd = viewdirs[..., None, :] if viewdirs is not None else None
        return model(pts, vd, sigma_only=sigma_only)

    return field_fn


def make_frozen_sigma_field_fn(rgb_fn: FieldFn, alpha_fn: FieldFn) -> FieldFn:
    """σ from a frozen pretrained field, colour from the trainable one (the
    reference's NeRF_RGB with --alpha_model_path).

    The alpha field is called σ-only without gradient (K2 on the card for a
    CP field), the trainable field in full (K1); the trainable field's σ is
    dropped, so its backward (K4) sees a zero σ cotangent and no gradient
    reaches the parameters that feed σ alone. ``sigma_only`` calls go to the
    alpha field only.
    """

    def field_fn(pts, viewdirs, sigma_only: bool = False):
        with torch.no_grad():
            alpha_raw = alpha_fn(pts, viewdirs, sigma_only=True)
        if sigma_only:
            return alpha_raw
        raw = rgb_fn(pts, viewdirs)
        return torch.cat([raw[..., :3], alpha_raw[..., 3:4]], dim=-1)

    return field_fn
