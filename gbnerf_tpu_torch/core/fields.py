"""The classic NeRF MLP, the hash-grid field and the field-closure
helpers of the render path.

Port of gbnerf_tpu/core/fields.py: ``NeRFMLP`` (8×256 trunk with an
input-concat skip, σ from the trunk, rgb from a view branch),
``hash_encode`` and ``HashGridField`` (the reference's strict tcnn
topology: a 16-level hash grid, a 2×64 σ-net, SH directions, a 3×64
colour net), ``make_field_fn`` and ``make_frozen_sigma_field_fn`` (σ from a
frozen pretrained field, colour from the trainable one). Neither field has
a kernel of its own: the JAX package computes the hash encode in plain jnp
too. The MLP run in float64 is the tight anchor for checks of the render
pipeline against the JAX package.

Layer names are flax's (``trunk_{i}``, ``sigma``, ``feature``,
``views_0``, ``rgb``, ``output``; ``sigma_{i}``, ``sigma_out``,
``color_{i}``, ``color_out`` and ``hash_table``) as ``nn.Linear``s and
parameters, so a flax Dense ``kernel [in, out]`` is this module's
``weight [out, in]`` (convert.py).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.profiling import SPAN_HASH_ENCODE, annotate
from .cp_field import lecun_normal
from .encoding import freq_encode, freq_encode_dim, sh_encode

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


_HASH_PRIMES = (1, 2654435761, 805459861)


def level_resolutions(n_levels: int, base_res: int,
                      per_level_scale: float) -> List[int]:
    """N_l = floor(base · scale^l), in float64 as the JAX package has it."""
    return [int(np.floor(base_res * per_level_scale ** lvl))
            for lvl in range(n_levels)]


def hash_encode(x01: torch.Tensor, table: torch.Tensor, base_res: int = 16,
                per_level_scale: float = 1.3819,
                interpolate: bool = True) -> torch.Tensor:
    """Multiresolution hash encoding of points in [0, 1]^3 (tcnn's
    HashGrid): per level, the 8 corners of the point's cell index the
    level's table densely when (N_l + 1)³ ≤ T, else by the spatial hash
    x ⊕ y·2654435761 ⊕ z·805459861; their features are blended
    trilinearly.

    x01 [..., 3] (f32 in the field), table [L, T, F] (T a power of two) →
    [..., L·F]. All levels are computed at once. The JAX package's uint32
    products and sums wrap; here they run in int64 and keep the low bits
    with ``& (T − 1)``, which are the uint32 result's because T divides
    2^32. The gather is ``F.embedding`` on the [L·T, F] table: its
    backward (the scatter-add of the corner weights, jnp.take's
    transpose) sorts the indices and sums each row's terms in a fixed
    order, so it is deterministic on the card too. The points' gradient
    flows through the interpolation weights.
    """
    with annotate(SPAN_HASH_ENCODE):
        L, T, F_ = table.shape
        res = level_resolutions(L, base_res, per_level_scale)
        n_dense = sum((r + 1) ** 3 <= T for r in res)
        if any((r + 1) ** 3 <= T for r in res[n_dense:]):
            raise ValueError("dense levels must precede hashed ones")
        dev = x01.device
        pos = x01[..., None, :] * torch.tensor(res, dtype=x01.dtype,
                                               device=dev)[:, None]
        pos0 = torch.floor(pos)
        frac = pos - pos0                                    # [..., L, 3]
        i0 = pos0.to(torch.int64)
        # per axis, the index term of the corner at 0 and at 1: [..., L, 2, 3]
        mult = torch.tensor([[1, r + 1, (r + 1) ** 2] for r in res[:n_dense]]
                            + [list(_HASH_PRIMES)] * (L - n_dense),
                            dtype=torch.int64, device=dev)
        terms = torch.stack([i0, i0 + 1], dim=-2) * mult[:, None, :]
        lead = x01.shape[:-1]

        def corners(t, op):
            # corner (i, j, k) of the cell is 4i + 2j + k, the JAX package's
            # order: [..., l, 2, 3] → [..., l, 8]
            c = op(op(t[..., :, None, None, 0], t[..., None, :, None, 1]),
                   t[..., None, None, :, 2])
            return c.reshape(*c.shape[:-3], 8)

        idx = torch.cat([corners(terms[..., :n_dense, :, :], torch.add),
                         corners(terms[..., n_dense:, :, :],
                                 torch.bitwise_xor)], dim=-2)
        idx = (idx & (T - 1)) + torch.arange(L, device=dev)[:, None] * T
        feats = F.embedding(idx, table.reshape(L * T, F_))   # [..., L, 8, F]
        if not interpolate:
            return feats[..., 0, :].reshape(*lead, L * F_)
        w1 = torch.stack([1.0 - frac, frac], dim=-2)         # [..., L, 2, 3]
        w = (w1[..., :, None, None, 0] * w1[..., None, :, None, 1]
             * w1[..., None, None, :, 2]).reshape(*lead, L, 8)
        return torch.sum(feats * w[..., None], dim=-2).reshape(*lead, L * F_)


class HashGridField(nn.Module):
    """Instant-NGP-style field (the reference's NeRF_TCNN) → raw [..., 4] =
    rgb logits ⊕ raw σ, the contract of ``NeRFMLP``.

    Parameters are float32, drawn from ``generator`` (on its device) and
    moved to ``device``: ``hash_table`` [L, T, F] from U(−1e-4, 1e-4) and
    the bias-free heads lecun-normal, as flax initialises them. The table
    is cast to ``compute_dtype`` before the gather and the heads run in
    it, as flax's ``dtype=``; positions are always f32. ``sigma_only``
    skips the colour net and leaves rgb zero, as the CP field does.
    """

    def __init__(self, bound: float = 100.0, n_levels: int = 16,
                 n_features: int = 2, log2_hashmap_size: int = 19,
                 base_res: int = 16, finest_res_per_unit: int = 2048,
                 sigma_layers: int = 2, sigma_width: int = 64,
                 geo_feat_dim: int = 15, color_layers: int = 3,
                 color_width: int = 64, sh_degree: int = 4,
                 compute_dtype=torch.float32, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.bound, self.n_levels, self.base_res = bound, n_levels, base_res
        self.finest_res_per_unit = finest_res_per_unit
        self.sigma_layers, self.color_layers = sigma_layers, color_layers
        self.sh_degree = sh_degree
        self.compute_dtype = compute_dtype
        gdev = generator.device if generator is not None else None
        table = torch.empty((n_levels, 2 ** log2_hashmap_size, n_features),
                            device=gdev).uniform_(-1e-4, 1e-4,
                                                  generator=generator)
        self.hash_table = nn.Parameter(table.to(device))

        def dense(name, n_in, n_out):
            layer = nn.Linear(n_in, n_out, bias=False, device=device)
            with torch.no_grad():
                layer.weight.copy_(lecun_normal((n_in, n_out), generator).t())
            self.add_module(name, layer)

        n_in = n_levels * n_features
        for i in range(sigma_layers - 1):
            dense(f"sigma_{i}", n_in, sigma_width)
            n_in = sigma_width
        dense("sigma_out", n_in, 1 + geo_feat_dim)
        n_in = sh_degree ** 2 + geo_feat_dim
        for i in range(color_layers - 1):
            dense(f"color_{i}", n_in, color_width)
            n_in = color_width
        dense("color_out", n_in, 3)

    @property
    def per_level_scale(self) -> float:
        return float(np.exp2(np.log2(
            self.finest_res_per_unit * self.bound / self.base_res)
            / (self.n_levels - 1)))

    def _dense(self, name: str, h: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        return F.linear(h.to(cd), getattr(self, name).weight.to(cd))

    def forward(self, pts: torch.Tensor, viewdirs: Optional[torch.Tensor],
                sigma_only: bool = False) -> torch.Tensor:
        """pts [..., 3], viewdirs [..., 3] (or per ray, [..., 1, 3]; unused
        and may be None when sigma_only) → raw [..., 4] f32."""
        cd = self.compute_dtype
        # a true division, as the JAX package's: on CUDA a Python-scalar
        # divisor becomes a product with its reciprocal, one ulp off in
        # x01, which moves a finest-level cell fraction by ≈ 0.01
        x01 = (pts + self.bound) / pts.new_full((), 2.0 * self.bound)
        h = hash_encode(x01.float(), self.hash_table.to(cd),
                        base_res=self.base_res,
                        per_level_scale=self.per_level_scale)
        for i in range(self.sigma_layers - 1):
            h = torch.relu(self._dense(f"sigma_{i}", h))
        h = self._dense("sigma_out", h)
        sigma, geo = h[..., :1], h[..., 1:]
        if sigma_only:
            return torch.cat([torch.zeros_like(geo[..., :3]), sigma],
                             dim=-1).float()
        d = sh_encode(viewdirs.to(cd), self.sh_degree)
        h = torch.cat([d.expand(geo.shape[:-1] + (d.shape[-1],)), geo], -1)
        for i in range(self.color_layers - 1):
            h = torch.relu(self._dense(f"color_{i}", h))
        rgb = self._dense("color_out", h)
        return torch.cat([rgb, sigma], dim=-1).float()


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
