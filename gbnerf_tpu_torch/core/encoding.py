"""Input encodings: frequency (positional) encoding and spherical harmonics.

Port of gbnerf_tpu/core/encoding.py: identity ⊕ {sin, cos}(2^k · x) in the
reference Embedder's interleaved layout, and the 16-feature degree-4 real
SH basis of tcnn's SphericalHarmonics encoding.
"""
from __future__ import annotations

import numpy as np
import torch


def freq_encode(x: torch.Tensor, num_freqs: int, include_input: bool = True,
                log_sampling: bool = True) -> torch.Tensor:
    """γ(x): frequency-encode the last axis → [..., D·(1 + 2·num_freqs)]."""
    if num_freqs == 0:
        return x
    if log_sampling:
        freqs = 2.0 ** np.linspace(0.0, num_freqs - 1, num_freqs)
    else:
        freqs = np.linspace(1.0, 2.0 ** (num_freqs - 1), num_freqs)
    parts = [x] if include_input else []
    f = torch.as_tensor(freqs, dtype=x.dtype, device=x.device)
    xf = x[..., None, :] * f[:, None]                      # [..., F, D]
    sc = torch.stack([torch.sin(xf), torch.cos(xf)], dim=-2)  # [..., F, 2, D]
    parts.append(sc.reshape(*x.shape[:-1], 2 * len(freqs) * x.shape[-1]))
    return torch.cat(parts, dim=-1)


def freq_encode_dim(input_dim: int, num_freqs: int,
                    include_input: bool = True) -> int:
    return input_dim * ((1 if include_input else 0) + 2 * num_freqs)


_C0 = 0.28209479177387814
_C1 = 0.4886025119029199
_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
       -1.0925484305920792, 0.5462742152960396)
_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
       0.3731763325901154, -0.4570457994644658, 1.445305721320277,
       -0.5900435899266435)


def sh_encode(d: torch.Tensor, degree: int = 4) -> torch.Tensor:
    """Real spherical-harmonics encoding of unit directions → [..., degree²]."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    out = [torch.full_like(x, _C0)]
    if degree > 1:
        out += [-_C1 * y, _C1 * z, -_C1 * x]
    if degree > 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [
            _C2[0] * xy,
            _C2[1] * yz,
            _C2[2] * (2.0 * zz - xx - yy),
            _C2[3] * xz,
            _C2[4] * (xx - yy),
        ]
    if degree > 3:
        out += [
            _C3[0] * y * (3.0 * xx - yy),
            _C3[1] * xy * z,
            _C3[2] * y * (4.0 * zz - xx - yy),
            _C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            _C3[4] * x * (4.0 * zz - xx - yy),
            _C3[5] * z * (xx - yy),
            _C3[6] * x * (xx - 3.0 * yy),
        ]
    return torch.stack(out, dim=-1)
