"""Directional (Perp-Neg) prompt embeddings conditioned on the azimuth.

Port of gbnerf_tpu/guidance/directional.py: from the per-direction prompt
embeddings {front, side, back}, a positive embedding blended by azimuth and
the negative directions weighted by exponential decays, for the Perp-Neg
aggregator (perpneg.py). As in the JAX package, both hemispheres' cases are
computed and one is selected with ``torch.where``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch


def get_pos_neg_text_embeddings(embeddings: Dict[str, torch.Tensor],
                                azimuth_deg, *,
                                front_decay_factor: float = 2.0,
                                side_decay_factor: float = 10.0,
                                negative_w: float = -2.0):
    """Azimuth in [−180, 180) → ([3, L, D] (pos, neg1, neg2), [3] weights)."""
    front, side, back = (embeddings["front"], embeddings["side"],
                         embeddings["back"])
    az = torch.as_tensor(azimuth_deg, dtype=torch.float32,
                         device=front.device)
    one = torch.ones((), device=az.device)
    zero = torch.zeros((), device=az.device)
    in_front = (az >= -90.0) & (az < 90.0)

    # front hemisphere: blend front ↔ side
    r_f = torch.where(az >= 0, 1.0 - az / 90.0, 1.0 + az / 90.0)
    pos_f = r_f * front + (1.0 - r_f) * side
    fw_f = torch.where(r_f > 0.8, zero,
                       torch.exp(-r_f * front_decay_factor) * negative_w)
    sw_f = torch.where(r_f < 0.2, zero,
                       torch.exp(-(1.0 - r_f) * side_decay_factor)
                       * negative_w)

    # back hemisphere: blend side ↔ back
    r_b = torch.where(az >= 0, 1.0 - (az - 90.0) / 90.0,
                      1.0 + (az + 90.0) / 90.0)
    pos_b = r_b * side + (1.0 - r_b) * back
    fw_b = torch.full((), negative_w, device=az.device)
    sw_b = torch.where(r_b > 0.8, zero,
                       torch.exp(-r_b * side_decay_factor) * negative_w / 2.0)

    pos = torch.where(in_front, pos_f, pos_b)
    neg1 = torch.where(in_front, front, side)
    neg2 = torch.where(in_front, side, front)
    w = torch.where(in_front, torch.stack([one, fw_f, sw_f]),
                    torch.stack([one, sw_b, fw_b]))
    return torch.stack([pos, neg1, neg2]), w


def adjust_text_embeddings(embeddings: Dict[str, torch.Tensor],
                           azimuths: torch.Tensor, **kw
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B] azimuths → ([3·B, L, D] embeddings in three groups of B (pos,
    neg1, neg2), [2·B] negative weights) for the Perp-Neg aggregator."""
    zs, ws = zip(*(get_pos_neg_text_embeddings(embeddings, azimuths[b], **kw)
                   for b in range(azimuths.shape[0])))
    text = torch.cat([torch.stack([z[i] for z in zs]) for i in range(3)])
    weights = torch.cat([torch.stack([w[i] for w in ws]) for i in (1, 2)])
    return text, weights


def wrap_azimuth(az_deg: torch.Tensor) -> torch.Tensor:
    """Degrees → [−180, 180): a floor-mod (``jnp.mod`` in the JAX package),
    which is ``torch.remainder``, not ``fmod``."""
    return torch.remainder(az_deg + 180.0, 360.0) - 180.0

