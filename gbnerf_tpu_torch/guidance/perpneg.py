"""Perp-Neg: the perpendicular-component aggregation of directional noise
deltas.

Port of gbnerf_tpu/guidance/perpneg.py: for each auxiliary delta ε_i
(against the main text delta ε_main) the component parallel to ε_main is
removed, and the weighted perpendicular residues are added to ε_main.
"""
from __future__ import annotations

import torch


def get_perpendicular_component(x: torch.Tensor, y: torch.Tensor
                                ) -> torch.Tensor:
    """The component of x perpendicular to y, per batch element."""
    dims = tuple(range(1, x.dim()))
    proj = (torch.sum(x * y, dim=dims, keepdim=True)
            / torch.clamp(torch.sum(y * y, dim=dims, keepdim=True),
                          min=1e-12))
    return x - proj * y


def weighted_perpendicular_aggregator(delta_noise_preds: torch.Tensor,
                                      weights: torch.Tensor,
                                      batch_size: int) -> torch.Tensor:
    """[(K+1)·B, ...] directional deltas → [B, ...].

    delta_noise_preds[:B] is the main direction; the other K·B are the
    auxiliary directions, whose perpendicular components are added with
    ``weights`` ([K·B]).
    """
    main = delta_noise_preds[:batch_size]
    accum = main
    K = delta_noise_preds.shape[0] // batch_size - 1
    for i in range(K):
        aux = delta_noise_preds[(i + 1) * batch_size:(i + 2) * batch_size]
        w = weights[i * batch_size:(i + 1) * batch_size]
        w = w.reshape((batch_size,) + (1,) * (aux.dim() - 1))
        accum = accum + w * get_perpendicular_component(aux, main)
    return accum
