"""Image losses and metrics (port of gbnerf_tpu/utils/metrics.py)."""
from __future__ import annotations

import math

import numpy as np
import torch


def img2mse(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean((x - y) ** 2)


def img2l1(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(x - y))


def img2mse_mask(x: torch.Tensor, y: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """Mask-weighted error (the reference's img2mse_mask: the signed
    difference weighted by mask², not squared)."""
    return torch.mean((x - y) * mask ** 2)


def weighted_mse(x: torch.Tensor, y: torch.Tensor,
                 w: torch.Tensor) -> torch.Tensor:
    """Error-weighted MSE used for COLMAP sparse-depth supervision."""
    return torch.mean(w * (x - y) ** 2)


def mse2psnr(mse: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log(mse) / math.log(10.0)


def to8b(x) -> np.ndarray:
    return (255 * np.clip(np.asarray(x), 0, 1)).astype(np.uint8)
