"""Image metrics (port of gbnerf_tpu/utils/metrics.py, eval half)."""
from __future__ import annotations

import math

import numpy as np
import torch


def mse2psnr(mse: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log(mse) / math.log(10.0)


def to8b(x) -> np.ndarray:
    return (255 * np.clip(np.asarray(x), 0, 1)).astype(np.uint8)
