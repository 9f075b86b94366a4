"""Score distillation: SDS / CSD (balanced) / collaborative combines and
the gradient injection.

Port of gbnerf_tpu/guidance/sds.py. The injection is the same dot-product
trick: loss = Σ latents · (grad·mask).detach(), whose gradient with respect
to the latents is exactly grad·mask (the reference's SpecifyGradient).
The UNet runs without gradient; the differentiable path is render →
resized RGB → VAE encode → noised latents → injected gradient.
"""
from __future__ import annotations

from typing import Optional

import torch


def cfg_combine_sds(eps_uncond, eps_text, guidance_scale: float):
    return eps_uncond + guidance_scale * (eps_text - eps_uncond)


def cfg_combine_bsd(eps_null, eps_uncond, eps_text, w1: float, w2: float,
                    w3: float):
    """Balanced score distillation 3-way combine."""
    return w1 * eps_text + w3 * eps_null - w2 * eps_uncond


def cfg_combine_colla(eps_null, eps_uncond, eps_text, w1: float, w2: float):
    """Collaborative-SDS combine (sd_utils.py:690)."""
    return w1 * eps_text + (w2 - w1) * eps_null - w2 * eps_uncond


def inject_gradient(latents: torch.Tensor, grad: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scalar whose ∂/∂latents = grad (· mask); grad is nan-scrubbed and
    detached, the mask broadcasts over the latent channels."""
    g = torch.nan_to_num(grad)
    if mask is not None:
        g = g * mask
    return torch.sum(latents * g.detach())


def score_distillation_grad(noise_pred, noise, w_t, *, mode: str,
                            standard_sds: bool = False):
    """The raw latent-space gradient before masking and injection.

    mode: "sds" (2-way combined pred) | "csd" (3-way combined pred).
    w_t: a scalar or [B] (1 − ᾱ_t).
    """
    w = torch.as_tensor(w_t, device=noise_pred.device)
    while w.dim() < noise_pred.dim():
        w = w[..., None]
    if mode == "csd":
        return w * noise_pred
    if standard_sds:
        return w * (noise_pred - noise)
    return w * noise_pred - noise  # reference-exact SDS form
