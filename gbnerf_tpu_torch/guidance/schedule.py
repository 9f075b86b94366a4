"""Diffusion noise schedule (DDPM/DDIM math for Stable Diffusion v1.x).

Port of gbnerf_tpu/guidance/schedule.py: scaled-linear betas 0.00085 →
0.012 over 1000 train steps, ᾱ_t, ``add_noise`` (x_t = √ᾱ_t·x₀ +
√(1−ᾱ_t)·ε), the SDS weight w(t) = 1 − ᾱ_t, the annealed timestep
t(i) = max − (max−min)·√(i/anneal) and one DDIM update. The schedule is
host numpy; the step index is a host int in the port's eager loop, and
``annealed_t`` evaluates the JAX package's f32 arithmetic with numpy f32.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class DiffusionSchedule:
    num_train_timesteps: int
    betas: np.ndarray            # [T] f32
    alphas_cumprod: np.ndarray   # [T] f32

    @staticmethod
    def sd_v1(num_train_timesteps: int = 1000, beta_start: float = 0.00085,
              beta_end: float = 0.012) -> "DiffusionSchedule":
        """The SD v1.x 'scaled_linear' schedule."""
        betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5,
                            num_train_timesteps, dtype=np.float64) ** 2
        alphas_cumprod = np.cumprod(1.0 - betas)
        return DiffusionSchedule(num_train_timesteps, betas.astype(np.float32),
                                 alphas_cumprod.astype(np.float32))

    def _ac(self, t, dtype, device=None) -> torch.Tensor:
        if isinstance(t, torch.Tensor):
            # t on the device (the trainers' per-sample draws): index a
            # device copy of ᾱ, made once, with no host read of t
            tables = self.__dict__.setdefault("_tables", {})
            if t.device not in tables:
                tables[t.device] = torch.as_tensor(self.alphas_cumprod,
                                                   device=t.device)
            return tables[t.device][t].to(dtype)
        return torch.as_tensor(self.alphas_cumprod[np.asarray(t)],
                               dtype=dtype, device=device)

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor, t):
        """x_t = √ᾱ_t x₀ + √(1−ᾱ_t) ε (t: an int, or [B] on the host or on
        x₀'s device). The result is at least f32, as jnp's promotion of the
        f32 ᾱ with bf16 latents."""
        dtype = torch.promote_types(x0.dtype, torch.float32)
        ac = self._ac(t, dtype, x0.device)
        while ac.dim() < x0.dim():
            ac = ac[..., None]
        return torch.sqrt(ac) * x0.to(dtype) + torch.sqrt(1.0 - ac) * noise

    def sds_weight(self, t, device=None) -> torch.Tensor:
        """w(t) = 1 − ᾱ_t (the reference's grad scale), f32."""
        return 1.0 - self._ac(t, torch.float32, device)

    def step_range(self, t_range: Tuple[float, float]) -> Tuple[int, int]:
        return (int(self.num_train_timesteps * t_range[0]),
                int(self.num_train_timesteps * t_range[1]))

    def annealed_t(self, i: int, t_range: Tuple[float, float],
                   anneal_iters: int = 20000) -> int:
        """t = max − (max−min)·√(i / anneal_iters), clipped to [min, max]."""
        mn, mx = self.step_range(t_range)
        f32 = np.float32
        frac = np.sqrt(np.minimum(f32(i) / f32(anneal_iters), f32(1.0)))
        t = f32(mx) - f32(mx - mn) * frac
        return int(np.clip(t.astype(np.int32), mn, mx))

    def ddim_step(self, x_t, eps, t: int, t_prev: int, eta: float = 0.0):
        """One deterministic DDIM update x_t → x_{t_prev} (t_prev < 0: the
        final step, ᾱ = 1)."""
        a_t = self._ac(t, torch.float32, x_t.device)
        a_prev = (self._ac(t_prev, torch.float32, x_t.device) if t_prev >= 0
                  else torch.ones((), device=x_t.device))
        x0 = (x_t - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
        return torch.sqrt(a_prev) * x0 + torch.sqrt(1.0 - a_prev) * eps
