"""Noise schedules for the SD-family samplers (counterpart of
``comfyui_parallelanything_tpu/sampling/schedules.py``). Both live on the CPU:
the samplers read them on the host every step."""

from __future__ import annotations

import torch


def scaled_linear_schedule(n_timesteps: int = 1000, beta_start: float = 0.00085,
                           beta_end: float = 0.012) -> torch.Tensor:
    """SD's 'scaled_linear' betas → cumulative alphas (ᾱ_t), shape (n_timesteps,), f32."""
    betas = torch.linspace(beta_start**0.5, beta_end**0.5, n_timesteps,
                           dtype=torch.float32) ** 2
    return torch.cumprod(1.0 - betas, dim=0)


def ddim_timesteps(n_steps: int, n_train: int = 1000) -> torch.Tensor:
    """Evenly spaced sampling timesteps, descending (e.g. 20 of 1000), int32."""
    step = n_train // n_steps
    return torch.arange(0, n_train, step, dtype=torch.int32).flip(0)
