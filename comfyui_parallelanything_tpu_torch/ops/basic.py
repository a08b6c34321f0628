"""Shared primitive ops (counterpart of ``comfyui_parallelanything_tpu/ops/basic.py``)."""

from __future__ import annotations

import math

import torch


def rms_normalize(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in f32 with a learned scale, returned in x's dtype (FLUX QKNorm)."""
    xf = x.float()
    normed = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    return (normed * scale).to(x.dtype)


def modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """adaLN modulation ``x·(1+scale)+shift`` computed in f32, returned in x's dtype."""
    return (x.float() * (1.0 + scale) + shift).to(x.dtype)


def timestep_embedding(
    t: torch.Tensor, dim: int, max_period: float = 10000.0, time_factor: float = 1.0
) -> torch.Tensor:
    """Sinusoidal timestep embedding [cos ‖ sin], (B,) -> (B, dim), in float32."""
    t = time_factor * t.float()
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half
    )
    args = t[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb
