"""Shared primitive ops (counterpart of ``comfyui_parallelanything_tpu/ops/basic.py``)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


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


def progress_window_gate(t_vec: torch.Tensor, start: float, end: float, ndim: int,
                         flow_time: bool = False) -> torch.Tensor:
    """Per-batch sampling-progress window gate in {0, 1}, shaped (B, 1, ...) to
    broadcast over a rank-``ndim`` batch tensor. Progress runs 0 → 1 over the
    denoise: flow time is the noise level (progress = 1 − t); the eps/v families
    carry table timesteps (progress = 1 − t/999)."""
    t = t_vec.float()
    progress = 1.0 - (t if flow_time else t / 999.0)
    on = (progress >= float(start)) & (progress <= float(end))
    return on.float().reshape((-1,) + (1,) * (ndim - 1))


def flax_apply(layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A flax ``Conv``/``Dense`` with ``dtype``: the input cast to the weight's dtype."""
    return layer(x.to(layer.weight.dtype))


class GroupNorm(nn.Module):
    """GroupNorm over channels (dim 1) as flax's ``nn.GroupNorm`` computes it with a
    ``dtype``: eps 1e-6, statistics and affine in f32 with f32 scale and bias, the
    result cast to ``dtype``. The VAE and the UNet share it."""

    def __init__(self, groups: int, channels: int, dtype: torch.dtype):
        super().__init__()
        self.groups, self.dtype = groups, dtype
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return F.group_norm(x.float(), self.groups, self.weight, self.bias, 1e-6).to(self.dtype)


class LayerNorm(nn.Module):
    """LayerNorm over the last dim as flax's ``nn.LayerNorm`` computes it with a
    ``dtype``: statistics and affine in f32 with f32 scale and bias, the result
    cast to ``out_dtype``. eps is flax's default 1e-6; CLIP's towers use 1e-5."""

    def __init__(self, dim: int, eps: float = 1e-6, out_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps, self.out_dtype = eps, out_dtype
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return F.layer_norm(x.float(), (x.shape[-1],), self.weight, self.bias,
                            self.eps).to(self.out_dtype)


@torch.no_grad()
def init_random_(module: nn.Module, generator: torch.Generator) -> None:
    """Random weights from ``generator``, in place: convolutions and linears
    N(0, 1/fan_in) with zero bias, embeddings N(0, 1), ``GroupNorm``/``LayerNorm``
    scales one and biases zero. The generator lives on the module's device, so a
    full-size model is initialised where it runs."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            m.weight.normal_(0.0, 1.0 / math.sqrt(m.weight[0].numel()), generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 1.0, generator=generator)
        elif isinstance(m, (GroupNorm, LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
