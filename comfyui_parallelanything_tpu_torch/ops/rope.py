"""Multi-axis rotary position embeddings, FLUX-style (counterpart of
``comfyui_parallelanything_tpu/ops/rope.py``). Tables in f32; rotation of
interleaved (even, odd) pairs, not rotate-half."""

from __future__ import annotations

import torch


def axis_rope_freqs(ids: torch.Tensor, axes_dim: tuple[int, ...], theta: float = 10000.0):
    """cos/sin tables for multi-axis RoPE.

    ids: (B, S, n_axes) integer positions per token per axis.
    Returns (cos, sin), each (B, S, sum(axes_dim)//2) f32.
    """
    parts_cos, parts_sin = [], []
    for i, dim in enumerate(axes_dim):
        half = dim // 2
        freqs = theta ** (-torch.arange(half, dtype=torch.float32, device=ids.device) / half)
        angles = ids[..., i].float()[..., None] * freqs
        parts_cos.append(torch.cos(angles))
        parts_sin.append(torch.sin(angles))
    return torch.cat(parts_cos, dim=-1), torch.cat(parts_sin, dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate pairs: x is (B, S, H, D); cos/sin are (B, S, D//2)."""
    xf = x.float()
    x_pairs = xf.reshape(*xf.shape[:-1], -1, 2)
    x_even, x_odd = x_pairs[..., 0], x_pairs[..., 1]
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    out = torch.stack([x_even * c - x_odd * s, x_even * s + x_odd * c], dim=-1)
    return out.reshape(xf.shape).to(x.dtype)
