"""Image resizing with ``jax.image.resize`` semantics (``nearest``, ``bilinear``,
``cubic`` and ``lanczos3``), for masks, latents and images.

``nearest`` samples input index floor((i + 0.5)·in/out) per axis. ``bilinear``,
``cubic`` and ``lanczos3`` are separable: each resized axis contracts with an
(in, out) matrix of kernel weights (the triangle, Keys' cubic with a = -0.5, or
the radius-3 Lanczos window) centred on
(i + 0.5)·in/out − 0.5, widened by in/out when downsampling (antialiasing),
normalised per output sample, and zero for samples outside the input. Every other
axis passes through.
"""

from __future__ import annotations

import math

import torch


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - x, min=0.0)


def _lanczos3(x: torch.Tensor) -> torch.Tensor:
    radius = 3.0
    y = radius * torch.sin(math.pi * x) * torch.sin(math.pi * x / radius)
    out = torch.where(x > 1e-3, y / torch.where(x > 1e-3, math.pi ** 2 * x ** 2, 1.0), 1.0)
    return torch.where(x > radius, 0.0, out)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, 0.0, out)


_KERNELS = {"bilinear": _triangle, "cubic": _keys_cubic, "lanczos3": _lanczos3}


def _kernel_weights(n_in: int, n_out: int, device, kernel=_triangle) -> torch.Tensor:
    scale = n_out / n_in
    inv = 1.0 / scale
    kernel_scale = max(inv, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * inv - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32, device=device)[:, None]).abs()
    w = kernel(x / kernel_scale)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    w = torch.where(total.abs() > eps, w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def resize(x: torch.Tensor, shape: tuple[int, ...], method: str = "bilinear") -> torch.Tensor:
    """``x`` resized to ``shape`` (same rank) by ``nearest``, ``bilinear``, ``cubic``
    or ``lanczos3``."""
    if len(shape) != x.ndim:
        raise ValueError(f"shape {shape} does not match rank {x.ndim}")
    if method != "nearest" and method not in _KERNELS:
        raise ValueError(f"unsupported resize method {method!r}")
    if method != "nearest" and not x.is_floating_point():
        x = x.float()
    for d, (n_in, n_out) in enumerate(zip(x.shape, shape)):
        if n_in == n_out:
            continue
        if method == "nearest":
            idx = torch.floor((torch.arange(n_out, dtype=torch.float32) + 0.5) * n_in / n_out)
            x = x.index_select(d, idx.long().to(x.device))
        else:
            w = _kernel_weights(n_in, n_out, x.device, _KERNELS[method]).to(x.dtype)
            x = torch.movedim(torch.tensordot(x, w, dims=([d], [0])), -1, d)
    return x
