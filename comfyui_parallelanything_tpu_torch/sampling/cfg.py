"""Classifier-free-guidance batching shared by the samplers (counterpart of
``comfyui_parallelanything_tpu/sampling/cfg.py``): cond ‖ uncond run in ONE
forward, doubling dim0, so per-batch kwargs double too."""

from __future__ import annotations

import torch


def double_kwargs(kwargs: dict, uncond_kwargs: dict | None, batch: int) -> dict:
    """Concatenate cond ‖ uncond along dim0 for every kwarg whose leading dim is the
    batch; non-batch kwargs pass through. Missing uncond entries reuse the cond
    value; a key present only in ``uncond_kwargs`` is rejected."""
    uncond = uncond_kwargs or {}
    extra = set(uncond) - set(kwargs)
    if extra:
        raise ValueError(
            f"uncond_kwargs keys {sorted(extra)} have no cond counterpart — "
            "cond and uncond conditioning must carry the same kwargs"
        )
    out = {}
    for k, v in kwargs.items():
        if hasattr(v, "shape") and tuple(v.shape[:1]) == (batch,):
            out[k] = torch.cat([v, uncond.get(k, v)], dim=0)
        else:
            out[k] = v
    return out


def rescale_guidance(guided: torch.Tensor, cond: torch.Tensor, phi: float) -> torch.Tensor:
    """CFG rescale (Lin et al. 2023 §3.4): match the guided prediction's per-sample
    std (population std) to the cond prediction's, blended by ``phi`` (0 = off)."""
    if phi <= 0.0:
        return guided
    dims = tuple(range(1, guided.ndim))
    std_c = torch.std(cond, dim=dims, keepdim=True, correction=0)
    std_g = torch.std(guided, dim=dims, keepdim=True, correction=0)
    rescaled = guided * (std_c / torch.clamp(std_g, min=1e-8))
    return phi * rescaled + (1.0 - phi) * guided


def apply_callback(callback, i, x):
    """Invoke a sampler callback; a return of x's shape replaces the working latent,
    any other return is ignored."""
    if callback is None:
        return x
    out = callback(i, x)
    if out is not None and getattr(out, "shape", None) == x.shape:
        return out
    return x
