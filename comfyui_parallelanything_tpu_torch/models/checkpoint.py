"""Native parameter save and restore (counterpart of
``comfyui_parallelanything_tpu/models/checkpoint.py``, which writes orbax
checkpoints): a converted state dict saved with ``torch.save`` skips the
checkpoint conversion on every later load, and restores onto the caller's device.
"""

from __future__ import annotations

import os
from collections.abc import Mapping

import torch


def save_params(path: str | os.PathLike, params) -> None:
    """Write a state dict (or a module's) to ``path``."""
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    if not isinstance(params, Mapping):
        raise TypeError(f"expected a state dict or a module, got {type(params).__name__}")
    torch.save(dict(params), os.fspath(path))


def load_params(path: str | os.PathLike, device=None) -> dict[str, torch.Tensor]:
    """Read a state dict written by ``save_params``, its tensors on ``device``
    (default: the CPU). Only tensors and plain containers are accepted
    (``weights_only=True``)."""
    return torch.load(os.fspath(path), map_location=device if device is not None else "cpu",
                      weights_only=True)
