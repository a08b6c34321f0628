"""Carry a FLUX parameter tree of the JAX package across to the port's state dict.

Input: the flax parameter pytree as nested dicts of numpy arrays
(``double_blocks_0/img_attn_qkv/kernel`` …). Output: a ``FluxModel`` state dict
(``double_blocks.0.img_attn_qkv.weight`` …). A flax ``kernel`` is (in, out) where
``nn.Linear.weight`` is (out, in); the double blocks' ``*_attn_qkv`` kernel is
(hidden, 3, H, D) with q, k, v at index 0, 1, 2, which flattens to the port's
(3·H·D) output order. The QK-norm scales keep their names.
"""

from __future__ import annotations

import re
from collections.abc import Mapping

import numpy as np
import torch

_BLOCK = re.compile(r"^(double_blocks|single_blocks)_(\d+)/")


def _flatten(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, path + "/"))
        else:
            out[path] = np.asarray(v)
    return out


def from_jax_params(tree: Mapping) -> dict[str, torch.Tensor]:
    """Flax FLUX parameter tree (nested dicts of numpy arrays) → port state dict."""
    state = {}
    for path, arr in _flatten(tree).items():
        path = _BLOCK.sub(r"\1.\2/", path)
        module, _, leaf = path.rpartition("/")
        if leaf == "kernel":
            key, value = f"{module}/weight", arr.reshape(arr.shape[0], -1).T
        elif leaf == "bias":
            key, value = path, arr.reshape(-1)
        else:
            key, value = path, arr
        state[key.replace("/", ".")] = torch.from_numpy(np.array(value, copy=True))
    return state
