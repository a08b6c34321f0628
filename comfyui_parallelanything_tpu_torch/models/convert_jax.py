"""Carry parameter trees of the JAX package across to the port's state dicts.

Input: a flax parameter pytree as nested dicts of numpy arrays. Output: the
matching module's state dict. The port's modules keep the flax names, so the
conversion is a rename plus layout changes:

- ``from_jax_params`` — FLUX (``double_blocks_0/img_attn_qkv/kernel`` →
  ``double_blocks.0.img_attn_qkv.weight``). A flax ``kernel`` is (in, out) where
  ``nn.Linear.weight`` is (out, in); the double blocks' ``*_attn_qkv`` kernel is
  (hidden, 3, H, D) with q, k, v at index 0, 1, 2, which flattens to the port's
  (3·H·D) output order. The QK-norm scales keep their names.
- ``from_jax_text_params`` — CLIP and T5 encoders (``layers_0/q/kernel`` →
  ``layers.0.q.weight``, ``blocks_3/wi_0/kernel`` → ``blocks.3.wi_0.weight``):
  Dense kernels transposed, embedding tables (``tok_emb/embedding``) and norm
  scales renamed to ``weight``; ``pos_emb`` and the T5 bias tables (``rel_bias``,
  ``rel_bias_{i}``) keep their names.
- ``from_jax_vae_params`` — the image VAE (``encoder/down_0_block_0/conv1/kernel``
  → ``encoder.down_0_block_0.conv1.weight``): Conv kernels (kh, kw, in, out) →
  (out, in, kh, kw), GroupNorm scales renamed to ``weight``.
- ``from_jax_unet_params`` — the SD-family UNet (``in_1_0_attn/block_0/attn1_q/
  kernel`` → ``in_1_0_attn.blocks.0.attn1_q.weight``): Conv kernels as the VAE's,
  Dense kernels transposed, the ``DenseGeneral`` q/k/v kernels (C, H, D) flattened
  to (H·D, C) and the o kernels (H, D, C) to (C, H·D), Group/LayerNorm scales
  renamed to ``weight``. The ControlNet tree (``hint_{i}``, ``zero_conv_{k}``,
  ``mid_out`` beside the UNet's trunk names) takes the same function.
- ``from_jax_mmdit_params`` — the SD3-class MMDiT (``blocks_0/x_attn_in/qkv/kernel``
  → ``blocks.0.x_attn_in.qkv.weight``): as FLUX's, the ``DenseGeneral`` qkv kernel
  (hidden, 3, H, D) flattening to the port's fused (3·H·D) output order; the q/k
  norm scales (``ln_q``, ``ln_k``) and ``pos_embed/table`` keep their names.
- ``from_jax_vision_params`` — the CLIP vision tower (``layers_0/q/kernel`` →
  ``layers.0.q.weight``, ``patch_embed/kernel`` → ``patch_embed.weight``): Dense
  kernels transposed, the patch Conv kernel as the VAE's, LayerNorm scales renamed
  to ``weight``; ``class_embedding`` and ``pos_emb`` keep their names.
- ``from_jax_upscale_params`` — the ESRGAN ``RRDBNet`` (``body_0/rdb1/conv1/kernel``
  → ``body.0.rdb1.conv1.weight``): Conv kernels as the VAE's.
- ``from_jax_wan_params`` — the Wan video DiT (``blocks_0/self_q/kernel`` →
  ``blocks.0.self_q.weight``): Dense kernels transposed, the RMS/LayerNorm scales
  renamed to ``weight``; ``blocks_{i}/modulation`` and ``head_modulation/bias``
  keep their names.
- ``from_jax_video_vae_params`` — the causal video VAE
  (``encoder/down_0_block_0/conv1/conv/kernel`` →
  ``encoder.down_0_block_0.conv1.conv.weight``): 3D Conv kernels
  (kt, kh, kw, in, out) → (out, in, kt, kh, kw), RMS norm scales renamed to
  ``weight``.
"""

from __future__ import annotations

import re
from collections.abc import Mapping

import numpy as np
import torch

_BLOCK = re.compile(r"(^|/)(double_blocks|single_blocks|layers|blocks)_(\d+)/")


def _flatten(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, path + "/"))
        else:
            out[path] = np.asarray(v)
    return out


def _convert(tree: Mapping, leaf_fn) -> dict[str, torch.Tensor]:
    state = {}
    for path, arr in _flatten(tree).items():
        path = _BLOCK.sub(r"\1\2.\3/", path)
        module, _, leaf = path.rpartition("/")
        name, value = leaf_fn(leaf, arr)
        key = f"{module}/{name}" if module else name
        state[key.replace("/", ".")] = torch.from_numpy(np.array(value, copy=True))
    return state


def _flux_leaf(leaf: str, arr: np.ndarray):
    if leaf == "kernel":
        return "weight", arr.reshape(arr.shape[0], -1).T
    if leaf == "bias":
        return leaf, arr.reshape(-1)
    return leaf, arr


def _renamed(leaf: str, arr: np.ndarray):
    if leaf in ("embedding", "scale"):
        return "weight", arr
    return leaf, arr


def _text_leaf(leaf: str, arr: np.ndarray):
    if leaf == "kernel":
        return "weight", arr.T
    return _renamed(leaf, arr)


def _vae_leaf(leaf: str, arr: np.ndarray):
    if leaf == "kernel":
        return "weight", arr.transpose(3, 2, 0, 1)
    return _renamed(leaf, arr)


def from_jax_params(tree: Mapping) -> dict[str, torch.Tensor]:
    """Flax FLUX parameter tree (nested dicts of numpy arrays) → port state dict."""
    return _convert(tree, _flux_leaf)


def from_jax_mmdit_params(tree: Mapping) -> dict[str, torch.Tensor]:
    """Flax ``MMDiTModel`` parameter tree → ``mmdit.MMDiTModel`` state dict."""
    return _convert(tree, _flux_leaf)


def from_jax_text_params(tree: Mapping) -> dict[str, torch.Tensor]:
    """Flax ``CLIPTextModel`` or ``T5Encoder`` tree → ``text_encoders`` state dict."""
    return _convert(tree, _text_leaf)


def from_jax_vae_params(tree: Mapping) -> dict[str, torch.Tensor]:
    """Flax ``AutoencoderKL`` tree → ``vae.AutoencoderKL`` state dict."""
    return _convert(tree, _vae_leaf)


def _vision_leaf(leaf: str, arr: np.ndarray):
    return _vae_leaf(leaf, arr) if arr.ndim == 4 else _text_leaf(leaf, arr)


def from_jax_vision_params(tree: Mapping) -> dict[str, torch.Tensor]:
    """Flax ``CLIPVisionModel`` tree → ``vision.CLIPVisionModel`` state dict."""
    return _convert(tree, _vision_leaf)


_UNET_BLOCK = re.compile(r"(^|/)block_(\d+)/")


def from_jax_unet_params(tree: Mapping) -> dict[str, torch.Tensor]:
    """Flax ``UNet2D`` tree → ``unet.UNet2D`` state dict."""
    state = {}
    for path, arr in _flatten(tree).items():
        module, _, leaf = _UNET_BLOCK.sub(r"\1blocks.\2/", path).rpartition("/")
        if leaf != "kernel":
            name, value = _renamed(leaf, arr)
        elif arr.ndim == 4:  # Conv (kh, kw, in, out)
            name, value = "weight", arr.transpose(3, 2, 0, 1)
        elif module.endswith("_o") and arr.ndim == 3:  # DenseGeneral (H, D, C)
            name, value = "weight", arr.reshape(-1, arr.shape[-1]).T
        else:  # Dense (in, out) or DenseGeneral (C, H, D)
            name, value = "weight", arr.reshape(arr.shape[0], -1).T
        key = f"{module}/{name}".replace("/", ".")
        state[key] = torch.from_numpy(np.array(value, copy=True))
    return state


_UPSCALE_BODY = re.compile(r"(^|/)body_(\d+)/")


def from_jax_upscale_params(tree: Mapping) -> dict[str, torch.Tensor]:
    """Flax ``RRDBNet`` tree (``body_3/rdb1/conv2/kernel``) → ``upscale.RRDBNet``
    state dict (``body.3.rdb1.conv2.weight``): Conv kernels as the VAE's."""
    return _convert({_UPSCALE_BODY.sub(r"\1body.\2/", p): a
                     for p, a in _flatten(tree).items()}, _vae_leaf)


def from_jax_wan_params(tree: Mapping) -> dict[str, torch.Tensor]:
    """Flax ``WanModel`` tree → ``wan.WanModel`` state dict."""
    return _convert(tree, _text_leaf)


def _video_vae_leaf(leaf: str, arr: np.ndarray):
    if leaf == "kernel":
        return "weight", arr.transpose(4, 3, 0, 1, 2)
    return _renamed(leaf, arr)


def from_jax_video_vae_params(tree: Mapping) -> dict[str, torch.Tensor]:
    """Flax ``VideoAutoencoderKL`` tree → ``video_vae.VideoAutoencoderKL`` state dict."""
    return _convert(tree, _video_vae_leaf)
