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
- ``from_jax_moe_params`` — ``ops.moe.MoEFFN``: every leaf keeps its name and
  layout (``gate`` (D, E), ``w_in`` (E, D, F), ``b_in``, ``w_out``, ``b_out``).

The way back, for the sharding policy (``parallel/mesh.py``): ``jax_layouts(module)``
gives each parameter's ``Layout``, the shape its JAX leaf has and the view between
the two. The JAX policy picks a weight's axis from the flax shape, so the port
shards the same logical axis: a ``Linear`` is the flax (in, out) kernel, or
(in, *features) where the layer carries the DenseGeneral's ``jax_out_shape`` (FLUX's
and MMDiT's fused qkv (in, 3, H, D), the UNet's q/k/v (C, H, D)) or
``jax_in_shape`` (the UNet's o (H, D, C)); a Conv is (*kernel, in, out); every
other parameter keeps its shape (a qkv bias is its features, (3, H, D)).
"""

from __future__ import annotations

import dataclasses
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


def from_jax_moe_params(tree: Mapping) -> dict[str, torch.Tensor]:
    """Flax ``MoEFFN`` tree → ``ops.moe.MoEFFN`` state dict: the same names and
    layouts (the expert tensors are batched einsum operands on both sides)."""
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in _flatten(tree).items()}


@dataclasses.dataclass(frozen=True)
class Layout:
    """A port parameter against its JAX leaf: ``jax_shape`` and the view between the
    two. ``kind`` is ``"same"`` (a reshape), ``"dense"`` (a ``Linear`` weight: the
    transpose, then a reshape to (*in, *out); ``n_in`` input axes) or ``"conv"`` (a
    Conv weight (out, in, *kernel) against (*kernel, in, out))."""

    kind: str
    jax_shape: tuple[int, ...]
    n_in: int = 0

    def to_jax(self, t: torch.Tensor) -> torch.Tensor:
        """The JAX-layout view of a port tensor (a view; no copy)."""
        if self.kind == "dense":
            return t.t().reshape(self.jax_shape)
        if self.kind == "conv":
            k = t.ndim - 2
            return t.permute(*range(2, 2 + k), 1, 0)
        return t.reshape(self.jax_shape)

    def from_jax(self, a: torch.Tensor, shape) -> torch.Tensor:
        """The port-layout tensor of ``shape`` from its JAX-layout value."""
        if self.kind == "dense":
            return a.reshape(shape[1], shape[0]).t()
        if self.kind == "conv":
            k = a.ndim - 2
            return a.permute(k + 1, k, *range(k))
        return a.reshape(shape)


_CONVS = (torch.nn.Conv1d, torch.nn.Conv2d, torch.nn.Conv3d)


def layout_of(owner: torch.nn.Module | None, leaf: str, shape) -> Layout:
    """The ``Layout`` of parameter ``leaf`` (of ``shape``) held by module ``owner``."""
    shape = tuple(shape)
    if isinstance(owner, torch.nn.Linear):
        out_shape = tuple(getattr(owner, "jax_out_shape", (owner.out_features,)))
        if leaf == "weight":
            in_shape = tuple(getattr(owner, "jax_in_shape", (owner.in_features,)))
            return Layout("dense", in_shape + out_shape, len(in_shape))
        if leaf == "bias":
            return Layout("same", out_shape)
    if isinstance(owner, _CONVS) and leaf == "weight":
        return Layout("conv", (*shape[2:], shape[1], shape[0]))
    return Layout("same", shape)


def jax_layouts(module: torch.nn.Module) -> dict[str, Layout]:
    """Every parameter of ``module`` by its state-dict name, with its ``Layout``."""
    out = {}
    for name, p in module.named_parameters():
        owner_path, _, leaf = name.rpartition(".")
        owner = module.get_submodule(owner_path) if owner_path else module
        out[name] = layout_of(owner, leaf, p.shape)
    return out
