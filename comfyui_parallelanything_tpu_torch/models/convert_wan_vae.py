"""Wan video-VAE checkpoints (the public Wan2.x VAE layout) → ``video_vae.
VideoAutoencoderKL`` state dicts (counterpart of
``comfyui_parallelanything_tpu/models/convert_wan_vae.py``).

Every tensor is upcast to f32. Public → port names:

- ``encoder.conv1`` / ``decoder.conv1`` → ``{en,de}coder.conv_in.conv``
- ``{en,de}coder.head.{0,2}`` → ``norm_out`` / ``conv_out.conv`` (index 1 is the
  parameterless SiLU)
- ``conv1`` / ``conv2`` (top level) → ``quant_conv.conv`` / ``post_quant_conv.conv``
- ``encoder.downsamples.{seq}`` — a flat Sequential whose indices are recomputed
  from the config: per level ``num_res_blocks`` ResidualBlocks, then (below the last
  level) one Resample. ResidualBlock: ``residual.0`` / ``residual.3`` (RMS norms),
  ``residual.2`` / ``residual.6`` (causal convolutions), ``shortcut`` where the
  width changes. Resample: ``resample.1`` (the spatial Conv2d behind the
  ZeroPad/Upsample at index 0) and ``time_conv`` in the 3d modes.
- ``decoder.upsamples.{seq}`` — the same flattening, ``num_res_blocks + 1`` blocks
  per level.
- ``{en,de}coder.middle.{0,1,2}`` → ``mid_block_1`` / ``mid_attn_1`` /
  ``mid_block_2``; the attention block's ``to_qkv`` / ``proj`` are per-frame 1×1
  Conv2d, its norm an RMS norm whose missing bias is zero-filled.

Layouts: Conv3d (O, I, T, H, W) keeps its own; a Conv2d (O, I, H, W) becomes the
Conv3d (O, I, 1, H, W); RMS gammas (C, 1, 1[, 1]) → (C,). The public torch module
streams 4-frame chunks through per-convolution feature caches; this one runs the
whole clip with explicit causal front padding (the JAX package's design).
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any

import torch

from .convert_text import to_f32
from .video_vae import VideoVAEConfig


def _conv(out: dict, sd: Mapping, key: str, dst: str) -> None:
    w = to_f32(sd[f"{key}.weight"])
    out[f"{dst}.weight"] = w[:, :, None] if w.ndim == 4 else w
    if f"{key}.bias" in sd:
        out[f"{dst}.bias"] = to_f32(sd[f"{key}.bias"])


def _rms(out: dict, sd: Mapping, key: str, dst: str, want_bias: bool = False) -> None:
    gamma = to_f32(sd[f"{key}.gamma"]).reshape(-1)
    out[f"{dst}.weight"] = gamma
    if want_bias:
        bias = sd.get(f"{key}.bias")
        out[f"{dst}.bias"] = (to_f32(bias).reshape(-1) if bias is not None
                              else torch.zeros_like(gamma))


def _res_block(out: dict, sd: Mapping, key: str, dst: str) -> None:
    _rms(out, sd, f"{key}.residual.0", f"{dst}.norm1")
    _conv(out, sd, f"{key}.residual.2", f"{dst}.conv1.conv")
    _rms(out, sd, f"{key}.residual.3", f"{dst}.norm2")
    _conv(out, sd, f"{key}.residual.6", f"{dst}.conv2.conv")
    if f"{key}.shortcut.weight" in sd:
        _conv(out, sd, f"{key}.shortcut", f"{dst}.shortcut.conv")


def _attn_block(out: dict, sd: Mapping, key: str, dst: str) -> None:
    _rms(out, sd, f"{key}.norm", f"{dst}.norm", want_bias=True)
    _conv(out, sd, f"{key}.to_qkv", f"{dst}.to_qkv")
    _conv(out, sd, f"{key}.proj", f"{dst}.proj")


def _resample(out: dict, sd: Mapping, key: str, dst: str, temporal: bool) -> None:
    _conv(out, sd, f"{key}.resample.1", f"{dst}.conv")
    if temporal:
        _conv(out, sd, f"{key}.time_conv", f"{dst}.time_conv.conv")


def convert_wan_vae_checkpoint(state_dict: Mapping[str, Any],
                               cfg: VideoVAEConfig) -> dict[str, torch.Tensor]:
    """Public Wan VAE state dict → ``VideoAutoencoderKL`` state dict (pass to
    ``build_video_vae(cfg, state_dict=...)``). A missing key raises ``KeyError``."""
    sd = state_dict
    n = len(cfg.channel_mult)
    out: dict[str, torch.Tensor] = {}
    for part in ("encoder", "decoder"):
        _conv(out, sd, f"{part}.conv1", f"{part}.conv_in.conv")
        _res_block(out, sd, f"{part}.middle.0", f"{part}.mid_block_1")
        _attn_block(out, sd, f"{part}.middle.1", f"{part}.mid_attn_1")
        _res_block(out, sd, f"{part}.middle.2", f"{part}.mid_block_2")
        _rms(out, sd, f"{part}.head.0", f"{part}.norm_out")
        _conv(out, sd, f"{part}.head.2", f"{part}.conv_out.conv")
    seq = 0
    for level in range(n):
        for i in range(cfg.num_res_blocks):
            _res_block(out, sd, f"encoder.downsamples.{seq}", f"encoder.down_{level}_block_{i}")
            seq += 1
        if level != n - 1:
            _resample(out, sd, f"encoder.downsamples.{seq}", f"encoder.down_{level}_downsample",
                      cfg.temporal_downsample[level])
            seq += 1
    temporal_up = tuple(reversed(cfg.temporal_downsample))
    seq = 0
    for j, level in enumerate(reversed(range(n))):
        for i in range(cfg.num_res_blocks + 1):
            _res_block(out, sd, f"decoder.upsamples.{seq}", f"decoder.up_{level}_block_{i}")
            seq += 1
        if j != n - 1:
            _resample(out, sd, f"decoder.upsamples.{seq}", f"decoder.up_{level}_upsample",
                      temporal_up[j])
            seq += 1
    _conv(out, sd, "conv1", "quant_conv.conv")
    _conv(out, sd, "conv2", "post_quant_conv.conv")
    return out
