"""AutoencoderKL checkpoints (ldm / ComfyUI / FLUX layout) → ``vae.AutoencoderKL``
state dicts (counterpart of ``comfyui_parallelanything_tpu/models/convert_vae.py``).

Covers the ``first_stage_model.*`` subtree of a full checkpoint, standalone VAE
files (no prefix), diffusers-export ``vae.*`` prefixes and FLUX ``ae.safetensors``
(same module names, no quant convs, z=16). Convolution weights keep torch's
(O, I, kH, kW) layout; rank-2 attention projections (diffusers-style exports)
become 1×1 convolutions. Every tensor is upcast to f32.

ldm → port names:

- ``encoder.down.{l}.block.{i}`` → ``encoder.down_{l}_block_{i}``
- ``encoder.down.{l}.downsample.conv`` → ``encoder.down_{l}_downsample.conv``
- ``{enc,dec}oder.mid.block_{1,2}`` / ``mid.attn_1`` → ``mid_block_{1,2}`` / ``mid_attn_1``
- ``decoder.up.{l}.block.{i}`` / ``up.{l}.upsample.conv`` → ``decoder.up_{l}_block_{i}`` /
  ``decoder.up_{l}_upsample.conv``
- ``conv_in``, ``conv_out``, ``norm_out``, ``quant_conv``, ``post_quant_conv`` keep theirs.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any

import torch

from .convert_text import to_f32
from .vae import VAEConfig


class _ConsumedRecorder(dict):
    """Dict view that records which keys the conversion read, so a VAE key that
    the config does not account for fails loudly instead of being dropped."""

    def __init__(self, base: Mapping[str, Any]):
        super().__init__(base)
        self.used: set[str] = set()

    def __getitem__(self, key):
        self.used.add(key)
        return super().__getitem__(key)


def strip_vae_prefix(state_dict: Mapping[str, Any]) -> dict:
    """Select the VAE subtree of a combined checkpoint (``first_stage_model.`` or
    ``vae.`` prefixes); a dict that starts at ``encoder.``/``decoder.`` passes."""
    for prefix in ("first_stage_model.", "vae."):
        sub = {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}
        if any(k.startswith("decoder.") for k in sub):
            return sub
    return dict(state_dict)


def _param(out: dict, sd: Mapping, key: str, dst: str, conv1x1: bool = False) -> None:
    w = to_f32(sd[f"{key}.weight"])
    if conv1x1 and w.ndim == 2:
        w = w[:, :, None, None]
    out[f"{dst}.weight"] = w
    if f"{key}.bias" in sd:
        out[f"{dst}.bias"] = to_f32(sd[f"{key}.bias"])


def _res_block(out: dict, sd: Mapping, t: str, d: str) -> None:
    for n in ("norm1", "conv1", "norm2", "conv2"):
        _param(out, sd, f"{t}.{n}", f"{d}.{n}")
    if f"{t}.nin_shortcut.weight" in sd:
        _param(out, sd, f"{t}.nin_shortcut", f"{d}.nin_shortcut")


def _attn_block(out: dict, sd: Mapping, t: str, d: str) -> None:
    _param(out, sd, f"{t}.norm", f"{d}.norm")
    for n in ("q", "k", "v", "proj_out"):
        _param(out, sd, f"{t}.{n}", f"{d}.{n}", conv1x1=True)


def convert_vae_checkpoint(state_dict: Mapping[str, Any],
                           cfg: VAEConfig) -> dict[str, torch.Tensor]:
    """ldm-layout AutoencoderKL state dict → ``vae.AutoencoderKL`` state dict (pass
    to ``build_vae(cfg, state_dict=...)``)."""
    sd = _ConsumedRecorder(strip_vae_prefix(state_dict))
    n_levels = len(cfg.channel_mult)
    out: dict[str, torch.Tensor] = {}
    for part in ("encoder", "decoder"):
        for n in ("conv_in", "norm_out", "conv_out"):
            _param(out, sd, f"{part}.{n}", f"{part}.{n}")
        _res_block(out, sd, f"{part}.mid.block_1", f"{part}.mid_block_1")
        _attn_block(out, sd, f"{part}.mid.attn_1", f"{part}.mid_attn_1")
        _res_block(out, sd, f"{part}.mid.block_2", f"{part}.mid_block_2")
    for level in range(n_levels):
        for i in range(cfg.num_res_blocks):
            _res_block(out, sd, f"encoder.down.{level}.block.{i}",
                       f"encoder.down_{level}_block_{i}")
        if level != n_levels - 1:
            _param(out, sd, f"encoder.down.{level}.downsample.conv",
                   f"encoder.down_{level}_downsample.conv")
        for i in range(cfg.num_res_blocks + 1):
            _res_block(out, sd, f"decoder.up.{level}.block.{i}", f"decoder.up_{level}_block_{i}")
        if level != 0:
            _param(out, sd, f"decoder.up.{level}.upsample.conv",
                   f"decoder.up_{level}_upsample.conv")
    if cfg.use_quant_conv:
        _param(out, sd, "quant_conv", "quant_conv")
        _param(out, sd, "post_quant_conv", "post_quant_conv")
    # A VAE key the walk never read means the config does not match the checkpoint
    # (channel_mult, num_res_blocks, attention levels, quant convs). Non-VAE
    # siblings (loss.*, model_ema.*) are ignored.
    vae_prefixes = ("encoder.", "decoder.", "quant_conv.", "post_quant_conv.")
    unused = {k for k in sd if k.startswith(vae_prefixes) and k not in sd.used}
    if unused:
        raise ValueError(f"{len(unused)} unconverted VAE keys (wrong cfg?): {sorted(unused)[:8]}")
    return out
