"""SD-family UNet checkpoints (ldm / SGM / ComfyUI layout) → ``unet.UNet2D`` state
dicts (counterpart of the UNet half of
``comfyui_parallelanything_tpu/models/convert_unet.py``).

Covers SD1.5, SD2.x and SDXL diffusion-model state dicts (the
``model.diffusion_model.*`` subtree of a full checkpoint; ``strip_prefix`` selects
it). Every tensor is upcast to f32; torch ``Linear`` and ``Conv2d`` weights keep
their layouts, and rank-2 ``proj_in``/``proj_out`` weights (SDXL's linear
projections) gain two spatial dims to become the port's 1×1 convolutions.

ldm → port names:

- ``time_embed.{0,2}`` → ``time_embed_{0,2}``; ``label_emb.0.{0,2}`` →
  ``label_embed_{0,2}`` (SDXL); ``input_blocks.0.0`` → ``input_conv``
- ``input_blocks.N.0`` → ``in_{level}_{i}_res``, ``input_blocks.N.1`` →
  ``in_{level}_{i}_attn``, ``input_blocks.N.0.op`` → ``down_{level}.Conv_0``
- ``middle_block.{0,1,2}`` → ``mid_res1`` / ``mid_attn`` / ``mid_res2`` (with no
  middle transformer, ``middle_block.1`` is ``mid_res2``)
- ``output_blocks.N.0`` / ``.1`` → ``out_{level}_{i}_res`` / ``_attn``; the
  trailing ``.conv`` → ``up_{level}.Conv_0``; ``out.{0,2}`` → ``out_norm`` /
  ``out_conv``
- ResBlock: ``in_layers.0`` → ``GroupNorm_0``, ``in_layers.2`` → ``Conv_0``,
  ``emb_layers.1`` → ``Dense_0``, ``out_layers.0`` → ``GroupNorm_1``,
  ``out_layers.3`` → ``Conv_1``, ``skip_connection`` → ``Conv_2``
- Transformer: ``norm`` → ``GroupNorm_0``; block ``d`` → ``blocks.d`` with
  ``attn{1,2}.to_{q,k,v}`` → ``attn{1,2}_{q,k,v}``, ``to_out.0`` → ``_o``,
  ``norm{1,2,3}`` → ``LayerNorm_{0,1,2}``, ``ff.net.0.proj`` → ``ff_in``,
  ``ff.net.2`` → ``ff_out``
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any

import torch

from .convert_vae import _param
from .unet import UNetConfig, _has_attn, middle_depth


def _res_block(out: dict, sd: Mapping, src: str, dst: str, has_skip: bool) -> None:
    for s, d in (("in_layers.0", "GroupNorm_0"), ("in_layers.2", "Conv_0"),
                 ("emb_layers.1", "Dense_0"), ("out_layers.0", "GroupNorm_1"),
                 ("out_layers.3", "Conv_1")):
        _param(out, sd, f"{src}.{s}", f"{dst}.{d}")
    if has_skip:
        _param(out, sd, f"{src}.skip_connection", f"{dst}.Conv_2")


def _spatial_transformer(out: dict, sd: Mapping, src: str, dst: str, depth: int) -> None:
    _param(out, sd, f"{src}.norm", f"{dst}.GroupNorm_0")
    _param(out, sd, f"{src}.proj_in", f"{dst}.proj_in", conv1x1=True)
    _param(out, sd, f"{src}.proj_out", f"{dst}.proj_out", conv1x1=True)
    for d in range(depth):
        s, t = f"{src}.transformer_blocks.{d}", f"{dst}.blocks.{d}"
        for a in ("attn1", "attn2"):
            for n in ("q", "k", "v"):
                _param(out, sd, f"{s}.{a}.to_{n}", f"{t}.{a}_{n}")
            _param(out, sd, f"{s}.{a}.to_out.0", f"{t}.{a}_o")
        for i in range(3):
            _param(out, sd, f"{s}.norm{i + 1}", f"{t}.LayerNorm_{i}")
        _param(out, sd, f"{s}.ff.net.0.proj", f"{t}.ff_in")
        _param(out, sd, f"{s}.ff.net.2", f"{t}.ff_out")


def convert_sd_unet_checkpoint(state_dict: Mapping[str, Any],
                               cfg: UNetConfig) -> dict[str, torch.Tensor]:
    """ldm-layout UNet state dict (keys relative to the UNet root; see
    ``strip_prefix``) → ``unet.UNet2D`` state dict for ``build_unet``. The walk
    follows ``cfg``, so a config whose middle block has no transformer
    (``middle_depth(cfg) == 0``) reads ``middle_block.1`` as a ResBlock."""
    sd = state_dict
    ch = cfg.model_channels
    out: dict[str, torch.Tensor] = {}
    _param(out, sd, "time_embed.0", "time_embed_0")
    _param(out, sd, "time_embed.2", "time_embed_2")
    if cfg.adm_in_channels is not None:
        _param(out, sd, "label_emb.0.0", "label_embed_0")
        _param(out, sd, "label_emb.0.2", "label_embed_2")
    _param(out, sd, "input_blocks.0.0", "input_conv")

    idx, in_ch = 1, ch
    for level, mult in enumerate(cfg.channel_mult):
        out_ch = ch * mult
        for i in range(cfg.num_res_blocks):
            _res_block(out, sd, f"input_blocks.{idx}.0", f"in_{level}_{i}_res",
                       has_skip=in_ch != out_ch)
            if _has_attn(cfg, level):
                _spatial_transformer(out, sd, f"input_blocks.{idx}.1", f"in_{level}_{i}_attn",
                                     cfg.transformer_depth[level])
            in_ch = out_ch
            idx += 1
        if level != len(cfg.channel_mult) - 1:
            _param(out, sd, f"input_blocks.{idx}.0.op", f"down_{level}.Conv_0")
            idx += 1

    _res_block(out, sd, "middle_block.0", "mid_res1", has_skip=False)
    mid = middle_depth(cfg)
    if mid > 0:
        _spatial_transformer(out, sd, "middle_block.1", "mid_attn", mid)
        _res_block(out, sd, "middle_block.2", "mid_res2", has_skip=False)
    else:
        _res_block(out, sd, "middle_block.1", "mid_res2", has_skip=False)

    idx = 0
    for level in reversed(range(len(cfg.channel_mult))):
        for i in range(cfg.num_res_blocks + 1):
            # Every output block concatenates a skip, so its shortcut always projects.
            _res_block(out, sd, f"output_blocks.{idx}.0", f"out_{level}_{i}_res", has_skip=True)
            sub = 1
            if _has_attn(cfg, level):
                _spatial_transformer(out, sd, f"output_blocks.{idx}.{sub}",
                                     f"out_{level}_{i}_attn", cfg.transformer_depth[level])
                sub += 1
            if i == cfg.num_res_blocks and level != 0:
                _param(out, sd, f"output_blocks.{idx}.{sub}.conv", f"up_{level}.Conv_0")
            idx += 1

    _param(out, sd, "out.0", "out_norm")
    _param(out, sd, "out.2", "out_conv")
    return out


def strip_prefix(state_dict: Mapping[str, Any],
                 prefix: str = "model.diffusion_model.") -> dict:
    """Select and strip a subtree prefix (full checkpoints carry the UNet under
    ``model.diffusion_model.``); a dict without it passes unchanged."""
    out = {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}
    return out if out else dict(state_dict)
