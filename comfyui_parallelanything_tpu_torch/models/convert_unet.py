"""SD-family UNet and ControlNet checkpoints (ldm / SGM / ComfyUI layout, and
diffusers ControlNets) → ``unet.UNet2D`` and ``controlnet.ControlNet2D`` state dicts
(counterpart of ``comfyui_parallelanything_tpu/models/convert_unet.py``).

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
- ControlNet (``convert_controlnet_checkpoint``): the same trunk names, plus
  ``input_hint_block.{0,2,...,14}`` → ``hint_{0..7}``, ``zero_convs.{k}.0`` →
  ``zero_conv_{k}`` and ``middle_block_out.0`` → ``mid_out``;
  ``diffusers_controlnet_to_ldm`` first renames a diffusers ``ControlNetModel``
  dict into that layout.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any

import torch

from .convert_vae import _param
from .unet import UNetConfig, _has_attn, _total_skips, middle_depth


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


def _encoder_trunk(out: dict, sd: Mapping, cfg: UNetConfig) -> None:
    """The trunk a UNet and a ControlNet share (ldm names alike): time and label
    embeddings, the input conv, the input (down) path and the middle block. The
    walk follows ``cfg``, so a config whose middle block has no transformer
    (``middle_depth(cfg) == 0``) reads ``middle_block.1`` as a ResBlock."""
    ch = cfg.model_channels
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


def convert_sd_unet_checkpoint(state_dict: Mapping[str, Any],
                               cfg: UNetConfig) -> dict[str, torch.Tensor]:
    """ldm-layout UNet state dict (keys relative to the UNet root; see
    ``strip_prefix``) → ``unet.UNet2D`` state dict for ``build_unet``."""
    sd = state_dict
    out: dict[str, torch.Tensor] = {}
    _encoder_trunk(out, sd, cfg)

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


# diffusers ResnetBlock2D → ldm ResBlock parameter names.
_DIFFUSERS_RES = {
    "norm1": "in_layers.0",
    "conv1": "in_layers.2",
    "time_emb_proj": "emb_layers.1",
    "norm2": "out_layers.0",
    "conv2": "out_layers.3",
    "conv_shortcut": "skip_connection",
}


def diffusers_controlnet_to_ldm(state_dict: Mapping[str, Any]) -> dict:
    """A diffusers ``ControlNetModel`` state dict renamed into the ldm/cldm layout
    ``convert_controlnet_checkpoint`` reads; the tensors pass unchanged. The
    res-blocks per level come from the largest ``resnets.{r}`` index, so no config
    is needed:

    - ``time_embedding.linear_{1,2}`` → ``time_embed.{0,2}``;
      ``add_embedding.linear_{1,2}`` → ``label_emb.0.{0,2}`` (SDXL); any other
      embedding sub-layer (``cond_proj`` of LCM-derived nets) raises ``KeyError``
    - ``conv_in`` → ``input_blocks.0.0``
    - ``controlnet_cond_embedding.conv_in / blocks.{0..5} / conv_out`` →
      ``input_hint_block.{0, 2..12, 14}``
    - ``down_blocks.b.resnets.r`` / ``.attentions.r`` →
      ``input_blocks.{1+b·(R+1)+r}.0`` / ``.1``; ``down_blocks.b.downsamplers.0.conv``
      → ``input_blocks.{(b+1)·(R+1)}.0.op``
    - ``mid_block.resnets.0 / attentions.0 / resnets.1`` → ``middle_block.0 / 1 / 2``
    - ``controlnet_down_blocks.k`` → ``zero_convs.k.0``; ``controlnet_mid_block`` →
      ``middle_block_out.0``
    """
    sd = dict(state_dict)
    res_idx = [int(parts[3]) for parts in (k.split(".") for k in sd)
               if parts[0] == "down_blocks" and parts[2] == "resnets"]
    if not res_idx:
        raise ValueError("not a diffusers ControlNet state dict (no down_blocks.*.resnets)")
    n_res = max(res_idx) + 1

    def res_suffix(suffix: str) -> str:
        name, rest = suffix.split(".", 1)
        return f"{_DIFFUSERS_RES[name]}.{rest}"

    out: dict[str, Any] = {}
    for k, v in sd.items():
        parts = k.split(".")
        if parts[0] in ("time_embedding", "add_embedding"):
            if parts[1] not in ("linear_1", "linear_2"):
                # Aliasing e.g. cond_proj onto linear_2's slot would corrupt weights.
                raise KeyError(f"unrecognized diffusers controlnet key: {k}")
            slot = 0 if parts[1] == "linear_1" else 2
            root = "time_embed" if parts[0] == "time_embedding" else "label_emb.0"
            nk = f"{root}.{slot}.{parts[-1]}"
        elif parts[0] == "conv_in":
            nk = f"input_blocks.0.0.{parts[-1]}"
        elif parts[0] == "controlnet_cond_embedding":
            hint = {"conv_in": 0, "conv_out": 14}.get(parts[1])
            if hint is None:
                hint = 2 * int(parts[2]) + 2
            nk = f"input_hint_block.{hint}.{parts[-1]}"
        elif parts[0] == "down_blocks":
            b = int(parts[1])
            if parts[2] in ("resnets", "attentions"):
                idx = 1 + b * (n_res + 1) + int(parts[3])
                rest = ".".join(parts[4:])
                nk = (f"input_blocks.{idx}.0.{res_suffix(rest)}" if parts[2] == "resnets"
                      else f"input_blocks.{idx}.1.{rest}")
            elif parts[2] == "downsamplers":
                nk = f"input_blocks.{(b + 1) * (n_res + 1)}.0.op.{parts[-1]}"
            else:
                raise KeyError(f"unrecognized diffusers controlnet key: {k}")
        elif parts[0] == "mid_block":
            if parts[1] == "resnets":
                pos = 0 if parts[2] == "0" else 2
                nk = f"middle_block.{pos}.{res_suffix('.'.join(parts[3:]))}"
            elif parts[1] == "attentions":
                nk = "middle_block.1." + ".".join(parts[3:])
            else:
                raise KeyError(f"unrecognized diffusers controlnet key: {k}")
        elif parts[0] == "controlnet_down_blocks":
            nk = f"zero_convs.{parts[1]}.0.{parts[-1]}"
        elif parts[0] == "controlnet_mid_block":
            nk = f"middle_block_out.0.{parts[-1]}"
        else:
            raise KeyError(f"unrecognized diffusers controlnet key: {k}")
        out[nk] = v
    return out


def convert_controlnet_checkpoint(state_dict: Mapping[str, Any],
                                  cfg: UNetConfig) -> dict[str, torch.Tensor]:
    """ldm-layout ControlNet state dict → ``controlnet.ControlNet2D`` state dict (pass
    to ``build_controlnet(cfg, state_dict=...)``): the trunk a UNet shares, the 8
    hint convolutions, one zero convolution per skip and ``mid_out``. Keys are
    relative to the ControlNet root (strip a ``control_model.`` prefix with
    ``strip_prefix(sd, "control_model.")`` first)."""
    sd = state_dict
    out: dict[str, torch.Tensor] = {}
    _encoder_trunk(out, sd, cfg)
    for i in range(8):
        _param(out, sd, f"input_hint_block.{2 * i}", f"hint_{i}")
    n_zero = _total_skips(cfg)
    for k in range(n_zero):
        _param(out, sd, f"zero_convs.{k}.0", f"zero_conv_{k}")
    _param(out, sd, "middle_block_out.0", "mid_out")
    return out
