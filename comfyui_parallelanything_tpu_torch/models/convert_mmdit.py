"""SD3/SD3.5 MMDiT checkpoints (SAI / ComfyUI single-file layout) → ``mmdit.MMDiTModel``
state dicts (counterpart of ``comfyui_parallelanything_tpu/models/convert_mmdit.py``).

An optional ``model.diffusion_model.`` or ``diffusion_model.`` prefix is stripped
(``strip_mmdit_prefix``). Every tensor is upcast to f32; torch ``Linear`` weights
keep their layout, including the fused ``qkv`` whose rows are [q; k; v].

SAI → port names:

- ``x_embedder.proj`` (patch conv (dim, C, p, p)) → ``x_in``, a linear over the
  (p_h, p_w, C) flatten order ``MMDiTModel.prepare`` patchifies in
- ``pos_embed`` (1, max², dim) → ``pos_embed.table`` (max², dim)
- ``t_embedder.mlp.{0,2}`` / ``y_embedder.mlp.{0,2}`` → ``time_in`` / ``vector_in``
  ``.{in,out}_layer``; ``context_embedder`` → ``context_in``
- ``joint_blocks.{i}.x_block`` → ``blocks.{i}.x_*``: ``adaLN_modulation.1`` →
  ``x_adaln.lin``, ``attn.qkv`` → ``x_attn_in.qkv``, ``attn.ln_{q,k}`` →
  ``x_attn_in.ln_{q,k}``, ``attn.proj`` → ``x_attn_proj``, ``mlp.fc{1,2}`` →
  ``x_mlp_{in,out}``; ``context_block`` → the ``ctx_*`` twins, the last block's
  context side pre-only (adaLN and qkv, no proj or MLP)
- SD3.5-medium's ``x_block.attn2`` → ``x_attn_in2`` and ``attn2.proj`` →
  ``x_attn2_proj``
- ``final_layer.adaLN_modulation.1`` / ``final_layer.linear`` → ``final_mod`` /
  ``final_proj``

The dual-attention layers and the presence of q/k RMS norms are read from the
state dict and must match the config: a mismatch raises rather than dropping
weights.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any

import torch

from .convert_text import to_f32
from .convert_vae import _param
from .mmdit import MMDiTConfig


def strip_mmdit_prefix(sd: Mapping[str, Any]) -> dict:
    """The MMDiT subtree of a full checkpoint; a bare MMDiT dict passes unchanged."""
    for prefix in ("model.diffusion_model.", "diffusion_model."):
        stripped = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
        if any(k.startswith("joint_blocks.") for k in stripped):
            return stripped
    return dict(sd)


def _attn_in(out: dict, sd: Mapping, src: str, dst: str, cfg: MMDiTConfig) -> None:
    _param(out, sd, f"{src}.qkv", f"{dst}.qkv")
    if cfg.qk_norm:
        out[f"{dst}.ln_q"] = to_f32(sd[f"{src}.ln_q.weight"])
        out[f"{dst}.ln_k"] = to_f32(sd[f"{src}.ln_k.weight"])


def convert_mmdit_checkpoint(state_dict: Mapping[str, Any],
                             cfg: MMDiTConfig) -> dict[str, torch.Tensor]:
    """SAI/ComfyUI MMDiT state dict → ``mmdit.MMDiTModel`` state dict (pass to
    ``build_mmdit(cfg, state_dict=...)``)."""
    sd = strip_mmdit_prefix(state_dict)
    attn2_layers = tuple(sorted(
        int(k.split(".")[1]) for k in sd
        if k.startswith("joint_blocks.") and k.endswith(".x_block.attn2.qkv.weight")))
    if attn2_layers != tuple(cfg.x_block_self_attn_layers):
        raise ValueError(
            f"checkpoint has dual-attention (attn2) blocks at layers {list(attn2_layers)} "
            f"but cfg.x_block_self_attn_layers is {list(cfg.x_block_self_attn_layers)} — "
            "build the config with x_block_self_attn_layers matching the checkpoint "
            "(sd35_medium_config for the published SD3.5-medium)")
    has_qk_norm = any(k.startswith("joint_blocks.") and k.endswith(".attn.ln_q.weight")
                      for k in sd)
    if has_qk_norm != cfg.qk_norm:
        raise ValueError(
            f"checkpoint {'has' if has_qk_norm else 'lacks'} q/k RMS-norm weights "
            f"(attn.ln_q/ln_k) but cfg.qk_norm is {cfg.qk_norm} — use the SD3.5 configs "
            "for SD3.5 checkpoints")

    out: dict[str, torch.Tensor] = {}
    w = to_f32(sd["x_embedder.proj.weight"])  # (dim, C, p, p)
    out["x_in.weight"] = w.permute(0, 2, 3, 1).reshape(w.shape[0], -1)
    out["x_in.bias"] = to_f32(sd["x_embedder.proj.bias"])
    out["pos_embed.table"] = to_f32(sd["pos_embed"]).reshape(-1, cfg.hidden_size)
    for src, dst in (("context_embedder", "context_in"),
                     ("t_embedder.mlp.0", "time_in.in_layer"),
                     ("t_embedder.mlp.2", "time_in.out_layer"),
                     ("y_embedder.mlp.0", "vector_in.in_layer"),
                     ("y_embedder.mlp.2", "vector_in.out_layer"),
                     ("final_layer.adaLN_modulation.1", "final_mod"),
                     ("final_layer.linear", "final_proj")):
        _param(out, sd, src, dst)
    for i in range(cfg.depth):
        xb, cb, d = f"joint_blocks.{i}.x_block", f"joint_blocks.{i}.context_block", f"blocks.{i}"
        _param(out, sd, f"{xb}.adaLN_modulation.1", f"{d}.x_adaln.lin")
        _attn_in(out, sd, f"{xb}.attn", f"{d}.x_attn_in", cfg)
        _param(out, sd, f"{xb}.attn.proj", f"{d}.x_attn_proj")
        _param(out, sd, f"{xb}.mlp.fc1", f"{d}.x_mlp_in")
        _param(out, sd, f"{xb}.mlp.fc2", f"{d}.x_mlp_out")
        if i in attn2_layers:
            _attn_in(out, sd, f"{xb}.attn2", f"{d}.x_attn_in2", cfg)
            _param(out, sd, f"{xb}.attn2.proj", f"{d}.x_attn2_proj")
        _param(out, sd, f"{cb}.adaLN_modulation.1", f"{d}.ctx_adaln.lin")
        _attn_in(out, sd, f"{cb}.attn", f"{d}.ctx_attn_in", cfg)
        if i != cfg.depth - 1:  # the last block's context side is pre-only
            _param(out, sd, f"{cb}.attn.proj", f"{d}.ctx_attn_proj")
            _param(out, sd, f"{cb}.mlp.fc1", f"{d}.ctx_mlp_in")
            _param(out, sd, f"{cb}.mlp.fc2", f"{d}.ctx_mlp_out")
    return out
