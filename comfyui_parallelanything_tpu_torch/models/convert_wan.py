"""Wan video-DiT checkpoints (the public Wan2.x layout) → ``wan.WanModel`` state
dicts (counterpart of ``comfyui_parallelanything_tpu/models/convert_wan.py``).

Every tensor is upcast to f32; torch ``Linear`` weights keep their layout. Public
→ port names:

- ``patch_embedding`` — a Conv3d with kernel == stride == patch_size; its
  (O, C, pt, ph, pw) weight becomes the patchify linear over the (pt, ph, pw, C)
  token order ``WanModel.prepare`` emits
- ``text_embedding.{0,2}`` / ``time_embedding.{0,2}`` → ``text_in`` / ``text_hidden``,
  ``time_in`` / ``time_hidden``; ``time_projection.1`` → ``time_projection``
- ``blocks.{i}.self_attn.{q,k,v,o}`` → ``blocks.{i}.self_{q,k,v,o}``;
  ``self_attn.norm_{q,k}`` → ``self_{q,k}_norm``; ``cross_attn.*`` likewise
- ``blocks.{i}.norm3`` (the affine pre-norm; norm1/norm2 have no weights),
  ``ffn.{0,2}`` → ``ffn_in`` / ``ffn_out``, ``modulation`` (1, 6, D) keeps its name
- ``head.head`` → ``head_proj``; ``head.modulation`` (1, 2, D) → ``head_modulation.bias``

The Wan2.1-style i2v CLIP-image branch converts when the config has ``img_dim``:
``img_emb.proj.{0,1,3,4}`` → ``img_ln_in`` / ``img_in`` / ``img_hidden`` /
``img_ln_out``, ``cross_attn.{k,v}_img`` → ``cross_{k,v}_img`` and
``cross_attn.norm_k_img`` → ``cross_k_img_norm``. Without ``img_dim`` those keys are
ignored (a t2v config loading an i2v file), as are ema/optimizer sidecars.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any

import torch

from .convert_text import to_f32
from .convert_vae import _param
from .wan import WanConfig


def convert_wan_checkpoint(state_dict: Mapping[str, Any],
                           cfg: WanConfig) -> dict[str, torch.Tensor]:
    """Public Wan state dict → ``wan.WanModel`` state dict (pass to
    ``build_wan(cfg, state_dict=...)``). A missing key raises ``KeyError``."""
    sd = state_dict
    out: dict[str, torch.Tensor] = {}
    w = to_f32(sd["patch_embedding.weight"])  # (O, C, pt, ph, pw)
    out["patch_embedding.weight"] = w.permute(0, 2, 3, 4, 1).reshape(w.shape[0], -1)
    out["patch_embedding.bias"] = to_f32(sd["patch_embedding.bias"])
    for src, dst in (("text_embedding.0", "text_in"), ("text_embedding.2", "text_hidden"),
                     ("time_embedding.0", "time_in"), ("time_embedding.2", "time_hidden"),
                     ("time_projection.1", "time_projection"), ("head.head", "head_proj")):
        _param(out, sd, src, dst)
    out["head_modulation.bias"] = to_f32(sd["head.modulation"])
    if cfg.img_dim is not None:
        for src, dst in (("img_emb.proj.0", "img_ln_in"), ("img_emb.proj.1", "img_in"),
                         ("img_emb.proj.3", "img_hidden"), ("img_emb.proj.4", "img_ln_out")):
            _param(out, sd, src, dst)
    for i in range(cfg.depth):
        t, d = f"blocks.{i}", f"blocks.{i}"
        for ours, theirs in (("self", "self_attn"), ("cross", "cross_attn")):
            for proj in "qkvo":
                _param(out, sd, f"{t}.{theirs}.{proj}", f"{d}.{ours}_{proj}")
            for nrm in "qk":
                out[f"{d}.{ours}_{nrm}_norm.weight"] = to_f32(
                    sd[f"{t}.{theirs}.norm_{nrm}.weight"])
        _param(out, sd, f"{t}.norm3", f"{d}.norm3")
        _param(out, sd, f"{t}.ffn.0", f"{d}.ffn_in")
        _param(out, sd, f"{t}.ffn.2", f"{d}.ffn_out")
        out[f"{d}.modulation"] = to_f32(sd[f"{t}.modulation"])
        if cfg.img_dim is not None:
            _param(out, sd, f"{t}.cross_attn.k_img", f"{d}.cross_k_img")
            _param(out, sd, f"{t}.cross_attn.v_img", f"{d}.cross_v_img")
            out[f"{d}.cross_k_img_norm.weight"] = to_f32(
                sd[f"{t}.cross_attn.norm_k_img.weight"])
    return out
