"""Text-encoder checkpoints in their public layouts → ``text_encoders`` state dicts
(counterpart of ``comfyui_parallelanything_tpu/models/convert_text.py``).

- **HF CLIPTextModel** (``text_model.*``, any wrapper prefix): SD1.5's
  ``cond_stage_model.transformer``, SDXL's ``conditioner.embedders.0.transformer``,
  FLUX's clip_l file.
- **OpenCLIP** (``transformer.resblocks.*`` with a fused ``in_proj``): SDXL's
  ``conditioner.embedders.1.model``.
- **HF T5 encoder** (``encoder.block.*``): FLUX/WAN t5xxl files; decoder and
  lm-head keys of full-model checkpoints are ignored.

Every tensor is upcast to f32 here (fp8/f16/bf16 included); loading into a module
casts it to the module's storage dtype. Torch ``Linear`` weights keep their
(out, in) layout; OpenCLIP's raw ``text_projection`` matrix (hidden, proj) is
transposed into a ``Linear``.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any

import torch

from .convert import to_tensor
from .text_encoders import CLIPTextConfig, T5Config


def to_f32(t: Any) -> torch.Tensor:
    """A checkpoint tensor (torch or numpy, any float dtype) as an f32 CPU tensor."""
    return to_tensor(t, torch.float32, "cpu")


def _linear(out: dict, sd: Mapping, key: str, dst: str, bias: bool = True) -> None:
    out[f"{dst}.weight"] = to_f32(sd[f"{key}.weight"])
    if bias and f"{key}.bias" in sd:
        out[f"{dst}.bias"] = to_f32(sd[f"{key}.bias"])


def _ln(out: dict, sd: Mapping, key: str, dst: str) -> None:
    out[f"{dst}.weight"] = to_f32(sd[f"{key}.weight"])
    out[f"{dst}.bias"] = to_f32(sd[f"{key}.bias"])


def _strip(state_dict: Mapping[str, Any], anchor: str) -> dict:
    """Select the encoder subtree by locating ``anchor`` (a key every layout of the
    family contains), treating everything before it as the wrapper prefix and
    stripping that prefix from all keys that carry it."""
    for k in state_dict:
        if k.endswith(anchor):
            prefix = k[: len(k) - len(anchor)]
            if not prefix:
                return dict(state_dict)
            return {key[len(prefix):]: v for key, v in state_dict.items()
                    if key.startswith(prefix)}
    return dict(state_dict)


def convert_clip_text_checkpoint(state_dict: Mapping[str, Any],
                                 cfg: CLIPTextConfig) -> dict[str, torch.Tensor]:
    """HF CLIPTextModel layout (``text_model.*``, any wrapper prefix) →
    ``CLIPTextModel`` state dict."""
    sd = _strip(state_dict, "text_model.embeddings.token_embedding.weight")
    out = {
        "tok_emb.weight": to_f32(sd["text_model.embeddings.token_embedding.weight"]),
        "pos_emb": to_f32(sd["text_model.embeddings.position_embedding.weight"]),
    }
    _ln(out, sd, "text_model.final_layer_norm", "final_ln")
    for i in range(cfg.num_layers):
        t, d = f"text_model.encoder.layers.{i}", f"layers.{i}"
        _ln(out, sd, f"{t}.layer_norm1", f"{d}.ln1")
        for n in "qkv":
            _linear(out, sd, f"{t}.self_attn.{n}_proj", f"{d}.{n}")
        _linear(out, sd, f"{t}.self_attn.out_proj", f"{d}.out")
        _ln(out, sd, f"{t}.layer_norm2", f"{d}.ln2")
        _linear(out, sd, f"{t}.mlp.fc1", f"{d}.fc1")
        _linear(out, sd, f"{t}.mlp.fc2", f"{d}.fc2")
    if cfg.projection_dim is not None:
        out["text_proj.weight"] = to_f32(sd["text_projection.weight"])
    return out


def convert_open_clip_checkpoint(state_dict: Mapping[str, Any],
                                 cfg: CLIPTextConfig) -> dict[str, torch.Tensor]:
    """OpenCLIP text-tower layout (``transformer.resblocks.*``, fused qkv
    ``in_proj``) → ``CLIPTextModel`` state dict."""
    # Anchor on a key unique to the OpenCLIP layout: a combined SDXL checkpoint
    # also holds the HF tower's ...token_embedding.weight.
    sd = _strip(state_dict, "positional_embedding")
    if "token_embedding.weight" not in sd:
        raise KeyError("token_embedding.weight not found — not an OpenCLIP text dict")
    H = cfg.hidden_size
    out = {
        "tok_emb.weight": to_f32(sd["token_embedding.weight"]),
        "pos_emb": to_f32(sd["positional_embedding"]),
    }
    _ln(out, sd, "ln_final", "final_ln")
    for i in range(cfg.num_layers):
        t, d = f"transformer.resblocks.{i}", f"layers.{i}"
        w = to_f32(sd[f"{t}.attn.in_proj_weight"])  # (3H, H)
        b = to_f32(sd[f"{t}.attn.in_proj_bias"])
        for j, n in enumerate("qkv"):
            out[f"{d}.{n}.weight"] = w[j * H : (j + 1) * H].clone()
            out[f"{d}.{n}.bias"] = b[j * H : (j + 1) * H].clone()
        _ln(out, sd, f"{t}.ln_1", f"{d}.ln1")
        _ln(out, sd, f"{t}.ln_2", f"{d}.ln2")
        _linear(out, sd, f"{t}.attn.out_proj", f"{d}.out")
        _linear(out, sd, f"{t}.mlp.c_fc", f"{d}.fc1")
        _linear(out, sd, f"{t}.mlp.c_proj", f"{d}.fc2")
    if cfg.projection_dim is not None:
        # A raw (hidden, proj) matrix, not a torch Linear.
        out["text_proj.weight"] = to_f32(sd["text_projection"]).T.contiguous()
    return out


def convert_t5_checkpoint(state_dict: Mapping[str, Any],
                          cfg: T5Config) -> dict[str, torch.Tensor]:
    """HF T5 v1.1 / UMT5 layout → ``T5Encoder`` state dict (encoder stack only)."""
    sd = _strip(state_dict, "encoder.final_layer_norm.weight")
    emb_key = "shared.weight" if "shared.weight" in sd else "encoder.embed_tokens.weight"
    out = {
        "tok_emb.weight": to_f32(sd[emb_key]),
        "final_ln.weight": to_f32(sd["encoder.final_layer_norm.weight"]),
    }
    rel = ".layer.0.SelfAttention.relative_attention_bias.weight"
    if cfg.per_layer_bias:
        for i in range(cfg.num_layers):
            out[f"rel_bias_{i}"] = to_f32(sd[f"encoder.block.{i}{rel}"])
    else:
        out["rel_bias"] = to_f32(sd[f"encoder.block.0{rel}"])
    for i in range(cfg.num_layers):
        t, d = f"encoder.block.{i}", f"blocks.{i}"
        out[f"{d}.ln1.weight"] = to_f32(sd[f"{t}.layer.0.layer_norm.weight"])
        for n in "qkvo":
            _linear(out, sd, f"{t}.layer.0.SelfAttention.{n}", f"{d}.{n}", bias=False)
        out[f"{d}.ln2.weight"] = to_f32(sd[f"{t}.layer.1.layer_norm.weight"])
        for n in ("wi_0", "wi_1", "wo"):
            _linear(out, sd, f"{t}.layer.1.DenseReluDense.{n}", f"{d}.{n}", bias=False)
    return out
