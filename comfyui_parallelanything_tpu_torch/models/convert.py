"""Published FLUX checkpoints → the port's ``FluxModel`` state dict, the fp8 upcast
and LoRA baking (counterpart of ``comfyui_parallelanything_tpu/models/convert.py``).

- fp8 on disk: public FLUX files often store the block weights as
  ``float8_e4m3fn``. Every tensor is cast to the dtype of the port parameter it
  becomes (the blocks' linears to ``cfg.dtype``, the modulation and final linears
  and the QK-norm scales to float32), in torch on the tensor's own device: a
  checkpoint on the card never makes a host round trip.
- LoRA: ``bake_lora`` merges ``W + strength · (alpha / rank) · up @ down`` into
  the checkpoint-layout weights before conversion, kohya
  (``lora_down``/``lora_up``/``alpha``) and PEFT (``lora_A``/``lora_B``) alike.
  Where the JAX bake upcasts the whole dict to float32 numpy at once, the port's
  returns a read-through view: each merged weight is computed in float32 when it
  is read, and every other tensor passes as stored, so a converter that reads
  each key once holds one merged weight at a time beyond its output.
- Layout: the port keeps torch's ``(out, in)`` linear layout, so the BFL fused
  qkv ``(3·H·D, in)`` is taken as it is: its rows are ordered (3, H, D), which is
  the order ``flux._split_qkv`` reads (the JAX package reorders the same rows into
  a ``(in, 3, H, D)`` kernel).
"""

from __future__ import annotations

import logging
from collections.abc import Iterator, Mapping
from typing import Any

import numpy as np
import torch

from .flux import FluxConfig, FluxModel

logger = logging.getLogger(__name__)

_FP8_DTYPE_NAMES = (
    "float8_e4m3fn",
    "float8_e4m3fnuz",
    "float8_e5m2",
    "float8_e5m2fnuz",
    "float8_e8m0fnu",
)
# kohya flattens dots to underscores and prefixes the module tree's root.
LORA_PREFIXES = ("lora_unet_", "lora_transformer_", "lora_te1_", "lora_te2_",
                 "lora_te_", "lora_")


def is_float8_dtype(dtype: Any) -> bool:
    """fp8 detection by name, for torch and numpy (ml_dtypes) dtypes alike."""
    return any(name in str(dtype) for name in _FP8_DTYPE_NAMES)


def to_tensor(t: Any, dtype: torch.dtype | None = None, device=None) -> torch.Tensor:
    """A checkpoint tensor (torch, or numpy including ml_dtypes' bf16/fp8) as a
    torch tensor of ``dtype`` (default: float32) on ``device`` (default: its own;
    numpy lands on the CPU). fp8, bf16 and f16 upcast exactly."""
    dtype = torch.float32 if dtype is None else dtype
    if not torch.is_tensor(t):
        a = np.asarray(t)
        if a.dtype.kind not in "biuf" or "bfloat16" in str(a.dtype) or is_float8_dtype(a.dtype):
            a = a.astype(np.float32)  # ml_dtypes' bfloat16 / float8: not torch-readable
        t = torch.from_numpy(np.ascontiguousarray(a))
    return t.detach().to(device=device if device is not None else t.device, dtype=dtype)


# ---------------------------------------------------------------------------
# LoRA baking (bake before convert; reference patch_model at 992-1004)
# ---------------------------------------------------------------------------


def _lora_pairs(lora_sd: Mapping[str, Any]) -> dict[str, tuple[Any, Any, float | None]]:
    """(down/A, up/B, alpha) per base key from either naming convention: kohya
    ``{base}.lora_down.weight`` / ``.lora_up.weight`` / ``.alpha`` or PEFT
    ``{base}.lora_A.weight`` / ``.lora_B.weight``. A base missing either factor
    is dropped."""
    pairs: dict[str, dict[str, Any]] = {}
    for key, tensor in lora_sd.items():
        for down_tag, up_tag in ((".lora_down.weight", ".lora_up.weight"),
                                 (".lora_A.weight", ".lora_B.weight")):
            if key.endswith(down_tag):
                pairs.setdefault(key[: -len(down_tag)], {})["down"] = tensor
                break
            if key.endswith(up_tag):
                pairs.setdefault(key[: -len(up_tag)], {})["up"] = tensor
                break
        else:
            if key.endswith(".alpha"):
                pairs.setdefault(key[: -len(".alpha")], {})["alpha"] = tensor
    out = {}
    for base, parts in pairs.items():
        if "down" in parts and "up" in parts:
            alpha = parts.get("alpha")
            out[base] = (parts["down"], parts["up"],
                         float(to_tensor(alpha)) if alpha is not None else None)
    return out


def strip_lora_prefix(base: str) -> str:
    for prefix in LORA_PREFIXES:
        if base.startswith(prefix):
            return base[len(prefix):]
    return base


def _lora_target(base: str, keys: Mapping[str, None],
                 by_normalized: dict[str, str]) -> str | None:
    """The state-dict key a LoRA base names: ``{base}.weight`` or ``base`` itself,
    else the kohya underscore form (root prefix stripped), else a unique suffix
    match (a sub-dict such as a text tower under its checkpoint prefix)."""
    for cand in (f"{base}.weight", base):
        if cand in keys:
            return cand
    stripped = strip_lora_prefix(base)
    key = by_normalized.get(f"{stripped}_weight".replace(".", "_"))
    if key is None:
        key = by_normalized.get(stripped.replace(".", "_"))
    if key is None:
        want = "_" + f"{stripped}_weight".replace(".", "_")
        hits = [v for k, v in by_normalized.items() if k.endswith(want)]
        key = hits[0] if len(hits) == 1 else None
    return key


def _delta_shape(down, up, rank: int) -> tuple[int, ...]:
    if len(down.shape) == 4:
        return (int(up.shape[0]), int(down.shape[1]),
                *torch.broadcast_shapes(tuple(up.shape[2:]), tuple(down.shape[2:])))
    return (int(up.shape[0]), int(down.shape[1]))


class BakedStateDict(Mapping):
    """A state dict with LoRA deltas merged on read: ``sd[key]`` is the stored
    tensor, or for a LoRA target ``W + Σ scale · up @ down`` in float32 on W's
    device (a conv target takes the delta over its kernel window). ``deltas``
    maps each target key to its ``(down, up, scale)`` list, in the order baked."""

    def __init__(self, base: Mapping[str, Any], deltas: dict[str, list[tuple]]):
        self._base = base
        self.deltas = deltas

    def __getitem__(self, key: str):
        w = self._base[key]
        parts = self.deltas.get(key)
        if not parts:
            return w
        w = to_tensor(w)
        for down, up, scale in parts:
            d, u = to_tensor(down, device=w.device), to_tensor(up, device=w.device)
            rank = d.shape[0]
            if w.ndim == 4:
                delta = torch.einsum("or...,ri...->oi...", u.reshape(u.shape[0], rank, *u.shape[2:]),
                                     d.reshape(rank, d.shape[1], *d.shape[2:]))
            else:
                delta = u @ d
            w = w + scale * delta
        return w

    def __iter__(self) -> Iterator[str]:
        return iter(self._base)

    def __len__(self) -> int:
        return len(self._base)

    def __contains__(self, key) -> bool:
        return key in self._base


def bake_lora(state_dict: Mapping[str, Any], lora_sd: Mapping[str, Any],
              strength: float = 1.0) -> BakedStateDict:
    """``state_dict`` with ``lora_sd`` merged: ``W += strength · (alpha / rank) ·
    up @ down`` (scale ``strength`` when the LoRA has no alpha). Matching as in
    the JAX package: ``{base}.weight``, then the kohya underscore form with its
    root prefix stripped, then a unique suffix. Unmatched LoRA keys, and a LoRA
    whose delta does not fit its target (a 1×1 LoRA on a k×k conv), are logged and
    skipped, as the reference prints and continues (1002-1004). Baking onto a
    ``BakedStateDict`` stacks: the deltas apply in order. The result is a view
    (see the module docstring); ``dict(...)`` materialises it."""
    keys = dict.fromkeys(state_dict)
    by_normalized = {k.replace(".", "_"): k for k in keys}
    deltas: dict[str, list[tuple]] = {}
    if isinstance(state_dict, BakedStateDict):
        base, deltas = state_dict._base, {k: list(v) for k, v in state_dict.deltas.items()}
    else:
        base = state_dict
    unmatched = []
    for lora_base, (down, up, alpha) in _lora_pairs(lora_sd).items():
        target = _lora_target(lora_base, keys, by_normalized)
        rank = int(down.shape[0])
        if target is None or tuple(base[target].shape) != _delta_shape(down, up, rank):
            unmatched.append(lora_base)
            continue
        scale = strength * ((alpha / rank) if alpha is not None else 1.0)
        deltas.setdefault(target, []).append((down, up, scale))
    if unmatched:
        logger.warning("bake_lora: %d LoRA key(s) had no base match and were skipped: %s",
                       len(unmatched), unmatched[:5])
    return BakedStateDict(base, deltas)


# ---------------------------------------------------------------------------
# FLUX (official BFL layout → models/flux.py)
# ---------------------------------------------------------------------------


def flux_key_map(cfg: FluxConfig) -> dict[str, str]:
    """Every ``FluxModel`` state-dict key → the BFL checkpoint key it comes from."""
    m: dict[str, str] = {}

    def linear(dst: str, src: str) -> None:
        m[f"{dst}.weight"], m[f"{dst}.bias"] = f"{src}.weight", f"{src}.bias"

    for name in ("img_in", "txt_in"):
        linear(name, name)
    for emb in ("time_in", "vector_in") + (("guidance_in",) if cfg.guidance_embed else ()):
        for layer in ("in_layer", "out_layer"):
            linear(f"{emb}.{layer}", f"{emb}.{layer}")
    for i in range(cfg.depth):
        d = f"double_blocks.{i}"
        for s in ("img", "txt"):
            linear(f"{d}.{s}_mod.lin", f"{d}.{s}_mod.lin")
            linear(f"{d}.{s}_attn_qkv", f"{d}.{s}_attn.qkv")
            for n in ("query_norm", "key_norm"):
                m[f"{d}.{s}_attn_norm.{n}"] = f"{d}.{s}_attn.norm.{n}.scale"
            linear(f"{d}.{s}_attn_proj", f"{d}.{s}_attn.proj")
            linear(f"{d}.{s}_mlp_in", f"{d}.{s}_mlp.0")
            linear(f"{d}.{s}_mlp_out", f"{d}.{s}_mlp.2")
    for i in range(cfg.depth_single_blocks):
        s = f"single_blocks.{i}"
        for name in ("modulation.lin", "linear1", "linear2"):
            linear(f"{s}.{name}", f"{s}.{name}")
        for n in ("query_norm", "key_norm"):
            m[f"{s}.norm.{n}"] = f"{s}.norm.{n}.scale"
    # final_layer.adaLN_modulation.1 emits (shift, scale), final_mod's two chunks.
    linear("final_mod", "final_layer.adaLN_modulation.1")
    linear("final_proj", "final_layer.linear")
    return m


def convert_flux_checkpoint(state_dict: Mapping[str, Any], cfg: FluxConfig,
                            lora_sd: Mapping[str, Any] | None = None,
                            lora_strength: float = 1.0, device=None) -> dict[str, torch.Tensor]:
    """Official FLUX state dict (flux1-dev/schnell layout, any stored dtype) → the
    ``FluxModel`` state dict, each tensor in its parameter's dtype on ``device``
    (default: where the checkpoint tensor lies). ``lora_sd``, when given, is baked
    first. Pass the result to ``build_flux(cfg, state_dict=..., assign=True)``."""
    sd = bake_lora(state_dict, lora_sd, lora_strength) if lora_sd else state_dict
    with torch.device("meta"):
        like = FluxModel(cfg).state_dict()
    out = {}
    for dst, src in flux_key_map(cfg).items():
        t = to_tensor(sd[src], like[dst].dtype, device)
        if t.shape != like[dst].shape:
            raise ValueError(f"{src}: checkpoint shape {tuple(t.shape)} does not match "
                             f"{dst} {tuple(like[dst].shape)} (wrong cfg?)")
        out[dst] = t
    return out
