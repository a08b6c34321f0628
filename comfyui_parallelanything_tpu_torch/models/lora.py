"""Per-request LoRA as data: low-rank factor maps over a model's parameters
(counterpart of ``comfyui_parallelanything_tpu/models/lora.py``).

A factor map ``{param_path: (a, b)}`` gives ``W_eff = W + b @ a`` at each path,
strength and alpha/rank folded into ``b``. Paths are the port's state-dict names
(``double_blocks.0.img_attn_qkv.weight``), and every target is a torch weight in
its ``(out, in)`` layout: for a target of shape ``(m, k)`` the pair is
``a: (r, k)``, ``b: (m, r)``, and a checkpoint LoRA pair (``up @ down``) maps to
``a = down``, ``b = scale · up``. (The JAX package addresses flax ``kernel``
leaves, ``(in, out)``, so its pair for the same LoRA is ``(b.T, a.T)`` of the
port's.) Targets above two dims (convolutions) are addressed through their
``(shape[0], prod(rest))`` flattening.

``params`` is a module (its state dict), a flat ``{path: tensor}`` dict or a
nested dict joined by dots. ``run_sampler(lora=...)`` hands the factors to a serving
lane when a scheduler takes the run (``sampling/compiled.lane_step_program`` adds
each lane's ``x·aᵀ·bᵀ``); its inline legs run the eagerly merged model
(``lora_model``), as the JAX runner's do.
"""

from __future__ import annotations

import copy
import dataclasses
import logging
from collections.abc import Mapping

import torch
import torch.nn.functional as F

from .convert import _lora_pairs, strip_lora_prefix, to_tensor

logger = logging.getLogger(__name__)


def flatten_params(params, prefix: str = "") -> dict[str, torch.Tensor]:
    """A module, a flat dict or a nested dict → ``{dotted path: tensor}``."""
    if isinstance(params, torch.nn.Module):
        return {f"{prefix}{k}": v for k, v in params.state_dict().items()}
    out = {}
    for k, v in params.items():
        if isinstance(v, Mapping):
            out.update(flatten_params(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def get_path(params: Mapping, path: str):
    """The tensor at ``path`` in a flat or nested dict (KeyError if none)."""
    node, rest = params, path
    while rest not in node:
        head, _, rest = rest.partition(".")
        if not rest:
            raise KeyError(path)
        node = node[head]
    return node[rest]


def set_path(params: Mapping, path: str, value) -> dict:
    """A new dict with ``value`` at ``path``, sharing every untouched subtree."""
    new = dict(params)
    if path in params:
        new[path] = value
        return new
    head, _, rest = path.partition(".")
    if not rest or head not in params:
        raise KeyError(path)
    new[head] = set_path(params[head], rest, value)
    return new


def _normalized(path: str) -> str:
    norm = path.replace(".", "_")
    return norm[: -len("_weight")] if norm.endswith("_weight") else norm


def extract_lora_factors(lora_sd, params, strength: float = 1.0, unmatched_out=None,
                         aliases: Mapping[str, str] | None = None):
    """LoRA state dict → ``{param_path: (a, b)}`` over ``params``, float32 on the
    LoRA tensors' device.

    Matching as ``convert.bake_lora``'s (root prefix stripped, the underscore form,
    a unique suffix), against the parameter paths. ``aliases`` maps checkpoint
    keys to parameter paths where the two differ (``convert.flux_key_map(cfg)``
    inverted: the BFL ``img_mlp.0`` is the port's ``img_mlp_in``), so a LoRA
    written against the checkpoint reaches every renamed target. A target that is
    not 2-D, a LoRA whose factors do not fit it, and an unmatched key are logged
    and skipped; ``unmatched_out`` (a list) collects their base keys."""
    flat = flatten_params(params)
    by_norm: dict[str, list[str]] = {}

    def add(norm: str, path: str) -> None:
        hits = by_norm.setdefault(norm, [])
        if path not in hits:
            hits.append(path)

    for path in flat:
        add(_normalized(path), path)
    for ckpt, path in (aliases or {}).items():
        if path in flat:
            add(_normalized(ckpt), path)

    out: dict[str, tuple] = {}
    unmatched = []
    for base, (down, up, alpha) in _lora_pairs(lora_sd).items():
        norm = strip_lora_prefix(base).replace(".", "_")
        hits = by_norm.get(norm)
        if not hits:
            suffix = [v for k, v in by_norm.items() if k.endswith("_" + norm)]
            hits = suffix[0] if len(suffix) == 1 else None
        if not hits or len(hits) != 1:
            unmatched.append(base)
            continue
        w = flat[hits[0]]
        d, u = to_tensor(down), to_tensor(up)
        if w.ndim != 2 or d.ndim != 2 or u.ndim != 2 \
                or tuple(w.shape) != (u.shape[0], d.shape[1]):
            unmatched.append(base)
            continue
        scale = float(strength) * ((alpha / d.shape[0]) if alpha is not None else 1.0)
        out[hits[0]] = (d, u * scale)
    if unmatched:
        logger.warning("extract_lora_factors: %d LoRA key(s) had no 2-D base match and "
                       "were skipped: %s", len(unmatched), unmatched[:5])
        if unmatched_out is not None:
            unmatched_out.extend(unmatched)
    return out


def combine_factors(maps):
    """Several factor maps → one, by rank concatenation:
    Σⱼ bⱼ @ aⱼ == cat(b) @ cat(a)."""
    maps = [m for m in maps if m]
    if not maps:
        return {}
    if len(maps) == 1:
        return dict(maps[0])
    out: dict[str, tuple] = {}
    for m in maps:
        for path, (a, b) in m.items():
            if path in out:
                a0, b0 = out[path]
                out[path] = (torch.cat([a0, a], dim=0), torch.cat([b0, b], dim=1))
            else:
                out[path] = (a, b)
    return out


def lora_signature(factors, params):
    """Hashable ``((path, m, k), ...)`` sorted by path, or None when a factor pair
    does not line up with a parameter (``(m, k)`` its ``(shape[0], prod(rest))``
    flattening)."""
    if not factors:
        return ()
    flat = flatten_params(params)
    sig = []
    for path in sorted(factors):
        a, b = factors[path]
        w = flat.get(path)
        if w is None or w.ndim < 2:
            return None
        m, k = int(w.shape[0]), int(w[0].numel())
        if a.ndim != 2 or b.ndim != 2 or a.shape[1] != k or b.shape[0] != m \
                or a.shape[0] != b.shape[1]:
            return None
        sig.append((path, m, k))
    return tuple(sig)


def pad_rank(a, b, r_max: int):
    """Zero-pad a pair to rank ``r_max`` (zero rank slots add an exact zero)."""
    r = a.shape[0]
    if r == r_max:
        return a, b
    return F.pad(a, (0, 0, 0, r_max - r)), F.pad(b, (0, r_max - r))


def _merged(w: torch.Tensor, a, b) -> torch.Tensor:
    """``w + b @ a`` with the delta cast to w's dtype first, as the JAX merge."""
    delta = to_tensor(b, device=w.device) @ to_tensor(a, device=w.device)
    return w + delta.reshape(w.shape).to(w.dtype)


def merge_lora_params(params, factors):
    """A new dict with ``W + b @ a`` at each factor path, sharing every untouched
    tensor."""
    out = params
    for path, (a, b) in factors.items():
        out = set_path(out, path, _merged(get_path(out, path), a, b))
    return out


def factorize_bake(base_params, baked_params, max_rank: int = 64, rtol: float = 1e-5):
    """Low-rank factors recovered from an eager bake: each changed tensor's delta
    (flattened to ``(shape[0], prod(rest))``) by SVD, kept when the truncation
    reproduces it. ``{path: (a, b)}``, or None when the bake is not representable:
    different trees, a changed tensor below two dims (a bias), or a delta above
    ``max_rank`` (a partial map would disagree with the bake). The test is exact, as
    the JAX function's: a bake stored in bf16 or f16 carries its rounding at full rank,
    so it has no factors and its prompts run inline."""
    flat0, flat1 = flatten_params(base_params), flatten_params(baked_params)
    if set(flat0) != set(flat1):
        return None
    out: dict[str, tuple] = {}
    for path, w0 in flat0.items():
        w1 = flat1[path]
        if tuple(w0.shape) != tuple(w1.shape):
            return None
        d = to_tensor(w1) - to_tensor(w0)
        if not bool(d.any()):
            continue
        if d.ndim < 2:
            return None
        d2 = d.reshape(d.shape[0], -1)
        u, s, vt = torch.linalg.svd(d2, full_matrices=False)
        cut = float(s[0]) * rtol if s.numel() else 0.0
        r = int((s > cut).sum())
        if r == 0 or r > max_rank:
            return None
        b, a = u[:, :r] * s[:r], vt[:r]
        if not torch.allclose(b @ a, d2, rtol=1e-4, atol=max(cut, 1e-7)):
            return None
        out[path] = (a, b)
    return out or None


def _merged_module(module: torch.nn.Module, factors) -> torch.nn.Module:
    """A copy of ``module`` whose factor paths hold the merged weights; every other
    parameter and buffer is shared with ``module``, which stays untouched."""
    memo = {id(t): t for t in (*module.parameters(), *module.buffers())}
    for path, (a, b) in factors.items():
        try:
            w = module.get_parameter(path)
        except AttributeError as e:
            raise KeyError(path) from e
        memo[id(w)] = torch.nn.Parameter(_merged(w.detach(), a, b), requires_grad=False)
    return copy.deepcopy(module, memo)


def lora_model(model, factors):
    """The model with ``factors`` merged, for the inline sampler legs; the base
    model is untouched. A ``DiffusionModel`` or ``nn.Module`` keeps its kind; a
    ``ParallelModel`` merges onto its lead replica's module and returns a plain
    ``DiffusionModel`` on the lead device (the merged model runs unsharded, as the
    JAX ``lora_model`` gives a chain)."""
    if not factors:
        return model
    from ..parallel.orchestrator import ParallelModel
    from .api import DiffusionModel

    if isinstance(model, ParallelModel):
        return DiffusionModel(
            module=_merged_module(model._lead_replica(), factors),
            name=f"{getattr(model, 'name', 'model')}+lora", config=model.model_config,
            pipeline_spec=model._pipeline_spec)
    if isinstance(model, DiffusionModel):
        return dataclasses.replace(model, module=_merged_module(model.module, factors),
                                   name=f"{model.name}+lora")
    if isinstance(model, torch.nn.Module):
        return _merged_module(model, factors)
    raise TypeError("per-request LoRA needs a model with addressable parameters; "
                    f"{type(model).__name__} exposes none")
