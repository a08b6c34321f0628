"""Pure split arithmetic: weight normalization, weighted batch splits, memory-blended
weights, pipeline block ranges, and batch chunking of tensor trees.

Counterpart of ``comfyui_parallelanything_tpu/parallel/split.py``; the integer
arithmetic is the same function for function, so both packages split a batch
identically (largest-remainder apportionment that always sums to the total, in
place of the reference's ``max(1, int(batch*w))`` which can overflow it). Arrays
here are ``torch.Tensor`` (or numpy arrays); trees are dicts, lists and tuples.
"""

from __future__ import annotations

from collections.abc import Mapping, Sequence
from typing import Any

import numpy as np
import torch

# --------------------------------------------------------------------------------------
# Weights
# --------------------------------------------------------------------------------------


def normalize_weights(percentages: Sequence[float]) -> tuple[float, ...] | None:
    """``pct_i / sum(pct)``; None when ``sum <= 0`` (the caller aborts)."""
    total = float(sum(percentages))
    if total <= 0.0:
        return None
    return tuple(float(p) / total for p in percentages)


def blend_memory_weights(
    user_weights: Sequence[float],
    free_bytes: Sequence[int],
    alpha: float = 0.7,
) -> tuple[float, ...]:
    """Blend user weights with live free-memory shares: ``alpha*user + (1-alpha)*mem``,
    renormalized. When no device reports memory (CPU-only chain), returns the user
    weights unchanged."""
    if len(user_weights) != len(free_bytes):
        raise ValueError("user_weights and free_bytes must have equal length")
    total_free = float(sum(free_bytes))
    if total_free <= 0.0:
        return tuple(float(w) for w in user_weights)
    blended = [
        alpha * float(w) + (1.0 - alpha) * (float(f) / total_free)
        for w, f in zip(user_weights, free_bytes)
    ]
    norm = normalize_weights(blended)
    if norm is None:
        raise ValueError("blended weights sum to <= 0")
    return norm


def blend_speed_weights(
    user_weights: Sequence[float],
    step_times_s: Sequence[float],
    alpha: float = 0.7,
) -> tuple[float, ...]:
    """Blend user weights with per-device speed shares:
    ``alpha*user + (1-alpha)*inverse-step-time share``. Equal step times (a
    homogeneous chain) and zero/negative times return the user weights unchanged."""
    if len(user_weights) != len(step_times_s):
        raise ValueError("user_weights and step_times_s must have equal length")
    times = [float(t) for t in step_times_s]
    if not times or min(times) <= 0.0 or max(times) == min(times):
        return tuple(float(w) for w in user_weights)
    inv = [1.0 / t for t in times]
    total = sum(inv)
    blended = [
        alpha * float(w) + (1.0 - alpha) * (s / total)
        for w, s in zip(user_weights, inv)
    ]
    norm = normalize_weights(blended)
    if norm is None:
        raise ValueError("blended weights sum to <= 0")
    return norm


# --------------------------------------------------------------------------------------
# Integer apportionment
# --------------------------------------------------------------------------------------


def largest_remainder_split(total: int, weights: Sequence[float]) -> tuple[int, ...]:
    """Apportion ``total`` items over ``weights`` so sizes are >= 0 and sum exactly to
    ``total`` (largest-remainder / Hamilton method); ties go to the earlier link."""
    if total < 0:
        raise ValueError(f"total must be >= 0, got {total}")
    n = len(weights)
    if n == 0:
        return ()
    wsum = float(sum(weights))
    if wsum <= 0.0:
        weights = [1.0] * n
        wsum = float(n)
    quotas = [total * float(w) / wsum for w in weights]
    sizes = [int(q) for q in quotas]
    short = total - sum(sizes)
    order = sorted(range(n), key=lambda i: (-(quotas[i] - sizes[i]), i))
    for i in order[:short]:
        sizes[i] += 1
    return tuple(sizes)


def weighted_batch_split(batch: int, weights: Sequence[float]) -> tuple[int, ...]:
    """Per-device batch sizes for the data-parallel path; 0 means the device is
    inactive for this batch."""
    return largest_remainder_split(batch, weights)


def block_ranges(n_blocks: int, weights: Sequence[float]) -> tuple[tuple[int, int], ...]:
    """Contiguous half-open ``[start, end)`` block ranges per device, proportional to
    weights; a zero-length range means the device holds no pipeline stage."""
    sizes = largest_remainder_split(n_blocks, weights)
    ranges = []
    start = 0
    for s in sizes:
        ranges.append((start, start + s))
        start += s
    return tuple(ranges)


# --------------------------------------------------------------------------------------
# Tree batch chunking
# --------------------------------------------------------------------------------------


def _is_array(x: Any) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def is_arraylike(v: Any) -> bool:
    """Duck-typed array check (anything with a shape and a dtype)."""
    return hasattr(v, "shape") and hasattr(v, "dtype")


def tree_map(fn, tree: Any) -> Any:
    """Apply ``fn`` to every leaf of a tree of dicts, lists and tuples."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def pad_leaf(a, pad: int):
    """Pad dim0 by repeating the last element (sliced off after the split call)."""
    if pad == 0:
        return a
    return torch.cat([a, a[-1:].expand(pad, *a.shape[1:])], dim=0)


def slice_padded(out, batch: int, padded: int):
    """Un-pad: slice dim0 back to ``batch`` on every array leaf that carries the
    padded batch dimension."""
    if padded == batch:
        return out

    def fix(leaf):
        if is_arraylike(leaf) and leaf.ndim > 0 and leaf.shape[0] == padded:
            return leaf[:batch]
        return leaf

    return tree_map(fix, out)


def batch_size_of(x: Any) -> int:
    """Batch size of a forward input: dim0 of an array, else dim0 of the first array
    inside a list/tuple, else 1."""
    if _is_array(x) and x.ndim > 0:
        return int(x.shape[0])
    if isinstance(x, (list, tuple)):
        for item in x:
            if _is_array(item) and item.ndim > 0:
                return int(item.shape[0])
    return 1


def _split_array(x: Any, sizes: Sequence[int]) -> list[Any]:
    offsets = np.cumsum([0] + list(sizes))
    return [x[offsets[i] : offsets[i + 1]] for i in range(len(sizes))]


def split_tree(x: Any, sizes: Sequence[int]) -> list[Any]:
    """Split a value into len(sizes) chunks along dim0: arrays split on dim0,
    lists/tuples element-wise, dicts value-wise; anything else is replicated."""
    n = len(sizes)
    if _is_array(x) and x.ndim > 0 and x.shape[0] == sum(sizes):
        return _split_array(x, sizes)
    if isinstance(x, (list, tuple)):
        per_item = [split_tree(item, sizes) for item in x]
        return [type(x)(item[i] for item in per_item) for i in range(n)]
    if isinstance(x, Mapping):
        per_key = {k: split_tree(v, sizes) for k, v in x.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return [x] * n


def split_kwargs(
    kwargs: Mapping[str, Any], batch: int, sizes: Sequence[int]
) -> list[dict[str, Any]]:
    """Per-chunk kwargs: a kwarg splits iff it is an array whose dim0 == batch;
    everything else broadcasts to every chunk."""
    n = len(sizes)
    out: list[dict[str, Any]] = [dict() for _ in range(n)]
    for k, v in kwargs.items():
        if _is_array(v) and v.ndim > 0 and v.shape[0] == batch:
            for i, chunk in enumerate(_split_array(v, sizes)):
                out[i][k] = chunk
        else:
            for i in range(n):
                out[i][k] = v
    return out


def partition_kwargs(kwargs: Mapping[str, Any]) -> tuple[dict, dict]:
    """Split kwargs into (arrays, everything else)."""
    arrays, other = {}, {}
    for k, v in kwargs.items():
        (arrays if _is_array(v) else other)[k] = v
    return arrays, other


def static_kwargs_key(static: Mapping[str, Any]) -> tuple:
    """Hashable key for a dict of non-array kwargs; unhashable values key by id()."""
    items = []
    for k in sorted(static):
        v = static[k]
        try:
            hash(v)
        except TypeError:
            v = id(v)
        items.append((k, v))
    return tuple(items)


def concat_results(chunks: Sequence[Any]) -> Any:
    """Concatenate per-device outputs along dim0: arrays concat on dim0,
    tuple/list/dict outputs element-wise, non-array outputs pass through from
    chunk 0."""
    if not chunks:
        raise ValueError("no chunks to concatenate")
    first = chunks[0]
    if isinstance(first, torch.Tensor):
        return torch.cat(list(chunks), dim=0)
    if isinstance(first, np.ndarray):
        return np.concatenate(list(chunks), axis=0)
    if isinstance(first, (list, tuple)):
        return type(first)(
            concat_results([c[i] for c in chunks]) for i in range(len(first))
        )
    if isinstance(first, Mapping):
        return {k: concat_results([c[k] for c in chunks]) for k in first}
    return first
