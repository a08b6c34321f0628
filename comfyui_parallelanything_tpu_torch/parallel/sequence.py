"""Sequence parallelism: ring attention and Ulysses over a mesh's ``seq`` axis.

Counterpart of ``comfyui_parallelanything_tpu/parallel/sequence.py``, where both
schemes are ``shard_map`` programs over a ``seq`` mesh axis. The port's
orchestrator is single-controller (``parallel/mesh.py``): the model's forward runs
on one device, only attention is split, and each call scatters q/k/v over the axis's
devices and gathers the output back to q's device. Moves between devices are peer
copies (``.to(dev, non_blocking=True)``); between positions of the axis that share
a device they are no copy at all.

- **Ring** (JAX ``_ring_attention_local``): q's sequence shard i stays on device
  i; the k/v blocks pass device to device n times (i → i+1, JAX's ``ppermute``)
  while each device runs JAX's f32 online softmax (running max, normaliser,
  accumulator) over the block it holds. Plain torch: K1 returns no log-sum-exp, so
  the ring cannot merge its outputs.
- **Ulysses** (JAX ``_ulysses_local``): tokens → heads, then full-sequence
  attention per head slice through ``attention_local`` (never ``attention``, which
  would re-enter the context), then heads → tokens. The all-to-all hands device j
  head slice j of every sequence shard, concatenated on S: on the lead that is the
  head-slice view ``q[:, :, j·H/n:(j+1)·H/n]``, sent to device j as one copy (no
  copy where device j is the lead's). On a CUDA tensor ``attention_local`` is K1,
  whose ``kernel_takes`` admits the strided view.

Both compute ``ops.attention.attention_local``'s attention up to the floating-point
order of the softmax (Ulysses: the same per-(batch, head) attention).
"""

from __future__ import annotations

from typing import Literal

import torch

from .mesh import AXIS_SEQ, Mesh

Method = Literal["ring", "ulysses"]


def _ring(q, k, v, devices, scale: float) -> torch.Tensor:
    """q (B, S, H, D) split over ``devices`` on S; k/v blocks passed around the
    ring; the online softmax in f32, as JAX's per-shard body."""
    n = len(devices)
    lead = q.device
    B, _, H, D = q.shape
    qf = [c.to(d, non_blocking=True).float() for c, d in zip(q.chunk(n, dim=1), devices)]
    kb = [c.to(d, non_blocking=True) for c, d in zip(k.chunk(n, dim=1), devices)]
    vb = [c.to(d, non_blocking=True) for c, d in zip(v.chunk(n, dim=1), devices)]
    m = [torch.full((B, H, t.shape[1]), -torch.inf, dtype=torch.float32, device=d)
         for t, d in zip(qf, devices)]
    l_ = [torch.zeros((B, H, t.shape[1]), dtype=torch.float32, device=d)
          for t, d in zip(qf, devices)]
    acc = [torch.zeros((B, H, t.shape[1], D), dtype=torch.float32, device=d)
           for t, d in zip(qf, devices)]
    for step in range(n):
        for i in range(n):
            logits = torch.einsum("bqhd,bkhd->bhqk", qf[i], kb[i].float()) * scale
            new_m = torch.maximum(m[i], logits.amax(dim=-1))
            correction = torch.exp(m[i] - new_m)
            p = torch.exp(logits - new_m[..., None])
            l_[i] = l_[i] * correction + p.sum(dim=-1)
            acc[i] = acc[i] * correction[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p, vb[i].float())
            m[i] = new_m
        if step < n - 1:  # every device's block to the next device
            kb = [kb[(i - 1) % n].to(devices[i], non_blocking=True) for i in range(n)]
            vb = [vb[(i - 1) % n].to(devices[i], non_blocking=True) for i in range(n)]
    outs = [(a / li[..., None]).permute(0, 2, 1, 3).to(q.dtype) for a, li in zip(acc, l_)]
    return torch.cat([o.to(lead, non_blocking=True) for o in outs], dim=1)


def _ulysses(q, k, v, devices, scale: float) -> torch.Tensor:
    """Head slice j of q/k/v to device j, full-sequence attention there, the
    slices back to q's device concatenated on H."""
    from ..ops.attention import attention_local

    n = len(devices)
    lead = q.device
    h = q.shape[2] // n
    outs = []
    for j, d in enumerate(devices):
        sl = slice(j * h, (j + 1) * h)
        qj, kj, vj = (t[:, :, sl].to(d, non_blocking=True) for t in (q, k, v))
        outs.append(attention_local(qj, kj, vj, scale=scale))
    return torch.cat([o.to(lead, non_blocking=True) for o in outs], dim=2)


_METHODS = {"ring": _ring, "ulysses": _ulysses}


def _validate_shapes(q, k, n_shards: int, method: str) -> None:
    """Clear errors for shapes the axis cannot split. Both q's and k/v's sequence
    lengths must shard (cross-attention k/v carries the *text* length — e.g. 77
    CLIP tokens won't shard 4-way; pad the context to a multiple)."""
    for name, t in (("q", q), ("k/v", k)):
        if t.shape[1] % n_shards:
            raise ValueError(
                f"sequence-parallel attention: {name} sequence length {t.shape[1]} "
                f"not divisible by the seq mesh axis ({n_shards}); pad it to a "
                f"multiple"
            )
    if method == "ulysses" and q.shape[2] % n_shards:
        raise ValueError(
            f"ulysses needs num_heads ({q.shape[2]}) divisible by the "
            f"sequence-shard count ({n_shards})"
        )


def sharded_attention_inline(q, k, v, mesh: Mesh, axis: str, method: str,
                             scale: float) -> torch.Tensor:
    """Sequence-parallel attention inside a model's forward (what
    ``ops.attention.attention`` calls under a ``sequence_parallel`` context): the
    output on q's device."""
    if method not in _METHODS:
        raise ValueError(f"unknown sequence-parallel method {method!r}")
    devices = mesh.axis_devices(axis)
    _validate_shapes(q, k, len(devices), method)
    return _METHODS[method](q, k, v, devices, float(scale))


def sequence_parallel_attention(q, k, v, mesh: Mesh, *, axis: str = AXIS_SEQ,
                                method: Method = "ring", scale: float | None = None
                                ) -> torch.Tensor:
    """Attention over (B, S, H, D) inputs with S split over ``mesh``'s ``axis``:
    ``method="ring"`` passes k/v blocks around the axis, ``"ulysses"`` computes
    full-sequence attention per head slice. The output lands on q's device."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return sharded_attention_inline(q, k, v, mesh, axis, method, scale)
