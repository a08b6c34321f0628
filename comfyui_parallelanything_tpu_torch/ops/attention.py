"""Attention with pluggable backends (counterpart of
``comfyui_parallelanything_tpu/ops/attention.py``). All functions take (B, S, H, D)
q/k/v ("BSHD") and return (B, S, H, D).

- ``"xla"`` — plain math attention with an f32 softmax; shapes whose logits would
  exceed ``_CHUNK_THRESHOLD`` elements are served by the chunked path instead.
- ``"xla_chunked"`` — the same math over blocks of queries, so the (B, H, S_q, S_k)
  logits never exist at once.
- ``"pallas"`` — the hand-written flash-attention kernel
  (``ops/kernels/flash_attention.py``; the name matches the JAX package's so
  ``resolved_backends()`` reads the same on both sides).
- ``"auto"`` — a CUDA call that one of the kernel's variants takes goes to the
  kernel; every other call (a CPU tensor, or on CUDA a head dim above 512 or
  float64) goes to the xla family, as the JAX package's ``auto`` sends what its
  kernel cannot take. The rule is the kernel's own ``kernel_takes`` (which
  ``kernel_variant`` applies first), checked before the launch. There is no
  measured table yet that could send a CUDA shape the kernel takes elsewhere.

``sequence_parallel(mesh, axis, method)`` routes every ``attention`` call made in
its context (on this thread) over the mesh's sequence axis
(``parallel/sequence.py``: ring or Ulysses); ``attention_local`` never does.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from .kernels.flash_attention import flash_attention, kernel_takes

_BACKEND_NAMES = ("auto", "xla", "xla_chunked", "pallas")

_BACKEND = "auto"

_RESOLVED: set[str] = set()

_SEQ_CTX = threading.local()


@contextlib.contextmanager
def sequence_parallel(mesh, axis: str = "seq", method: str = "ring"):
    """Route every ``attention`` call in this context over ``mesh``'s ``axis``:
    ``method="ring"`` or ``"ulysses"`` (``parallel/sequence.py``). Sequence lengths
    must divide the axis size, and for Ulysses the head count too."""
    prev = getattr(_SEQ_CTX, "cfg", None)
    _SEQ_CTX.cfg = (mesh, axis, method)
    try:
        yield
    finally:
        _SEQ_CTX.cfg = prev


def sequence_ctx_key() -> tuple | None:
    """The active ``sequence_parallel`` context as a hashable (mesh, axis, method),
    or None: what a cache of anything run under it must be keyed on."""
    return getattr(_SEQ_CTX, "cfg", None)

# Above this many f32 logits elements (B*H*S_q*S_k; 2**27 ≈ 512 MB) the
# materializing path is routed to the chunked one.
_CHUNK_THRESHOLD = 2**27


def resolved_backends() -> tuple[str, ...]:
    """Backends that have actually served ``attention_local`` calls in this process
    ("auto" never appears here)."""
    return tuple(sorted(_RESOLVED))


def set_attention_backend(name: str) -> None:
    global _BACKEND
    if name not in _BACKEND_NAMES:
        raise ValueError(f"unknown attention backend {name!r}")
    _BACKEND = name


def get_attention_backend() -> str:
    return _BACKEND


def _xla_attention(q, k, v, scale):
    # Logits in the input dtype, softmax in f32, probabilities back in v's dtype —
    # the JAX package's plain path step for step.
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    probs = torch.softmax(logits.float(), dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _xla_chunked_attention(q, k, v, scale):
    """Plain attention over blocks of queries: only (B, H, block_q, S_k) logits exist
    at a time. Block size as in the JAX package (a multiple of 16, at least 16)."""
    B, Sq, H, _ = q.shape
    per_row = B * H * k.shape[1]
    block_q = max(16, min(Sq, _CHUNK_THRESHOLD // max(per_row, 1)) // 16 * 16)
    if block_q >= Sq:
        return _xla_attention(q, k, v, scale)
    return torch.cat(
        [_xla_attention(q[:, i : i + block_q], k, v, scale) for i in range(0, Sq, block_q)],
        dim=1,
    )


def attention_local(q, k, v, scale: float | None = None) -> torch.Tensor:
    """Backend-dispatched attention."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    backend = _BACKEND
    if backend == "auto":
        backend = "pallas" if q.is_cuda and kernel_takes(q, k, v) else "xla"
    if backend == "xla" and q.shape[0] * q.shape[2] * q.shape[1] * k.shape[1] > _CHUNK_THRESHOLD:
        backend = "xla_chunked"
    _RESOLVED.add(backend)
    if backend == "pallas":
        return flash_attention(q, k, v, scale=scale)
    if backend == "xla_chunked":
        return _xla_chunked_attention(q, k, v, scale)
    return _xla_attention(q, k, v, scale)


def attention(q, k, v, scale: float | None = None) -> torch.Tensor:
    """Scaled dot-product attention on (B, S, H, D) inputs; over a sequence mesh
    inside a ``sequence_parallel`` context."""
    seq_cfg = getattr(_SEQ_CTX, "cfg", None)
    if seq_cfg is not None:
        if scale is None:
            scale = q.shape[-1] ** -0.5
        from ..parallel.sequence import sharded_attention_inline

        mesh, axis, method = seq_cfg
        return sharded_attention_inline(q, k, v, mesh, axis, method, scale)
    return attention_local(q, k, v, scale)
