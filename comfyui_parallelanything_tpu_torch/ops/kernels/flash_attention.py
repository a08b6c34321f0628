"""Flash attention on (B, S, H, D) tensors: the hand-written Hopper kernel K1.

Replaces the TPU kernel ``comfyui_parallelanything_tpu/ops/pallas/flash_attention.py``
(``flash_attention``, Pallas body ``_flash_kernel``): non-causal
``softmax(q·kᵀ·scale)·v``, forward only, f32 softmax state, output in the input
dtype, ``scale`` from the original head dim.

Bound on an H100 SXM at the FLUX-dev 1024² shape (B=1, S=4608, H=24, D=128): one
call does 4·B·H·S²·D = 261 GFLOP (0.264 ms at 989 TFLOP/s bf16) and must move
113 MB of q/k/v/o (0.034 ms at 3.35 TB/s), so it is bound by tensor-core
operations. The CUDA source (``csrc/flash_attention.cu``) keeps the S×S logits
out of device memory and reads the BSHD layout in place from strides (no
fold/transpose/pad copies). It has six variants, and ``kernel_variant`` picks
one from dtype, shape, strides and alignment before the launch:

- ``sm90`` (``csrc/flash_attention_sm90.cuh``): bf16 or f16, head dim ≤ 128 and a
  multiple of 8, every ``data_ptr`` 16-byte aligned, strides of dims 0–2 positive
  multiples of 8 elements (TMA's 16-byte rule), a positive scale (the kernel takes
  the softmax max on unscaled logits). TMA loads feed two ``wgmma`` consumer
  warpgroups from a warp-specialised producer. Every FLUX-dev call, and the UNets'
  head dims 40, 64 and 80.
- ``wide`` (``csrc/flash_attention_wide.cuh``): the same conditions with head dim
  in (128, 512]: the VAE mid-block's one 512-wide head and SD1.5's 160-wide heads.
  Two ``wgmma`` consumer warpgroups share 64 query rows and each keeps half of the
  output's columns; K and V tiles share one TMA ring. Bound at the FLUX VAE's 1024²
  shape (1, 16384, 1, 512) by operations: 550 GFLOP, 0.556 ms.
- ``mma``: the bf16/f16 calls that TMA cannot take (unaligned views, head dim not
  a multiple of 8, a scale ≤ 0) with head dim ≤ 256, ``mma.sync`` with K/V tiles
  staged through shared memory.
- ``d512``: the same calls with head dim in (256, 512], ``mma.sync`` on 8 warps
  that split the 64 × 512 output tile, with Q, K and V tiles and the block's
  logits in shared memory.
- ``tf32x3`` (``csrc/flash_attention_tf32x3.cu``): float32 with head dim ≤ 256 and a
  multiple of 4, every ``data_ptr`` 16-byte aligned, strides of dims 0–2 positive
  multiples of 4 elements (16 bytes), a positive scale. Error-compensated TF32 on
  the tensor cores: each operand is split into TF32 high and low parts and each
  product taken as three TF32 products (``wgmma``), held to the scalar kernel's
  f32 limits. Bound at the FLUX-dev shape in f32 by operations: 3 × 261 GFLOP at
  495 TFLOP/s, 1.581 ms. Every float32 call of the UNets and FLUX (head dims 40,
  64, 80, 128, 160).
- ``f32``: the float32 calls ``tf32x3`` cannot take (unaligned views, head dim not
  a multiple of 4 or in (256, 512], a scale ≤ 0), a scalar-FMA kernel in full f32.

``kernel_takes`` is false, and ``kernel_variant`` answers ``None``, for what no
variant takes (head dims above 512, float64, a strided head dim, an empty dim,
more than 65535 heads): ``ops/attention.py``'s ``auto`` sends those calls to the
xla family, and ``flash_attention`` raises ``ValueError`` on them. It computes
``flash_attention_plain`` only for CPU tensors. ``launches`` counts kernel
launches, ``launches_by_variant`` the same per variant.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

VARIANTS = ("sm90", "mma", "f32", "d512", "wide", "tf32x3")
launches = 0
launches_by_variant = dict.fromkeys(VARIANTS, 0)

MAX_HEAD_DIM = 512
MMA_MAX_HEAD_DIM = 256
SM90_MAX_HEAD_DIM = 128
TF32X3_MAX_HEAD_DIM = 256
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1, torch.float16: 2}
_VARIANT_CODES = {"mma": 0, "f32": 1, "sm90": 2, "d512": 3, "wide": 4, "tf32x3": 5}
_FN = None


def reset_launches() -> None:
    """Set ``launches`` and every count of ``launches_by_variant`` to 0."""
    global launches
    launches = 0
    for name in VARIANTS:
        launches_by_variant[name] = 0


def _tma_ready(t: torch.Tensor) -> bool:
    # TMA's rules: a 16-byte aligned start and strides that are multiples of 16 bytes.
    return t.data_ptr() % 16 == 0 and all(
        s > 0 and s * t.element_size() % 16 == 0 for s in t.stride()[:3])


def kernel_takes(q, k, v) -> bool:
    """Whether some variant of K1 takes a call on these (B, S, H, D) tensors: bf16,
    f16 or f32, head dim ≤ 512, no empty dim, at most 65535 heads, a contiguous head
    dim. Pure Python on dtype, shape and strides."""
    b, sq, h, d = q.shape
    return (q.dtype in _DTYPE_CODES and d <= MAX_HEAD_DIM and h <= 65535
            and min(b, sq, h, k.shape[1]) >= 1 and all(t.stride(-1) == 1 for t in (q, k, v)))


def kernel_variant(q, k, v, scale: float | None = None) -> str | None:
    """The variant of K1 that serves a call on these (B, S, H, D) tensors: ``sm90``,
    ``wide``, ``mma``, ``d512``, ``tf32x3`` or ``f32``, or ``None`` where none takes it
    (``kernel_takes``). Pure Python on dtype, shape, strides, ``data_ptr`` alignment
    and the scale (``None``: the default ``D**-0.5``), so it answers for CPU and meta
    tensors too."""
    if not kernel_takes(q, k, v):
        return None
    d = q.shape[-1]
    tma = (scale is None or scale > 0) and all(_tma_ready(t) for t in (q, k, v))
    if q.dtype == torch.float32:
        return "tf32x3" if tma and d % 4 == 0 and d <= TF32X3_MAX_HEAD_DIM else "f32"
    if tma and d % 8 == 0:
        return "sm90" if d <= SM90_MAX_HEAD_DIM else "wide"
    return "d512" if d > MMA_MAX_HEAD_DIM else "mma"


def flash_attention_plain(q, k, v, scale: float | None = None) -> torch.Tensor:
    """The plain PyTorch version: softmax attention in float32, cast to q's dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)


def _check(q, k, v) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention takes 4-D (B, S, H, D) q, k and v")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ in shape")
    b, _, h, d = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, h, d):
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree on B, H or D")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k and v must share one dtype")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")


def _kernel():
    global _FN
    if _FN is None:
        fn = build.load("flash_attention").pa_flash_attention_fwd
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32,
                       *([i64] * 12), ctypes.c_float, i32, ptr]
        fn.restype = i32
        _FN = fn
    return _FN


def flash_attention(q, k, v, scale: float | None = None) -> torch.Tensor:
    """Flash attention on (B, S, H, D) q/k/v; returns (B, S_q, H, D) in q's dtype."""
    _check(q, k, v)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    return _launch(q, k, v, scale, kernel_variant(q, k, v, scale))


def _launch(q, k, v, scale: float, variant: str) -> torch.Tensor:
    """Launch exactly ``variant`` of K1 on CUDA tensors. ``flash_attention`` calls it
    with ``kernel_variant``'s choice; a caller that names another variant (the
    card's smoke run and tests time and check ``mma`` on inputs ``sm90`` takes) gets
    that one, or a ``ValueError`` if it cannot take the call."""
    global launches
    _check(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, not {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(
            f"flash_attention kernel takes bfloat16, float16 or float32, not {q.dtype}")
    batch, seq_q, heads, head_dim = q.shape
    seq_k = k.shape[1]
    if head_dim > MAX_HEAD_DIM:
        raise ValueError(
            f"flash_attention kernel takes head dims up to {MAX_HEAD_DIM}, got {head_dim}")
    if min(seq_q, seq_k, batch, heads) < 1 or heads > 65535:
        raise ValueError(f"flash_attention kernel cannot take q {tuple(q.shape)}, k {tuple(k.shape)}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention kernel needs a contiguous head dim (stride(-1) == 1)")
    takes_f32 = variant in ("f32", "tf32x3")
    if variant not in _VARIANT_CODES or takes_f32 != (q.dtype == torch.float32):
        raise ValueError(f"variant {variant!r} cannot take {q.dtype} inputs")
    if variant == "mma" and head_dim > MMA_MAX_HEAD_DIM:
        raise ValueError(f"the mma variant takes head dims up to {MMA_MAX_HEAD_DIM}, "
                         f"got {head_dim}")
    if variant in ("sm90", "wide", "tf32x3") and kernel_variant(q, k, v, scale) != variant:
        dims = {"sm90": "head_dim <= 128 and a multiple of 8",
                "wide": "head_dim in (128, 512] and a multiple of 8",
                "tf32x3": "head_dim <= 256 and a multiple of 4"}[variant]
        raise ValueError(f"the {variant} variant needs {dims}, 16-byte aligned data, "
                         "strides that are multiples of 16 bytes and a positive scale")
    out = torch.empty((batch, seq_q, heads, head_dim), dtype=q.dtype, device=q.device)
    # The mma and d512 variants' 16-byte row loads need 8-element-aligned rows in
    # every input.
    vec_ok = head_dim % 8 == 0 and all(
        t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:3]) for t in (q, k, v)
    )
    fn = _kernel()
    # The launch needs q's device to be the current one; the context restores the
    # caller's current device afterwards.
    with torch.cuda.device(q.device):
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[q.dtype], _VARIANT_CODES[variant], batch, heads, seq_q, seq_k,
            head_dim, q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1),
            k.stride(2), v.stride(0), v.stride(1), v.stride(2), out.stride(0), out.stride(1),
            out.stride(2), float(scale), int(vec_ok),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_attention {variant} kernel launch failed with CUDA error {rc}")
    launches += 1
    launches_by_variant[variant] += 1
    return out
