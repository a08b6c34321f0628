"""Weight-only int8 quantization for a model's weights (counterpart of
``comfyui_parallelanything_tpu/models/quantize.py``).

Symmetric per-output-channel int8: ``w ≈ q · scale`` with
``scale = max(|w|, 1e-12) / 127`` over every axis but the output channel and
``q = clip(round(w / scale), -127, 127)``. Only weights of rank 2 or more with at
least ``min_size`` (2**16) elements quantize; norms, biases and small tables keep
their dtype. A torch ``Linear``/``Conv`` weight holds its output channel on axis
0 (flax's kernels hold it last), so the port reduces over every axis but 0, and a
weight converted from the JAX package gets the JAX scales exactly. The one layout
that differs: the reference's attention projections are ``DenseGeneral`` kernels
whose output axes are (H, D) or (3, H, D), and its last-axis rule gives one scale
per head-dim index, shared by every head (and by q, k and v). The port's model
marks such a ``Linear`` with ``int8_row_groups`` (H or 3·H, the blocks its rows
fall into), and its rows share one scale per index within a block.

Each quantized weight becomes a parametrization (``torch.nn.utils.parametrize``):
the module holds the int8 payload (``parametrizations.<name>.original``) and its
f32 scales (a buffer), and every read of the attribute dequantizes to the
weight's original dtype inside the forward. So ``parallelize`` (which places
parameters and buffers), the pipeline stages (views over the same submodules) and
``compile_loop`` capture (the dequantize is ordinary ops in the captured graph)
take a quantized model unchanged, and only the int8 bytes and the scales stay
resident. There is no fused int8 GEMM: the JAX package has none (XLA dequantizes
in the traced program).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn.utils import parametrize

INT8_MIN_SIZE = 2**16


class Dequantize(nn.Module):
    """The parametrization of one quantized weight: int8 ``q`` → ``q · scale`` in
    ``dtype`` (the weight's dtype before quantization)."""

    def __init__(self, scale: torch.Tensor, dtype: torch.dtype, groups: int = 1):
        super().__init__()
        self.register_buffer("scale", scale)
        self.dtype = dtype
        self.groups = groups

    def forward(self, q: torch.Tensor) -> torch.Tensor:
        if self.groups == 1:
            return (q.to(torch.float32) * self.scale).to(self.dtype)
        w = q.to(torch.float32).unflatten(0, (self.groups, -1)) * self.scale
        return w.flatten(0, 1).to(self.dtype)


def int8_eligible(shape, min_size: int = INT8_MIN_SIZE) -> bool:
    """The rank and size rule deciding which weights quantize."""
    size = 1
    for s in shape:
        size *= int(s)
    return len(shape) >= 2 and size >= min_size


def quantize_tensor(w: torch.Tensor, groups: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """``(q, scale)`` of one weight: int8 ``q`` of ``w``'s shape and f32 ``scale``, one
    per output channel (axis 0). With ``groups`` > 1 the rows are ``groups`` blocks
    of the same channels, and ``scale`` is that of ``w`` viewed as
    ``(groups, rows // groups, ...)``: size 1 on every axis but the second."""
    wf = w.detach().to(torch.float32)
    if groups > 1:
        wf = wf.unflatten(0, (groups, -1))
    channel_axis = 1 if groups > 1 else 0
    reduce = tuple(i for i in range(wf.ndim) if i != channel_axis)
    absmax = wf.abs().amax(dim=reduce, keepdim=True)
    scale = torch.clamp(absmax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return q.reshape(w.shape), scale


def quantize_module(module: nn.Module, min_size: int = INT8_MIN_SIZE) -> nn.Module:
    """Quantize every eligible parameter of ``module`` in place (see the module
    docstring); a parameter already quantized is left as it is. Returns ``module``."""
    targets = []
    for mod in module.modules():
        if parametrize.is_parametrized(mod):
            continue
        for name, p in mod.named_parameters(recurse=False):
            if p.is_floating_point() and int8_eligible(p.shape, min_size):
                targets.append((mod, name, p))
    for mod, name, p in targets:
        groups = getattr(mod, "int8_row_groups", 1) if name == "weight" else 1
        q, scale = quantize_tensor(p, groups)
        delattr(mod, name)
        mod.register_parameter(name, nn.Parameter(q, requires_grad=False))
        parametrize.register_parametrization(mod, name, Dequantize(scale, p.dtype, groups),
                                             unsafe=True)
    return module


def param_bytes(module: nn.Module) -> int:
    """Stored bytes of a module's parameters and buffers: a quantized weight counts
    its int8 payload and its f32 scales."""
    tensors = list(module.parameters()) + list(module.buffers())
    return sum(t.numel() * t.element_size() for t in tensors)


def quantize_model(model, min_size: int = INT8_MIN_SIZE):
    """A ``DiffusionModel`` with its weights stored in int8, quantized in place
    (``quantize_module``; the JAX function returns a new parameter tree instead, so
    only one copy of the weights is ever held here). Returns ``model``; every
    consumer runs it unchanged."""
    quantize_module(model.module, min_size)
    return model
