"""Mixture-of-Experts FFN with expert-parallel sharding.

Counterpart of ``comfyui_parallelanything_tpu/ops/moe.py``: a switch-style top-1
MoE FFN on (B, S, D) tokens, with dense dispatch (every token against every expert,
a one-hot mask picks the winner: static shapes, no capacity overflow). The router
runs in f32 and the experts in the compute dtype; the output is the winner's FFN
scaled by its softmax probability. Parameters keep the flax names and layouts
(``gate`` (D, E), ``w_in`` (E, D, F), ``b_in`` (E, F), ``w_out`` (E, F, D),
``b_out`` (E, D)); ``models/convert_jax.from_jax_moe_params`` carries them over.

Expert parallelism (``expert_sharding``): the JAX package shards the expert axis
over a mesh axis and lets XLA run each device's experts and all-reduce the mask
combine. The port is single-controller (``parallel/mesh.py``): each device of the
axis holds its experts' slices, computes their mask-combined output, and the
partial outputs are summed on the input's device in device order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import AXIS_MODEL, Mesh

_EXPERT_LEAVES = ("w_in", "b_in", "w_out", "b_out")


def _experts(x, combine, w_in, b_in, w_out, b_out, dtype):
    """The mask-combined output of the experts given (leading dim E' of each): the
    experts in ``dtype``, the combine in the promotion of it and ``combine``'s."""
    xc = x.to(dtype)
    h = torch.einsum("bsd,edf->bsef", xc, w_in.to(dtype))
    h = F.gelu(h + b_in.to(dtype)[None, None], approximate="tanh")
    y = torch.einsum("bsef,efd->bsed", h, w_out.to(dtype))
    y = y + b_out.to(dtype)[None, None]
    pt = torch.promote_types(y.dtype, combine.dtype)
    return torch.einsum("bsed,bse->bsd", y.to(pt), combine.to(pt))


class MoEFFN(nn.Module):
    """Switch-style top-1 MoE FFN: ``forward(x (B, S, D)) -> (B, S, D)``.

    ``expert_shards``, set by ``expert_sharding``, runs the experts split over a
    mesh axis; otherwise every expert runs on the input's device."""

    def __init__(self, d_model: int, n_experts: int, d_ff: int,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        E, D, Fd = n_experts, d_model, d_ff
        self.n_experts, self.d_ff, self.dtype = E, Fd, dtype
        f32 = dict(dtype=torch.float32, device=device)
        self.gate = nn.Parameter(torch.empty(D, E, **f32))
        self.w_in = nn.Parameter(torch.empty(E, D, Fd, **f32))
        self.b_in = nn.Parameter(torch.zeros(E, Fd, **f32))
        self.w_out = nn.Parameter(torch.empty(E, Fd, D, **f32))
        self.b_out = nn.Parameter(torch.zeros(E, D, **f32))
        self.expert_shards: list[tuple[torch.device, tuple]] | None = None

    def forward(self, x):
        E = self.n_experts
        logits = x.float() @ self.gate.float()  # (B, S, E)
        probs = torch.softmax(logits, dim=-1)
        top = probs.argmax(dim=-1)  # (B, S)
        mask = F.one_hot(top, E).float()
        combine = (mask * probs).to(x.dtype)  # the top-1 prob at the winner
        if self.expert_shards is None:
            y = _experts(x, combine, self.w_in, self.b_in, self.w_out, self.b_out,
                         self.dtype)
            return y.to(x.dtype)
        lead = x.device
        parts = []
        start = 0
        for dev, (w_in, b_in, w_out, b_out) in self.expert_shards:
            e = w_in.shape[0]
            c = combine[..., start:start + e].to(dev, non_blocking=True)
            parts.append(_experts(x.to(dev, non_blocking=True), c, w_in, b_in, w_out,
                                  b_out, self.dtype).to(lead, non_blocking=True))
            start += e
        out = parts[0]
        for p in parts[1:]:  # the combine, summed on the lead in device order
            out = out + p
        return out.to(x.dtype)


def expert_sharding(module: MoEFFN, mesh: Mesh, axis: str = AXIS_MODEL) -> MoEFFN:
    """Place ``module``'s experts over ``mesh``'s ``axis``: the expert-batched
    tensors (leading dim E) split into one slice per device of the axis, the router
    gate stays where it is (replicated). A count that does not divide keeps the
    experts whole, as the JAX placement replicates them. Returns ``module``."""
    devices = mesh.axis_devices(axis)
    n = len(devices)
    if module.n_experts % n:
        module.expert_shards = None
        return module
    shards = []
    for i, dev in enumerate(devices):
        sl = slice(i * module.n_experts // n, (i + 1) * module.n_experts // n)
        shards.append((dev, tuple(getattr(module, k).detach()[sl].to(dev, copy=True)
                                  for k in _EXPERT_LEAVES)))
    module.expert_shards = shards
    return module
