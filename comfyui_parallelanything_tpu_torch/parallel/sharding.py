"""FSDP and tensor-parallel execution over a ``Mesh`` of sharded weights.

The JAX package places sharded pytrees and lets GSPMD insert the all-gathers (FSDP)
or partition the contractions (TP). The port's orchestrator is single-controller
(``parallel/mesh.py``), so it runs them itself on module skeletons:

- a **skeleton** is a copy of the model on one device whose replicated weights are
  that device's placed tensors and whose sharded weights are empty placeholders of
  the same dtype (what a forward reads of a weight before its module runs: its
  dtype and device);
- **FSDP** (ZeRO-3, ``fsdp_replicas``): one skeleton per data-axis device. A
  forward pre-hook on each module that owns sharded weights gathers them from
  every shard's device to the skeleton's (peer copies into their places, in mesh
  order, making the weight in the port's layout); a forward hook puts the
  placeholders back. A device holds
  1/N of the sharded weights plus one module's gathered weights at a time. The
  gathered weight is the placed one bit for bit, so FSDP's forward is the
  replicated forward's;
- **TP** (``tp_replicas``): one skeleton per data-axis index, on the first device
  of its model-axis row. A ``Linear`` or ``Conv2d`` whose weight is sharded over
  the model axis on an output axis runs its slice (with its slice of the bias) on
  each row device, and the slices are concatenated on the lead; sharded on an input axis, each row device
  multiplies its slice of the input by its slice of the weight, each partial
  product comes back in the layer's dtype (so a bf16 partial is already rounded),
  and the partials are summed on the lead in device order in f32, the bias added
  once, the sum rounded again to the layer's dtype. GSPMD partitions the same
  contractions and all-reduces bf16 partials; the numbers agree up to the summation
  order and these roundings.
  Any other sharded weight (a norm scale, a convolution's kernel axis, a grouped
  convolution) is gathered on the lead by the FSDP hooks.

Every copy between devices is ``.to(device, non_blocking=True)``; between
positions of a mesh that share a device it is no copy at all.
"""

from __future__ import annotations

import copy
from typing import Any

import torch
import torch.nn.functional as F

from .mesh import AXIS_DATA, AXIS_MODEL, Mesh, Placed, ShardedParams


def _placeholder(e: Placed, device: torch.device) -> torch.nn.Parameter:
    return torch.nn.Parameter(torch.empty(0, dtype=e.dtype, device=device),
                              requires_grad=False)


def _skeleton(module: torch.nn.Module, placed: ShardedParams, pos: tuple,
              device: torch.device) -> tuple[torch.nn.Module, dict]:
    """A copy of ``module`` on ``device`` holding mesh position ``pos``'s replicated
    tensors and a placeholder for each sharded weight. Returns it and the
    placeholders by name."""
    memo: dict[int, Any] = {}
    holders: dict[str, torch.nn.Parameter] = {}
    for name, p in module.named_parameters():
        e = placed[name]
        if e.sharded:
            holders[name] = memo[id(p)] = _placeholder(e, device)
        else:
            memo[id(p)] = torch.nn.Parameter(e.parts[pos], requires_grad=p.requires_grad)
    for b in module.buffers():
        memo[id(b)] = b.detach().to(device)
    return copy.deepcopy(module, memo), holders


def _owners(names) -> dict[str, list[str]]:
    """Parameter names grouped by the path of the module that holds them."""
    out: dict[str, list[str]] = {}
    for name in names:
        owner, _, leaf = name.rpartition(".")
        out.setdefault(owner, []).append(leaf)
    return out


def _gather_hooks(skel: torch.nn.Module, placed: ShardedParams, names, holders: dict,
                  pos: tuple, device: torch.device) -> None:
    """Gather ``names`` into their modules just before each runs; drop them after."""
    for owner, leaves in _owners(names).items():
        sub = skel.get_submodule(owner) if owner else skel
        full = [(leaf, placed[f"{owner}.{leaf}" if owner else leaf],
                 holders[f"{owner}.{leaf}" if owner else leaf]) for leaf in leaves]

        def pre(mod, args, full=full):
            for leaf, e, _ in full:
                mod._parameters[leaf] = e.gather(placed.mesh, pos, device)

        def post(mod, args, out, full=full):
            for leaf, _, holder in full:
                mod._parameters[leaf] = holder

        sub.register_forward_pre_hook(pre)
        sub.register_forward_hook(post, always_call=True)


def fsdp_replicas(module: torch.nn.Module, placed: ShardedParams) -> list[torch.nn.Module]:
    """One skeleton per device of the data axis, each gathering its sharded
    weights module by module (ZeRO-3)."""
    out = []
    for pos in placed.mesh.positions():
        device = placed.mesh.devices[pos]
        skel, holders = _skeleton(module, placed, pos, device)
        _gather_hooks(skel, placed, list(holders), holders, pos, device)
        out.append(skel)
    return out


# -- tensor parallelism -------------------------------------------------------------


def _split_dims(e: Placed) -> tuple[str, int] | None:
    """Which side of its contraction a sharded Linear/Conv weight splits:
    ("in", index among the JAX input axes) or ("out", index among the output axes);
    None for an axis that is neither (a convolution's kernel axes)."""
    lay = e.layout
    if lay.kind == "dense":
        return ("in", e.dim) if e.dim < lay.n_in else ("out", e.dim - lay.n_in)
    if lay.kind == "conv":
        nk = len(lay.jax_shape) - 2
        if e.dim == nk:
            return "in", 0
        if e.dim == nk + 1:
            return "out", 0
    return None


class _TPForward:
    """The split forward of one ``Linear`` or ``Conv2d``: weight shards in the
    port's layout, one per model-axis device of the row, and the bias on the lead."""

    def __init__(self, mod, e: Placed, side: str, k: int, mesh: Mesh, row: tuple,
                 model_ax: int):
        self.mod = mod
        self.side, self.k, self.lay = side, k, e.layout
        self.devices, self.shards = [], []
        idx = list(row)
        for m in range(mesh.devices.shape[model_ax]):
            idx[model_ax] = m
            self.devices.append(mesh.devices[tuple(idx)])
            self.shards.append(self._torch_shard(e.parts[tuple(idx)]))
        self.lead = self.devices[0]
        self.conv = isinstance(mod, torch.nn.Conv2d)

    def _torch_shard(self, part: torch.Tensor) -> torch.Tensor:
        lay = self.lay
        if lay.kind == "dense":
            n_in = lay.n_in
            in_flat = 1
            for s in part.shape[:n_in]:
                in_flat *= s
            return part.reshape(in_flat, -1).t()  # (out slice, in slice): a view
        return part.permute(3, 2, 0, 1)  # (kh, kw, in, out) → (out, in, kh, kw)

    def _one(self, x, w, b=None):
        if self.conv:
            return self.mod._conv_forward(x, w, b)
        return F.linear(x, w, b)

    def _bias_slice(self, bias, m: int):
        """Model-axis index m's slice of the bias, where the output axis splits."""
        n = len(self.devices)
        if self.conv:
            return bias.chunk(n)[m]
        out_shape = self.lay.jax_shape[self.lay.n_in:]
        return bias.reshape(out_shape).chunk(n, dim=self.k)[m].reshape(-1)

    def __call__(self, x):
        lead, bias = self.lead, self.mod.bias
        if self.side == "in":
            if self.conv:
                xs = x.chunk(len(self.devices), dim=1)
            else:
                in_shape = self.lay.jax_shape[:self.lay.n_in]
                xv = x.reshape(*x.shape[:-1], *in_shape)
                dim = x.ndim - 1 + self.k
                xs = [c.reshape(*x.shape[:-1], -1)
                      for c in xv.chunk(len(self.devices), dim=dim)]
            parts = [self._one(xi.to(d, non_blocking=True), w)
                     for xi, d, w in zip(xs, self.devices, self.shards)]
            # Each partial is in the layer's dtype (a bf16 one already rounded); they
            # are summed on the lead in device order, in f32, with the bias, and the
            # sum is rounded to that dtype again. The unsplit layer rounds once.
            out = parts[0].float()
            for p in parts[1:]:
                out = out + p.to(lead, non_blocking=True).float()
            if bias is not None:
                out = out + (bias.reshape(1, -1, *([1] * (out.ndim - 2))) if self.conv
                             else bias).float()
            return out.to(parts[0].dtype)
        # Each device computes its output slice with its slice of the bias.
        parts = [self._one(x.to(d, non_blocking=True), w,
                           None if bias is None else
                           self._bias_slice(bias, m).to(d, non_blocking=True)
                           ).to(lead, non_blocking=True)
                 for m, (d, w) in enumerate(zip(self.devices, self.shards))]
        if self.conv:
            return torch.cat(parts, dim=1)
        out_shape = self.lay.jax_shape[self.lay.n_in:]
        lead_dims = x.shape[:-1]
        views = []
        for p in parts:
            sub = list(out_shape)
            sub[self.k] = -1
            views.append(p.reshape(*lead_dims, *sub))
        return torch.cat(views, dim=len(lead_dims) + self.k).reshape(*lead_dims, -1)


def tp_replicas(module: torch.nn.Module, placed: ShardedParams) -> list[torch.nn.Module]:
    """One skeleton per data-axis index, on its model-axis row's first device;
    Linear/Conv2d layers with a model-sharded weight compute split over the row,
    any other sharded weight is gathered on the lead."""
    mesh = placed.mesh
    d_ax, m_ax = mesh.axis_index(AXIS_DATA), mesh.axis_index(AXIS_MODEL)
    split: dict[str, tuple[str, int]] = {}
    for name, e in placed.entries.items():
        owner, _, leaf = name.rpartition(".")
        mod = module.get_submodule(owner) if owner else module
        if not e.sharded or leaf != "weight":
            continue
        if isinstance(mod, torch.nn.Linear) or (
                isinstance(mod, torch.nn.Conv2d) and mod.groups == 1):
            side = _split_dims(e)
            if side is not None:
                split[name] = side
    # A split layer's bias is added whole on the lead: gathered there if sharded.
    out = []
    for d in range(mesh.devices.shape[d_ax]):
        pos = [0] * mesh.devices.ndim
        pos[d_ax] = d
        pos = tuple(pos)
        lead = mesh.devices[pos]
        skel, holders = _skeleton(module, placed, pos, lead)
        _gather_hooks(skel, placed, [n for n in holders if n not in split], holders, pos, lead)
        for name, (side, k) in split.items():
            owner = name.rpartition(".")[0]
            mod = skel.get_submodule(owner) if owner else skel
            fwd = _TPForward(mod, placed[name], side, k, mesh, pos, m_ax)
            mod.forward = fwd
        out.append(skel)
    return out
