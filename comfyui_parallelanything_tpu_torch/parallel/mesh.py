"""Device meshes and sharded weight placement.

Counterpart of ``comfyui_parallelanything_tpu/parallel/mesh.py``. The JAX package
maps a chain onto a ``jax.sharding.Mesh`` and lets XLA insert the collectives. The
port's orchestrator is single-controller, like the JAX package (one program drives
every local device) and like the reference (one process, a thread per device), so
it does not use FSDP2 or DTensor, which need one process per device. Here:

- a ``Mesh`` is a named numpy object array of ``torch.device`` (one device may
  appear more than once, so a mesh of shards can share one card);
- a placed weight is a ``Placed``: the tensor each mesh position holds, its shard
  in the JAX layout (``models/convert_jax.Layout``) or the whole tensor;
- a collective is an explicit peer copy (``.to(dev, non_blocking=True)``) followed
  by ``torch.cat`` or a sum in fixed device order (``parallel/sharding.py`` runs
  them).

Axis vocabulary, as in the JAX package: ``data`` (batch sharding), ``seq``
(sequence parallelism, ``parallel/sequence.py``), ``model`` (tensor parallelism),
``stage`` (pipeline stages).

The sharding policy is JAX's ``fsdp_spec``: the largest divisible axis of each
weight over the mesh axis, small (< 2**16 elements) or indivisible weights
replicated. It reads each weight's JAX shape (``convert_jax.jax_layouts``): a torch
``Linear`` weight is (out, in) where the flax kernel is (in, out), and on a square
projection ``max`` breaks the tie on the first axis, so the raw torch shape would
shard the other one. Parameters under ``parametrizations`` (int8 weights,
``models/quantize.py``) replicate.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable, Mapping, Sequence
from typing import Any

import numpy as np
import torch

from ..models.convert_jax import Layout, jax_layouts
from .split import tree_map

AXIS_DATA = "data"
AXIS_SEQ = "seq"
AXIS_MODEL = "model"
AXIS_STAGE = "stage"

# Cap on copy bytes in flight while placing a model: a synchronise every this many
# bytes, so placement's staging never holds more than the cap (JAX's
# ``_MAX_INFLIGHT_BYTES``).
_MAX_INFLIGHT_BYTES = 1 << 30


def mesh_axis_names() -> tuple[str, ...]:
    """The canonical axis vocabulary, outermost first."""
    return (AXIS_DATA, AXIS_SEQ, AXIS_MODEL, AXIS_STAGE)


class Mesh:
    """A named grid of devices: ``devices`` is a numpy object array of
    ``torch.device``, one axis per name in ``axis_names``."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-D device array for axes {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_index(self, axis: str) -> int:
        return self.axis_names.index(axis)

    def axis_devices(self, axis: str) -> list[torch.device]:
        """The devices along ``axis`` at index 0 of every other axis."""
        idx = [0] * self.devices.ndim
        ax = self.axis_index(axis)
        out = []
        for i in range(self.devices.shape[ax]):
            idx[ax] = i
            out.append(self.devices[tuple(idx)])
        return out

    def positions(self):
        """Every mesh position (an index tuple), in C order."""
        return list(np.ndindex(*self.devices.shape))

    def _key(self):
        return self.axis_names, self.devices.shape, tuple(str(d) for d in self.devices.flat)

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def build_mesh(devices, axis_shape: Mapping[str, int] | None = None) -> Mesh:
    """Build a ``Mesh`` over ``devices`` (``torch.device``s, device strings, or a
    ``DeviceChain``, whose de-duplicated devices are taken).

    ``axis_shape`` maps axis name → size, in the order given; the sizes must
    multiply to the device count. Default: a 1-D ``data`` mesh over all devices.
    """
    from .chain import DeviceChain, get_device

    if isinstance(devices, DeviceChain):
        devs = list(devices.validated().deduplicated().torch_devices())
    else:
        devs = [get_device(d) if isinstance(d, str) else torch.device(d) for d in devices]
    if not devs:
        raise ValueError("cannot build a mesh over zero devices")
    if axis_shape is None:
        axis_shape = {AXIS_DATA: len(devs)}
    sizes = tuple(int(s) for s in axis_shape.values())
    if int(np.prod(sizes)) != len(devs):
        raise ValueError(f"axis sizes {dict(axis_shape)} do not multiply to device count "
                         f"{len(devs)}")
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(sizes), tuple(axis_shape.keys()))


# -- the sharding policy ------------------------------------------------------------


def fsdp_spec(shape: tuple[int, ...], axis: str, n: int, min_size: int = 2**16) -> tuple:
    """The JAX ``PartitionSpec`` of one weight as a tuple: ``axis`` at the largest
    divisible dimension, ``None`` elsewhere; ``()`` (replicated) for a scalar, a
    weight under ``min_size`` elements, or one with no dimension divisible by
    ``n``. ``shape`` is the JAX shape (``convert_jax.Layout.jax_shape``)."""
    if not shape:
        return ()
    total = 1
    for s in shape:
        total *= s
    if total < min_size:
        return ()
    best = max(range(len(shape)), key=lambda i: (shape[i] % n == 0, shape[i]))
    if shape[best] % n:
        return ()
    spec: list = [None] * len(shape)
    spec[best] = axis
    return tuple(spec)


def _entries(params, axis: str | None = None, n: int = 1, min_size: int = 2**16
             ) -> dict[str, tuple[tuple[int, ...], torch.dtype, Layout, Any, tuple]]:
    """(torch shape, dtype, layout, tensor or None, spec) per parameter of a module or
    per entry of a mapping (a tensor, or a ``(shape, dtype)`` pair). The spec is
    ``fsdp_spec`` of the JAX shape over ``axis`` (``()`` when ``axis`` is None).
    Parameters under ``parametrizations`` keep their own shape and replicate."""
    out = {}
    layouts = jax_layouts(params) if isinstance(params, torch.nn.Module) else {}
    items = params.named_parameters() if isinstance(params, torch.nn.Module) else \
        params.items()
    for name, v in items:
        if isinstance(v, torch.Tensor):
            shape, dtype, src = tuple(v.shape), v.dtype, None if v.is_meta else v.detach()
        else:
            shape, dtype = (tuple(v.shape), v.dtype) if hasattr(v, "shape") else \
                (tuple(v[0]), v[1])
            src = None
        parametrized = ".parametrizations." in f".{name}"
        layout = Layout("same", shape) if parametrized or not layouts else layouts[name]
        spec = () if axis is None or parametrized else \
            fsdp_spec(layout.jax_shape, axis, n, min_size)
        out[name] = (shape, dtype, layout, src, spec)
    return out


def sharded_shardings(shape_tree, mesh: Mesh, axis: str, min_size: int = 2**16
                      ) -> dict[str, tuple]:
    """Each parameter's spec (``fsdp_spec`` of its JAX shape over ``axis``), by
    state-dict name: the per-leaf policy ``place_params_sharded`` applies."""
    return {name: e[4] for name, e in
            _entries(shape_tree, axis, mesh.shape[axis], min_size).items()}


def sharded_byte_math(shape_tree, mesh: Mesh, axis: str, itemsize: int = 2,
                      min_size: int = 2**16) -> tuple[int, int]:
    """(per-device bytes, total bytes) the policy would place, from shapes alone
    (a module on the ``meta`` device allocates nothing); ``itemsize=2`` counts the
    bf16 checkpoint layout, as the JAX function does."""
    n = mesh.shape[axis]
    per_device = total = 0
    for shape, _, _, _, spec in _entries(shape_tree, axis, n, min_size).values():
        numel = int(np.prod(shape, dtype=np.int64))
        total += numel * itemsize
        per_device += (numel // n if spec else numel) * itemsize
    return per_device, total


# -- placed weights -----------------------------------------------------------------


@dataclasses.dataclass
class Placed:
    """One parameter over a mesh. ``parts[pos]`` is the tensor mesh position ``pos``
    holds: its chunk of the JAX-layout value along ``dim`` (chunk ``pos[axis]``), or,
    when ``axis`` is None, the whole tensor in the port's layout. Positions on one
    device share one tensor."""

    shape: tuple[int, ...]
    dtype: torch.dtype
    layout: Layout
    axis: str | None
    dim: int | None
    parts: np.ndarray

    @property
    def sharded(self) -> bool:
        return self.axis is not None

    def gather(self, mesh: Mesh, pos: tuple, device: torch.device) -> torch.Tensor:
        """The whole tensor on ``device``, in the port's layout and contiguous (the
        placed tensor's own memory order, so a layer computes on it as on the
        original): the chunks along the shard axis through ``pos``, each copied
        from its device (a peer copy) into its place, in mesh order. One chunk
        already on ``device`` is the tensor itself: no copy."""
        if not self.sharded:
            return self.parts[pos].to(device, non_blocking=True)
        ax = mesh.axis_index(self.axis)
        n = mesh.devices.shape[ax]
        idx = list(pos)
        if n == 1 and self.parts[pos].device == device:
            return self.layout.from_jax(self.parts[pos], self.shape)
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        view = self.layout.to_jax(out)
        for i in range(n):
            idx[ax] = i
            part = self.parts[tuple(idx)]
            view.narrow(self.dim, i * part.shape[self.dim], part.shape[self.dim]).copy_(
                part, non_blocking=True)
        return out


class ShardedParams:
    """A model's parameters over a mesh: one ``Placed`` per state-dict name, every
    one sharded over ``axis`` by the policy or replicated (``axis`` None: all
    replicated, ``place_params``)."""

    def __init__(self, mesh: Mesh, axis: str | None, entries: dict[str, Placed]):
        self.mesh = mesh
        self.axis = axis
        self.entries = entries

    def __getitem__(self, name: str) -> Placed:
        return self.entries[name]

    def position_bytes(self, pos: tuple) -> int:
        """Bytes mesh position ``pos`` holds (as if it were its own device)."""
        return sum(e.parts[pos].numel() * e.parts[pos].element_size()
                   for e in self.entries.values())


def _drain(devices: set) -> None:
    """Wait for the copies in flight on ``devices`` (the CUDA ones)."""
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


class _Inflight:
    """Counts copy bytes issued and drains them every ``cap`` bytes."""

    def __init__(self, cap: int):
        self.cap, self.bytes, self.devices = cap, 0, set()

    def add(self, nbytes: int, *devices: torch.device) -> None:
        self.bytes += nbytes
        self.devices.update(devices)
        if self.bytes >= self.cap:
            _drain(self.devices)
            self.bytes, self.devices = 0, set()


def streamed_tree_put(tree, device_for_leaf: Callable[[torch.Tensor], torch.device],
                      max_inflight_bytes: int = _MAX_INFLIGHT_BYTES):
    """Copy every tensor leaf of ``tree`` (dicts, lists, tuples) to
    ``device_for_leaf(leaf)`` with at most ``max_inflight_bytes`` of copies in
    flight: each copy is issued without waiting, and a synchronise follows the copy
    that crosses the cap. A leaf already on its device is kept, not copied."""
    inflight = _Inflight(max_inflight_bytes)

    def put(leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        dev = torch.device(device_for_leaf(leaf))
        out = leaf.to(dev, non_blocking=True)
        if out is not leaf:
            inflight.add(out.numel() * out.element_size(), dev, leaf.device)
        return out

    return tree_map(put, tree)


def _place(params, mesh: Mesh, axis: str | None, min_size: int, zeros: bool = False,
           max_inflight_bytes: int = _MAX_INFLIGHT_BYTES) -> ShardedParams:
    """The one placement loop behind ``place_params*`` and
    ``materialize_params_sharded``: every parameter's parts, each made on its
    device directly (a shard never passes through the whole weight's allocation
    on another device)."""
    n = mesh.shape[axis] if axis is not None else 1
    ax = mesh.axis_index(axis) if axis is not None else None
    inflight = _Inflight(max_inflight_bytes)
    entries = {}
    for name, (shape, dtype, layout, src, spec) in _entries(params, axis, n, min_size).items():
        dim = spec.index(axis) if spec else None
        if src is None and not zeros:
            raise ValueError(f"{name!r} has no values to place (a meta tensor): use "
                             "materialize_params_sharded")
        parts = np.empty(mesh.devices.shape, dtype=object)
        made: dict[tuple, torch.Tensor] = {}
        for pos in mesh.positions():
            dev = mesh.devices[pos]
            k = pos[ax] if dim is not None else None
            key = (str(dev), k)
            if key not in made:
                made[key] = _part(src, shape, dtype, layout, dim, n, k, dev, zeros)
                t = made[key]
                if src is None or t.data_ptr() != src.data_ptr():
                    inflight.add(t.numel() * t.element_size(), dev,
                                 *(() if src is None else (src.device,)))
            parts[pos] = made[key]
        entries[name] = Placed(shape, dtype, layout, axis if dim is not None else None,
                               dim, parts)
    return ShardedParams(mesh, axis, entries)


def _part(src, shape, dtype, layout: Layout, dim, n, k, dev, zeros: bool) -> torch.Tensor:
    if dim is None:
        if zeros:
            return torch.zeros(shape, dtype=dtype, device=dev)
        return src.to(dev, non_blocking=True)  # kept as it is where it already lies
    chunk_shape = list(layout.jax_shape)
    chunk_shape[dim] //= n
    if zeros:
        return torch.zeros(chunk_shape, dtype=dtype, device=dev)
    chunk = layout.to_jax(src).narrow(dim, k * chunk_shape[dim], chunk_shape[dim])
    if n == 1 and src.device == dev:
        return chunk  # the whole weight, where it already lies: no copy
    # Its own allocation: a view would keep the whole weight alive.
    return torch.empty(chunk_shape, dtype=dtype, device=dev).copy_(chunk, non_blocking=True)


def place_params(params, mesh: Mesh) -> ShardedParams:
    """Replicate a module's parameters (or a mapping of tensors) to every device of
    the mesh, a copy per distinct device (none where a tensor already lies),
    streamed with the in-flight bound."""
    return _place(params, mesh, None, 0)


def place_params_sharded(params, mesh: Mesh, axis: str, min_size: int = 2**16
                         ) -> ShardedParams:
    """Place parameters with each weight's largest divisible JAX axis sharded over
    ``axis`` (``fsdp_spec``): the shared policy of FSDP (over ``data``: each device
    holds 1/N and the weights are gathered where a module runs) and tensor
    parallelism (over ``model``: the Linear and Conv layers compute split,
    ``parallel/sharding.py``)."""
    return _place(params, mesh, axis, min_size)


def place_params_fsdp(params, mesh: Mesh, axis: str = AXIS_DATA) -> ShardedParams:
    """FSDP placement: ``place_params_sharded`` over the data axis."""
    return place_params_sharded(params, mesh, axis)


def place_params_tp(params, mesh: Mesh, axis: str = AXIS_MODEL) -> ShardedParams:
    """Tensor-parallel placement: ``place_params_sharded`` over the model axis."""
    return place_params_sharded(params, mesh, axis)


def materialize_params_sharded(shape_tree, mesh: Mesh, axis: str = AXIS_DATA,
                               min_size: int = 2**16) -> ShardedParams:
    """Zero-valued parameters made directly in their sharding: each device
    allocates only its shard, and the whole weight never exists anywhere.
    ``shape_tree`` is a module (on the ``meta`` device, say) or a mapping of
    ``(shape, dtype)`` pairs; checkpoint loaders fill the shards."""
    return _place(shape_tree, mesh, axis, min_size, zeros=True)
