"""Multi-process support: the process group, hybrid meshes, per-process batches.

Counterpart of ``comfyui_parallelanything_tpu/parallel/multihost.py``. Within a
process the port is single-controller: one program drives every local device over a
``Mesh`` (``parallel/mesh.py``). Across processes — hosts, or several processes on
one — it uses ``torch.distributed``, and this module is the only one that does:

- ``initialize_distributed`` — ``torch.distributed.init_process_group`` from
  torchrun's variables (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``)
  or from explicit arguments; ``nccl`` when the process drives a GPU, else
  ``gloo``. A plain single-process run (no arguments, no variables) is a no-op, and
  a second call returns what the first set up;
- ``hybrid_mesh`` — a (dcn axis, *ici axes) mesh: the dcn axis spans processes (the
  slow links) and the ici axes split each process's local devices. The port's mesh
  holds this process's devices, its rows of the dcn axis; with one process it is
  the whole mesh, with the same axis names as the JAX one;
- ``host_local_batch`` — a process's slice of the global batch placed over its
  data-axis devices; the global batch is the concatenation of the processes'
  slices, in rank order.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from collections.abc import Sequence

import numpy as np
import torch

from .mesh import AXIS_DATA, Mesh

logger = logging.getLogger(__name__)


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() else None


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           backend: str | None = None) -> bool:
    """Bring up the process group. Returns True when running multi-process.

    ``coordinator_address`` is ``host:port`` (a TCP store) or an ``init_method``
    URL (``tcp://``, ``file://``); the arguments default to torchrun's variables
    (``MASTER_ADDR`` and ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``). With none of
    them this is a no-op that returns False. ``backend`` defaults to ``nccl`` when
    the process drives a GPU and ``gloo`` otherwise; under ``nccl`` the process
    takes GPU ``LOCAL_RANK`` (else its rank modulo the local GPU count).
    """
    dist = _dist()
    if dist is None:
        return False
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if coordinator_address is None and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK"):
        process_id = int(env["RANK"])
    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None or num_processes is None:
        raise ValueError("initialize_distributed needs both a coordinator address and a "
                         "process count (arguments, or MASTER_ADDR/MASTER_PORT and "
                         "WORLD_SIZE)")
    rank = int(process_id or 0)
    init = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        local = int(env.get("LOCAL_RANK", rank % max(1, torch.cuda.device_count())))
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=init, world_size=int(num_processes),
                            rank=rank)
    logger.info("distributed: process %d/%d (%s), %d local device(s)", rank,
                int(num_processes), backend, len(_local_devices()))
    return dist.get_world_size() > 1


def process_count() -> int:
    """The number of processes in the group (1 without one)."""
    dist = _dist()
    return dist.get_world_size() if dist is not None and dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank (0 without a group)."""
    dist = _dist()
    return dist.get_rank() if dist is not None and dist.is_initialized() else 0


def is_multihost() -> bool:
    return process_count() > 1


def _local_devices() -> list[torch.device]:
    n = torch.cuda.device_count()
    return [torch.device("cuda", i) for i in range(n)] if n else [torch.device("cpu")]


def hybrid_mesh(ici_axes: dict[str, int] | None = None, dcn_axis: str = AXIS_DATA,
                devices: Sequence[torch.device | str] | None = None) -> Mesh:
    """A mesh whose ``dcn_axis`` spans processes and whose ``ici_axes`` split each
    process's local devices (``devices``, default every local GPU, else the CPU).

    The local devices the ici axes leave over fold into the dcn axis, as in the JAX
    package (``hybrid_mesh({"seq": 4})`` over 8 devices is {"data": 2, "seq": 4}).
    The returned mesh holds this process's rows of the dcn axis: with one process,
    all of it.
    """
    from .mesh import build_mesh

    ici_axes = dict(ici_axes) if ici_axes else {}
    devs = list(devices) if devices is not None else _local_devices()
    ici_total = int(np.prod(list(ici_axes.values()), dtype=np.int64)) if ici_axes else 1
    if len(devs) % ici_total:
        raise ValueError(f"ici axes {ici_axes} do not divide the {len(devs)} per-process "
                         "devices")
    return build_mesh(devs, {dcn_axis: len(devs) // ici_total, **ici_axes})


@dataclasses.dataclass
class HostLocalBatch:
    """One process's slice of a global batch, over its data-axis devices:
    ``shards[i]`` on ``devices[i]``, the slice's rows in order; the slice starts at
    row ``offset`` of the global batch, whose shape is ``shape``."""

    shards: list[torch.Tensor]
    devices: list[torch.device]
    shape: tuple[int, ...]
    offset: int

    def local(self) -> torch.Tensor:
        """The process's slice, gathered on its first device."""
        lead = self.devices[0]
        return torch.cat([s.to(lead, non_blocking=True) for s in self.shards], dim=0)


def host_local_batch(local_array, mesh: Mesh, axis: str = AXIS_DATA) -> HostLocalBatch:
    """A process's slice of the global batch (dim 0), placed over ``mesh``'s ``axis``
    in equal contiguous chunks. With one process the slice is the batch; with
    several each rank passes its own slice of one size, and the global batch is
    their concatenation in rank order (JAX's
    ``make_array_from_process_local_data``)."""
    t = local_array if isinstance(local_array, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(local_array))
    devices = mesh.axis_devices(axis)
    shards = [c.to(d, non_blocking=True) for c, d in
              zip(torch.tensor_split(t, len(devices), dim=0), devices)]
    n_proc = process_count()
    return HostLocalBatch(shards, devices, (t.shape[0] * n_proc, *t.shape[1:]),
                          t.shape[0] * process_index())
