"""Device memory introspection — the free-memory probe the orchestrator's memory
blend reads and the budget its weights-don't-fit check compares against
(counterpart of ``free_memory_bytes``/``total_memory_bytes``/``usable_hbm_bytes``
in ``comfyui_parallelanything_tpu/devices/memory.py``). A CPU device reports 0, so
CPU chains keep the user's weights. ``memory_snapshot``/``publish_memory_gauges``
are the per-card view the server's ``/health`` and ``/metrics`` read (the CUDA
caching allocator's counters; a host without a card reports no device).
``ResidencyTracker`` is the weight-streaming executor's account of the stage
weights it holds on its device; its gauges (``publish_gauges``) wait for the
remaining telemetry (ROADMAP Queue 1 item 9d)."""

from __future__ import annotations

import dataclasses
import os

import torch


def total_memory_bytes(device: torch.device) -> int:
    """Device memory capacity in bytes; 0 for a device that is not a GPU."""
    if device.type != "cuda":
        return 0
    return int(torch.cuda.mem_get_info(device)[1])


def free_memory_bytes(device: torch.device) -> int:
    """Free device memory in bytes; 0 for a device that is not a GPU."""
    if device.type != "cuda":
        return 0
    return int(torch.cuda.mem_get_info(device)[0])


def usable_hbm_bytes(device: torch.device) -> int:
    """The device-memory budget a model's weights must fit: the
    ``PA_HBM_BUDGET_BYTES`` override when set, otherwise 90 % of the device's
    capacity (the runtime's reservations come off the top). 0 for a device that
    reports no memory (the host), where the caller must budget explicitly."""
    override = os.environ.get("PA_HBM_BUDGET_BYTES")
    if override:
        return int(override)
    return int(total_memory_bytes(device) * 0.9)


@dataclasses.dataclass
class ResidencyTracker:
    """Live streamed-weight bytes on a device.

    The streaming executor (``parallel/streaming.py``) calls ``place(tag, n)`` when
    it issues a stage's host→device copy and ``retire(tag)`` once that stage's
    compute has been ordered before the copy that reuses its slot, so
    ``live_bytes`` is the scheduler's weight footprint and ``peak_bytes`` the number
    the 2-stage bound is held to. ``resident_bytes`` counts the permanently placed
    remainder (prepare and finalize weights), which is not part of the ring."""

    live_bytes: int = 0
    peak_bytes: int = 0
    resident_bytes: int = 0
    _tags: dict = dataclasses.field(default_factory=dict)

    def place(self, tag, nbytes: int) -> None:
        if tag in self._tags:
            raise ValueError(f"stage {tag!r} placed twice without retirement")
        self._tags[tag] = int(nbytes)
        self.live_bytes += int(nbytes)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def retire(self, tag) -> None:
        self.live_bytes -= self._tags.pop(tag)

    def add_resident(self, nbytes: int) -> None:
        self.resident_bytes += int(nbytes)

    @property
    def live_tags(self) -> tuple:
        return tuple(self._tags)


def memory_snapshot(devices=None) -> list[dict]:
    """One record per CUDA device (or per device in ``devices``): the allocator's
    ``bytes_in_use`` and ``peak_bytes_in_use`` (``memory_allocated`` /
    ``max_memory_allocated``), ``bytes_reserved``, the card's ``bytes_limit`` and
    ``bytes_free`` (``mem_get_info``) and ``utilization`` (in use over the limit).
    The body of ``GET /health``'s ``hbm`` section; empty without a card (the JAX
    package's pseudo-accounting of host arrays has no counterpart here)."""
    if devices is None:
        devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                   if torch.cuda.is_available() else [])
    out = []
    for d in devices:
        d = torch.device(d)
        if d.type != "cuda":
            continue
        free, total = torch.cuda.mem_get_info(d)
        in_use = int(torch.cuda.memory_allocated(d))
        out.append({
            "device": str(d),
            "kind": torch.cuda.get_device_name(d),
            "bytes_in_use": in_use,
            "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(d)),
            "bytes_reserved": int(torch.cuda.memory_reserved(d)),
            "bytes_limit": int(total),
            "bytes_free": int(free),
            "utilization": round(in_use / total, 6) if total > 0 else None,
        })
    return out


def publish_memory_gauges(devices=None) -> list[dict]:
    """Export ``pa_hbm_bytes_limit`` / ``pa_hbm_bytes_in_use`` /
    ``pa_hbm_utilization`` per device (the Prometheus view of the snapshot);
    returns the snapshot."""
    from ..utils.metrics import registry

    snap = memory_snapshot(devices)
    for s in snap:
        lbl = {"device": s["device"]}
        registry.gauge("pa_hbm_bytes_limit", s["bytes_limit"], labels=lbl,
                       help="device memory capacity")
        registry.gauge("pa_hbm_bytes_in_use", s["bytes_in_use"], labels=lbl,
                       help="device memory held by tensors (the caching allocator's count)")
        if s["utilization"] is not None:
            registry.gauge("pa_hbm_utilization", s["utilization"], labels=lbl,
                           help="bytes_in_use / bytes_limit")
    return snap
