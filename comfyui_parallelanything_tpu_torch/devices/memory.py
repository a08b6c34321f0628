"""Device memory introspection — the free-memory probe the orchestrator's memory
blend reads and the budget its weights-don't-fit check compares against
(counterpart of ``free_memory_bytes``/``total_memory_bytes``/``usable_hbm_bytes``
in ``comfyui_parallelanything_tpu/devices/memory.py``). A CPU device reports 0, so
CPU chains keep the user's weights. ``ResidencyTracker`` is the weight-streaming
executor's account of the stage weights it holds on its device; its gauges
(``publish_gauges``) wait for the telemetry utils (ROADMAP Queue 1 item 9)."""

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
