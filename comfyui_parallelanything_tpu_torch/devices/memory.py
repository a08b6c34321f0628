"""Device memory introspection — the free-memory probe the orchestrator's memory
blend reads and the budget its weights-don't-fit check compares against
(counterpart of ``free_memory_bytes``/``total_memory_bytes``/``usable_hbm_bytes``
in ``comfyui_parallelanything_tpu/devices/memory.py``). A CPU device reports 0, so
CPU chains keep the user's weights."""

from __future__ import annotations

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
