"""Device memory introspection — the free-memory probe the orchestrator's memory
blend reads (counterpart of ``free_memory_bytes``/``total_memory_bytes`` in
``comfyui_parallelanything_tpu/devices/memory.py``). A CPU device reports 0, so
CPU chains keep the user's weights."""

from __future__ import annotations

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
