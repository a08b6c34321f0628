"""Device discovery for the device-chain API.

Counterpart of ``comfyui_parallelanything_tpu/devices/discovery.py``: the chain
names devices by strings ``"<platform>"`` or ``"<platform>:<index>"``. Here
``cuda:i`` takes the role of ``tpu:i`` and ``cpu`` is always listed. ``cpu:i`` for
i < 8 resolves to PyTorch's one CPU device: it stands in for the eight virtual
CPU devices the JAX package tests on, so multi-replica splitting runs without a
GPU.
"""

from __future__ import annotations

import torch

# How many ``cpu:i`` names resolve (the JAX test harness's virtual device count).
VIRTUAL_CPU_DEVICES = 8


def available_devices() -> list[str]:
    """Selectable device strings: ``cuda:i`` for every visible GPU, then ``cpu``."""
    return [f"cuda:{i}" for i in range(torch.cuda.device_count())] + ["cpu"]


def device_platform(device_str: str) -> str:
    """``"cuda:3"`` -> ``"cuda"``; ``"cpu"`` -> ``"cpu"``."""
    return device_str.split(":", 1)[0].lower()


def get_device(device_str: str) -> torch.device:
    """Resolve a device string to a ``torch.device``.

    Raises ``ValueError`` for unknown platforms, malformed strings and
    out-of-range indices.
    """
    plat = device_platform(device_str)
    idx = 0
    if ":" in device_str:
        try:
            idx = int(device_str.split(":", 1)[1])
        except ValueError as e:
            raise ValueError(f"Malformed device string {device_str!r}") from e
    if plat == "cuda":
        n = torch.cuda.device_count()
        if n == 0:
            raise ValueError(f"No devices available for platform 'cuda' (from {device_str!r})")
        if not 0 <= idx < n:
            raise ValueError(
                f"Device index {idx} out of range for platform 'cuda' ({n} device(s) available)"
            )
        return torch.device("cuda", idx)
    if plat == "cpu":
        if not 0 <= idx < VIRTUAL_CPU_DEVICES:
            raise ValueError(
                f"Device index {idx} out of range for platform 'cpu' "
                f"({VIRTUAL_CPU_DEVICES} device(s) available)"
            )
        return torch.device("cpu")
    raise ValueError(f"No devices available for platform {plat!r} (from {device_str!r})")


def device_kind(device: torch.device) -> str:
    """The card's name (``torch.cuda.get_device_name``) for a GPU, ``""`` for the
    host: the key of the roofline platform specs (``utils/roofline.py``)."""
    return torch.cuda.get_device_name(device) if device.type == "cuda" else ""


def default_device() -> torch.device:
    """``cuda:0``. There is no silent CPU fallback: without a GPU this raises, and
    a caller that wants the CPU passes ``device="cpu"``."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return torch.device("cuda", 0)
