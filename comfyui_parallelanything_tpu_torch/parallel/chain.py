"""The DEVICE_CHAIN data type: an ordered list of (device, percentage) links.

Counterpart of ``comfyui_parallelanything_tpu/parallel/chain.py``, with
``torch_devices()`` in place of ``jax_devices()``. Links with a percentage <= 0
are dropped by ``from_pairs``; weights are ``pct_i / sum(pct)`` and an unusable
chain (sum <= 0) has none. The chain is immutable; ``add``, ``from_pairs`` and ``even``
return new chains.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Iterable, Sequence

import torch

from ..devices.discovery import device_platform, get_device
from .split import normalize_weights


@dataclasses.dataclass(frozen=True)
class DeviceLink:
    """One link: a device identifier string plus its workload percentage."""

    device: str
    percentage: float

    def __post_init__(self) -> None:
        if not isinstance(self.device, str) or not self.device:
            raise ValueError(f"device must be a non-empty string, got {self.device!r}")


@dataclasses.dataclass(frozen=True)
class DeviceChain:
    """An ordered, immutable chain of DeviceLinks — the DEVICE_CHAIN value."""

    links: tuple[DeviceLink, ...] = ()

    def add(self, device: str, percentage: float) -> "DeviceChain":
        """Append one link, returning a new chain."""
        return DeviceChain(self.links + (DeviceLink(device, float(percentage)),))

    @classmethod
    def from_pairs(cls, pairs: Iterable[tuple[str, float]]) -> "DeviceChain":
        """Build a chain from (device, pct) pairs, dropping pct <= 0 entries."""
        return cls(tuple(DeviceLink(dev, float(pct)) for dev, pct in pairs if float(pct) > 0))

    @classmethod
    def even(cls, devices: Sequence[str]) -> "DeviceChain":
        """An even split over the given devices."""
        n = len(devices)
        if n == 0:
            return cls()
        return cls(tuple(DeviceLink(d, 100.0 / n) for d in devices))

    def __len__(self) -> int:
        return len(self.links)

    def __iter__(self):
        return iter(self.links)

    def __bool__(self) -> bool:
        return bool(self.links)

    @property
    def devices(self) -> tuple[str, ...]:
        return tuple(link.device for link in self.links)

    @property
    def percentages(self) -> tuple[float, ...]:
        return tuple(link.percentage for link in self.links)

    @property
    def platforms(self) -> tuple[str, ...]:
        return tuple(device_platform(d) for d in self.devices)

    @property
    def is_homogeneous(self) -> bool:
        """True when every link lives on the same platform."""
        return len(set(self.platforms)) <= 1

    def normalized_weights(self) -> tuple[float, ...] | None:
        """``pct_i / sum(pct)``, or None when the sum is <= 0."""
        return normalize_weights(self.percentages)

    def torch_devices(self) -> tuple[torch.device, ...]:
        """Resolve every link to a ``torch.device``; raises ValueError on any invalid
        entry (use ``validated()`` to drop them instead)."""
        return tuple(get_device(d) for d in self.devices)

    def validated(self) -> "DeviceChain":
        """Drop links that fail device resolution."""
        good = []
        for link in self.links:
            try:
                get_device(link.device)
            except ValueError:
                continue
            good.append(link)
        return DeviceChain(tuple(good))

    def deduplicated(self) -> "DeviceChain":
        """Merge repeated devices by summing their percentages."""
        acc: dict[str, float] = {}
        for link in self.links:
            acc[link.device] = acc.get(link.device, 0.0) + link.percentage
        return DeviceChain(tuple(DeviceLink(d, p) for d, p in acc.items()))
