"""Tile placement and overlap-blend math for the tiled VAE (counterpart of
``comfyui_parallelanything_tpu/models/tiling.py``): the per-axis window starts and
blend ramps, so the encode and decode tilers cannot drift apart."""

from __future__ import annotations

import numpy as np


def tile_starts(size: int, tile: int, stride: int) -> list[int]:
    """Window starts covering ``size`` with ``tile``-long windows every
    ``stride``; the last window slides back inside the extent (never pads)."""
    if size <= tile:
        return [0]
    s = list(range(0, size - tile, stride))
    s.append(size - tile)
    return s


def blend_mask1d(tile: int, overlap: int, factor: int) -> np.ndarray:
    """Per-pixel blend weight along one axis for a decoded tile of ``tile``
    latent cells upsampled by ``factor``: a linear ramp over the overlap region
    at both ends, flat 1.0 in the interior."""
    if overlap == 0:
        return np.ones(tile * factor, np.float32)
    ramp = np.minimum(np.arange(tile * factor) + 1, overlap * factor) / (overlap * factor)
    return np.minimum(ramp, ramp[::-1]).astype(np.float32)
