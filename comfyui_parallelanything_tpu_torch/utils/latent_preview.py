"""Latent → RGB preview for the per-step preview hook (counterpart of
``comfyui_parallelanything_tpu/utils/latent_preview.py``).

Stock ComfyUI's latent2rgb: a per-family linear projection of the latent channels
to RGB, with the public factor tables for 4-channel (SD-class) and 16-channel
(FLUX-class) latents; any other channel count shows its first three channels
normalised. The family is chosen by the channel count alone.
"""

from __future__ import annotations

import io

import numpy as np

# Public SD-class latent→RGB projection (rows = latent channels).
_FACTORS_4 = np.array(
    [
        [0.3512, 0.2297, 0.3227],
        [0.3250, 0.4974, 0.2350],
        [-0.2829, 0.1762, 0.2721],
        [-0.2120, -0.2616, -0.7177],
    ],
    np.float32,
)

# Public FLUX-class 16-channel projection.
_FACTORS_16 = np.array(
    [
        [-0.0346, 0.0244, 0.0681],
        [0.0034, 0.0210, 0.0687],
        [0.0275, -0.0668, -0.0433],
        [-0.0174, 0.0160, 0.0617],
        [0.0859, 0.0721, 0.0329],
        [0.0004, 0.0383, 0.0115],
        [0.0405, 0.0861, 0.0915],
        [-0.0236, -0.0185, -0.0259],
        [-0.0245, 0.0250, 0.1180],
        [0.1008, 0.0755, -0.0421],
        [-0.0515, 0.0201, 0.0011],
        [0.0428, -0.0012, -0.0036],
        [0.0817, 0.0765, 0.0749],
        [-0.1264, -0.0522, -0.1103],
        [-0.0280, -0.0881, -0.0499],
        [-0.1262, -0.0982, -0.0778],
    ],
    np.float32,
)
_BIAS_16 = np.array([-0.0329, -0.0718, -0.0851], np.float32)


def _host(latent) -> np.ndarray:
    """A latent (torch tensor on any device, or array-like) as f32 numpy."""
    if hasattr(latent, "detach"):
        latent = latent.detach().float().cpu().numpy()
    return np.asarray(latent, np.float32)


def latent_to_rgb(latent) -> np.ndarray:
    """(B, H, W, C) or (B, T, H, W, C) latent → (H, W, 3) float [0, 1] preview of
    batch 0 (frame 0 for video)."""
    arr = _host(latent)
    if arr.ndim == 5:
        arr = arr[:, 0]
    if arr.ndim != 4:
        raise ValueError(f"latent must be 4-D or 5-D, got shape {arr.shape}")
    x = arr[0]
    c = x.shape[-1]
    if c == 4:
        rgb = x @ _FACTORS_4
    elif c == 16:
        rgb = x @ _FACTORS_16 + _BIAS_16
    else:
        rgb = x[..., : min(3, c)]
        if rgb.shape[-1] < 3:
            rgb = np.concatenate([rgb] + [rgb[..., -1:]] * (3 - rgb.shape[-1]), axis=-1)
        lo, hi = rgb.min(), rgb.max()
        return (rgb - lo) / max(hi - lo, 1e-6)
    return np.clip(rgb / 2.0 + 0.5, 0.0, 1.0)


def preview_png(latent, max_side: int = 256) -> bytes:
    """Latent → small PNG bytes, nearest-upscaled from the latent grid (a
    thumbnail, not a decode)."""
    from PIL import Image

    rgb = latent_to_rgb(latent)
    img = Image.fromarray((rgb * 255).astype(np.uint8))
    w, h = img.size
    scale = max(1, max_side // max(w, h))
    if scale > 1:
        img = img.resize((w * scale, h * scale), Image.NEAREST)
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return buf.getvalue()
