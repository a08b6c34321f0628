"""ESRGAN-family image upscalers (RRDBNet), counterpart of
``comfyui_parallelanything_tpu/models/upscale.py``.

The public RRDBNet topology (ESRGAN/RealESRGAN): residual-in-residual dense
blocks at 0.2 residual scaling, nearest 2× + conv upsampling, the x2/x1 variants
pixel-unshuffling their input (torch's channel order, which the checkpoints were
trained against). The module's names are the modern public key layout
(``conv_first``, ``body.N.rdbK.convJ``, ``conv_body``, ``conv_up1/2``,
``conv_hr``, ``conv_last``); the legacy sequential layout (``model.0``,
``model.1.sub.N.RDBK.convJ.0``, ...) is renamed to it. Images are NHWC floats in
[0, 1]; the convolutions are ``torch.nn.functional.conv2d`` (XLA's work in the
JAX package, no Pallas kernel). Large images upscale as overlapping tiles
blended with linear ramps (``upscale_image``).
"""

from __future__ import annotations

import dataclasses
import re
from collections.abc import Mapping
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from ..devices.discovery import default_device


@dataclasses.dataclass(frozen=True)
class UpscaleConfig:
    nf: int = 64  # feature width
    nb: int = 23  # RRDB blocks
    gc: int = 32  # dense growth channels
    scale: int = 4  # output scale: 4, 2 (pixel-unshuffle by 2 in) or 1 (by 4)
    in_channels: int = 3
    out_channels: int = 3
    dtype: Any = torch.float32


def _conv(cin: int, cout: int, dtype) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1, dtype=dtype)


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.2)


class _RDB(nn.Module):
    def __init__(self, cfg: UpscaleConfig):
        super().__init__()
        for i in range(4):
            self.add_module(f"conv{i + 1}", _conv(cfg.nf + i * cfg.gc, cfg.gc, cfg.dtype))
        self.conv5 = _conv(cfg.nf + 4 * cfg.gc, cfg.nf, cfg.dtype)

    def forward(self, x):
        feats = [x]
        for i in range(4):
            feats.append(_lrelu(getattr(self, f"conv{i + 1}")(torch.cat(feats, 1))))
        return x + 0.2 * self.conv5(torch.cat(feats, 1))


class _RRDB(nn.Module):
    def __init__(self, cfg: UpscaleConfig):
        super().__init__()
        self.rdb1, self.rdb2, self.rdb3 = _RDB(cfg), _RDB(cfg), _RDB(cfg)

    def forward(self, x):
        return x + 0.2 * self.rdb3(self.rdb2(self.rdb1(x)))


def _nearest2x(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


class RRDBNet(nn.Module):
    """forward(image NHWC in [0, 1]) → the upscaled image, NHWC f32, clipped to
    [0, 1]. ``conv_last`` computes in f32 whatever ``cfg.dtype`` is."""

    def __init__(self, cfg: UpscaleConfig):
        super().__init__()
        self.cfg = cfg
        shuffle = {4: 1, 2: 2, 1: 4}[cfg.scale]
        self.shuffle = shuffle
        self.conv_first = _conv(cfg.in_channels * shuffle * shuffle, cfg.nf, cfg.dtype)
        self.body = nn.ModuleList(_RRDB(cfg) for _ in range(cfg.nb))
        self.conv_body = _conv(cfg.nf, cfg.nf, cfg.dtype)
        self.conv_up1 = _conv(cfg.nf, cfg.nf, cfg.dtype)
        self.conv_up2 = _conv(cfg.nf, cfg.nf, cfg.dtype)
        self.conv_hr = _conv(cfg.nf, cfg.nf, cfg.dtype)
        self.conv_last = _conv(cfg.nf, cfg.out_channels, torch.float32)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2).to(self.cfg.dtype)
        if self.shuffle > 1:
            x = F.pixel_unshuffle(x, self.shuffle)
        h = self.conv_first(x)
        trunk = h
        for block in self.body:
            trunk = block(trunk)
        h = h + self.conv_body(trunk)
        h = _lrelu(self.conv_up1(_nearest2x(h)))
        h = _lrelu(self.conv_up2(_nearest2x(h)))
        h = _lrelu(self.conv_hr(h))
        h = self.conv_last(h.float())
        return torch.clamp(h, 0.0, 1.0).permute(0, 2, 3, 1)


@dataclasses.dataclass
class UpscaleModel:
    """An upscaler handle: the module and its config. ``__call__`` moves the image
    to the module's device and runs it without gradients."""

    module: RRDBNet
    cfg: UpscaleConfig
    name: str = "upscaler"

    @property
    def device(self) -> torch.device:
        return self.module.conv_first.weight.device

    def __call__(self, image) -> torch.Tensor:
        with torch.no_grad():
            return self.module(torch.as_tensor(image, dtype=torch.float32).to(self.device))


def build_upscaler(cfg: UpscaleConfig, *, device=None, generator: torch.Generator | None = None,
                   state_dict: dict | None = None, name: str = "upscaler") -> UpscaleModel:
    """An RRDBNet on ``device`` (default ``cuda:0``), from ``state_dict``
    (``convert_upscale_checkpoint`` or ``convert_jax.from_jax_upscale_params``) or
    random weights from ``generator``."""
    from ..ops import basic

    device = torch.device(device) if device is not None else default_device()
    if state_dict is None and generator is None:
        raise ValueError("need a generator to initialise (or pass state_dict=)")
    with torch.device("meta"):
        module = RRDBNet(cfg)
    module = module.to_empty(device=device).eval()
    with torch.no_grad():
        if state_dict is not None:
            module.load_state_dict(state_dict)
        else:
            basic.init_random_(module, generator)
    return UpscaleModel(module=module, cfg=cfg, name=name)


# ---------------------------------------------------------------------------
# Checkpoint conversion (both public layouts)
# ---------------------------------------------------------------------------

_OLD_HEAD = {
    "model.0": "conv_first",
    "model.3": "conv_up1",
    "model.6": "conv_up2",
    "model.8": "conv_hr",
    "model.10": "conv_last",
}


def normalize_esrgan_keys(sd: Mapping[str, Any]) -> dict:
    """Legacy ESRGAN sequential naming → the modern RRDBNet keys: ``model.0`` →
    conv_first; ``model.1.sub.{i}.RDB{k}.conv{j}.0`` → ``body.{i}.rdb{k}.conv{j}``;
    ``model.1.sub.{nb}`` (the last sub index) → conv_body; ``model.3/6/8/10`` →
    up1/up2/hr/last. A modern dict passes through."""
    if not any(k.startswith("model.") for k in sd):
        return dict(sd)
    out: dict = {}
    sub_idx = [int(m.group(1)) for k in sd if (m := re.match(r"model\.1\.sub\.(\d+)\.", k))]
    trunk = max(sub_idx) if sub_idx else 0
    for k, v in sd.items():
        m = re.match(r"model\.1\.sub\.(\d+)\.(.*)", k)
        if m:
            i, rest = int(m.group(1)), m.group(2)
            if i == trunk:
                out[f"conv_body.{rest}"] = v
                continue
            rest = re.sub(r"RDB(\d)\.conv(\d)\.0\.", r"rdb\1.conv\2.", rest)
            out[f"body.{i}.{rest}"] = v
            continue
        for old, new in _OLD_HEAD.items():
            if k.startswith(old + "."):
                out[new + k[len(old):]] = v
                break
        else:
            out[k] = v
    leftovers = sorted(k for k in out if k.startswith("model."))
    if leftovers:
        raise ValueError(
            f"legacy ESRGAN layout with unrecognized head keys {leftovers[:4]} — only the "
            "x4 sequential layout (model.3/6/8/10) is mapped; re-save the model in the "
            "modern RRDBNet key layout (conv_first/body.N/...)")
    return out


def sniff_upscale_config(sd: Mapping[str, Any]) -> UpscaleConfig:
    """(nf, nb, gc, scale, channels) from a normalized RRDBNet state dict: widths
    from conv_first and the first dense conv, depth from the body indices, scale
    from the pixel-unshuffle factor in conv_first's input width."""
    nf, in_w = (int(s) for s in sd["conv_first.weight"].shape[:2])
    gc = int(sd["body.0.rdb1.conv1.weight"].shape[0])
    nb = 1 + max(int(m.group(1)) for k in sd if (m := re.match(r"body\.(\d+)\.", k)))
    out_ch = int(sd["conv_last.weight"].shape[0])
    # in_channels × unshuffle²: x4 sees raw pixels, x2 unshuffles by 2, x1 by 4.
    known = {1: (1, 4), 3: (3, 4), 4: (1, 2), 12: (3, 2), 16: (1, 1), 48: (3, 1)}
    if in_w not in known:
        raise ValueError(
            f"unrecognized RRDBNet conv_first input width {in_w}: expected in_channels 1 "
            f"or 3 with pixel-unshuffle factor 1/4/16 (widths {sorted(known)}); pass an "
            "explicit UpscaleConfig for nonstandard variants")
    base_in, scale = known[in_w]
    return UpscaleConfig(nf=nf, nb=nb, gc=gc, scale=scale, in_channels=base_in,
                         out_channels=out_ch)


def convert_upscale_checkpoint(sd: Mapping[str, Any], cfg: UpscaleConfig | None = None):
    """Normalized-or-legacy RRDBNet state dict → (state dict in f32, cfg)."""
    from .convert import to_tensor

    sd = normalize_esrgan_keys(sd)
    if cfg is None:
        cfg = sniff_upscale_config(sd)
    names = ["conv_first", "conv_body", "conv_up1", "conv_up2", "conv_hr", "conv_last"]
    names += [f"body.{i}.rdb{k}.conv{j}" for i in range(cfg.nb)
              for k in range(1, 4) for j in range(1, 6)]
    out = {}
    for name in names:
        for leaf in ("weight", "bias"):
            out[f"{name}.{leaf}"] = to_tensor(sd[f"{name}.{leaf}"], torch.float32, "cpu")
    return out, cfg


def load_upscale_checkpoint(src: Any, name: str = "upscaler", device=None) -> UpscaleModel:
    """Upscaler safetensors (either public layout) or state dict → ``UpscaleModel``
    on ``device`` (default ``cuda:0``)."""
    from .loader import _resolve_state_dict

    state, cfg = convert_upscale_checkpoint(_resolve_state_dict(src))
    return build_upscaler(cfg, device=device, state_dict=state, name=name)


def upscale_image(model: UpscaleModel, image, tile: int = 512, overlap: int = 16) -> torch.Tensor:
    """Upscale an NHWC [0, 1] image batch. An image larger than ``tile`` runs as
    overlapping tiles whose outputs blend with linear ramps over the overlap
    (bounded activation memory, no seams), accumulated in place on the model's
    device. Returns f32 NHWC on the model's device."""
    img = torch.as_tensor(image, dtype=torch.float32)
    if img.ndim == 3:
        img = img[None]
    img = img.to(model.device)
    B, H, W, _ = img.shape
    s = model.cfg.scale
    if max(H, W) <= tile:
        return model(img)
    step = tile - 2 * overlap
    dev = model.device
    out = torch.zeros((B, H * s, W * s, model.cfg.out_channels), dtype=torch.float32, device=dev)
    weight = torch.zeros((1, H * s, W * s, 1), dtype=torch.float32, device=dev)

    def ramp(n, lo_edge, hi_edge):
        r = torch.ones((n,), dtype=torch.float32, device=dev)
        k = overlap * s
        if lo_edge:
            r[:k] = torch.linspace(0.0, 1.0, k, device=dev)
        if hi_edge:
            r[-k:] = torch.minimum(r[-k:], torch.linspace(1.0, 0.0, k, device=dev))
        return r

    ys = list(range(0, max(H - 2 * overlap, 1), step))
    xs = list(range(0, max(W - 2 * overlap, 1), step))
    for y0 in ys:
        y1 = min(y0 + tile, H)
        y0 = max(0, y1 - tile)
        for x0 in xs:
            x1 = min(x0 + tile, W)
            x0 = max(0, x1 - tile)
            piece = model(img[:, y0:y1, x0:x1, :])
            wy = ramp(piece.shape[1], y0 > 0, y1 < H)
            wx = ramp(piece.shape[2], x0 > 0, x1 < W)
            wgt = (wy[:, None] * wx[None, :])[None, :, :, None]
            out[:, y0 * s:y1 * s, x0 * s:x1 * s, :] += piece * wgt
            weight[:, y0 * s:y1 * s, x0 * s:x1 * s, :] += wgt
    return out / torch.clamp(weight, min=1e-8)
