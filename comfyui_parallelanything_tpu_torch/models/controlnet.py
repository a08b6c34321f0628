"""ControlNet for the SD-family UNets in PyTorch (counterpart of
``comfyui_parallelanything_tpu/models/controlnet.py``).

``ControlNet2D`` is the public ControlNet layout (as ldm-format ``.safetensors``
ship it): a hint encoder (``_HINT_LADDER``, 8 convolutions from pixels to the 8×
smaller latent grid, the last zero-initialised), a copy of the UNet's encoder and
middle trunk, one zero 1×1 convolution per skip and one after the middle block
(``mid_out``). Its residuals feed ``UNet2D``'s ``control`` kwarg. Its submodule
names follow the flax tree (``hint_{i}``, ``zero_conv_{k}``, the UNet trunk's
``in_{level}_{i}_res``), so ``convert_jax.from_jax_unet_params`` carries JAX
weights across; ``convert_unet.convert_controlnet_checkpoint`` converts ldm files.

``apply_control`` composes base UNet + ControlNet into one ``DiffusionModel``
whose module holds both networks and the hint image, so the composition goes
through ``parallelize`` as one model: each replica computes the residuals and the
denoise step on its own device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..devices.discovery import default_device
from ..ops.basic import flax_apply, init_random_, progress_window_gate, timestep_embedding
from ..ops.resize import resize
from .api import DiffusionModel
from .unet import (
    Downsample,
    ResBlock,
    SpatialTransformer,
    UNetConfig,
    _conv,
    _has_attn,
    _nhwc_to_nchw,
    middle_depth,
)

# The hint encoder: (out_channels, stride) per convolution, pixels → the 8× smaller
# latent grid; a zero convolution to model_channels follows.
_HINT_LADDER = ((16, 1), (16, 1), (32, 2), (32, 1), (96, 2), (96, 1), (256, 2))


def _nchw_to_nhwc(t: torch.Tensor) -> torch.Tensor:
    # A view: UNet2D's control input permutes it back to a contiguous NCHW tensor.
    return t.permute(0, 2, 3, 1)


class ControlNet2D(nn.Module):
    """forward(x NHWC latents, hint NHWC pixels (8× the latent grid), timesteps
    (B,), context, y) → {"input": [residual per skip], "middle": [residual]}, NHWC
    in ``cfg.dtype``, the residuals in the order of ``UNet2D``'s skips. Zero
    convolutions initialise to zero, so an untrained ControlNet is an exact no-op
    on the base model."""

    def __init__(self, cfg: UNetConfig, hint_channels: int = 3):
        super().__init__()
        self.cfg = cfg
        ch, dt = cfg.model_channels, cfg.dtype
        self.time_embed_0 = nn.Linear(ch, ch * 4, dtype=dt)
        self.time_embed_2 = nn.Linear(ch * 4, ch * 4, dtype=dt)
        if cfg.adm_in_channels is not None:
            self.label_embed_0 = nn.Linear(cfg.adm_in_channels, ch * 4, dtype=dt)
            self.label_embed_2 = nn.Linear(ch * 4, ch * 4, dtype=dt)
        cin = hint_channels
        for i, (cout, stride) in enumerate(_HINT_LADDER):
            self.add_module(f"hint_{i}", _conv(cin, cout, 3, dt, stride=stride))
            cin = cout
        self.add_module(f"hint_{len(_HINT_LADDER)}", _conv(cin, ch, 3, dt))
        self.input_conv = _conv(cfg.in_channels, ch, 3, dt)
        zero_ch = [ch]
        cur = ch
        last = len(cfg.channel_mult) - 1
        for level, mult in enumerate(cfg.channel_mult):
            out_ch = ch * mult
            for i in range(cfg.num_res_blocks):
                self.add_module(f"in_{level}_{i}_res", ResBlock(cfg, cur, out_ch))
                if _has_attn(cfg, level):
                    self.add_module(f"in_{level}_{i}_attn", SpatialTransformer(
                        cfg, out_ch, cfg.transformer_depth[level]))
                cur = out_ch
                zero_ch.append(cur)
            if level != last:
                self.add_module(f"down_{level}", Downsample(cfg, out_ch))
                zero_ch.append(cur)
        for k, c in enumerate(zero_ch):
            self.add_module(f"zero_conv_{k}", _conv(c, c, 1, dt))
        mid_ch = ch * cfg.channel_mult[-1]
        self.mid_res1 = ResBlock(cfg, mid_ch, mid_ch)
        if middle_depth(cfg) > 0:
            self.mid_attn = SpatialTransformer(cfg, mid_ch, middle_depth(cfg))
        self.mid_res2 = ResBlock(cfg, mid_ch, mid_ch)
        self.mid_out = _conv(mid_ch, mid_ch, 1, dt)

    def zero_convs(self) -> list[nn.Conv2d]:
        """The convolutions a ControlNet's training starts from zero: the hint
        encoder's last, one per skip and ``mid_out``."""
        n_zero = sum(1 for name, _ in self.named_children() if name.startswith("zero_conv_"))
        return [getattr(self, f"hint_{len(_HINT_LADDER)}"),
                *(getattr(self, f"zero_conv_{k}") for k in range(n_zero)), self.mid_out]

    def forward(self, x, hint, timesteps, context=None, y=None):
        cfg = self.cfg
        emb = self.time_embed_0(timestep_embedding(timesteps, cfg.model_channels).to(cfg.dtype))
        emb = self.time_embed_2(F.silu(emb))
        if cfg.adm_in_channels is not None:
            if y is None:
                raise ValueError("this config requires vector conditioning `y`")
            emb = emb + self.label_embed_2(F.silu(self.label_embed_0(y.to(cfg.dtype))))
        if context is not None:
            context = context.to(cfg.dtype)
        if tuple(hint.shape[1:3]) != (x.shape[1] * 8, x.shape[2] * 8):
            raise ValueError(f"hint image {tuple(hint.shape[1:3])} must be 8x the latent grid "
                             f"{tuple(x.shape[1:3])} (pixels vs latents)")
        g = _nhwc_to_nchw(hint.to(cfg.dtype))
        for i in range(len(_HINT_LADDER)):
            g = F.silu(flax_apply(getattr(self, f"hint_{i}"), g))
        g = flax_apply(getattr(self, f"hint_{len(_HINT_LADDER)}"), g)

        h = flax_apply(self.input_conv, _nhwc_to_nchw(x.to(cfg.dtype))) + g
        outs = [h]
        last = len(cfg.channel_mult) - 1
        for level in range(len(cfg.channel_mult)):
            for i in range(cfg.num_res_blocks):
                h = getattr(self, f"in_{level}_{i}_res")(h, emb)
                if _has_attn(cfg, level):
                    h = getattr(self, f"in_{level}_{i}_attn")(h, context)
                outs.append(h)
            if level != last:
                h = getattr(self, f"down_{level}")(h)
                outs.append(h)
        residuals = [_nchw_to_nhwc(flax_apply(getattr(self, f"zero_conv_{k}"), t))
                     for k, t in enumerate(outs)]
        h = self.mid_res1(h, emb)
        if middle_depth(cfg) > 0:
            h = self.mid_attn(h, context)
        h = self.mid_res2(h, emb)
        return {"input": residuals, "middle": [_nchw_to_nhwc(flax_apply(self.mid_out, h))]}


def build_controlnet(cfg: UNetConfig, *, device=None, generator: torch.Generator | None = None,
                     state_dict: dict | None = None, hint_channels: int = 3,
                     name: str = "controlnet") -> DiffusionModel:
    """A ControlNet ``DiffusionModel`` on ``device`` (default ``cuda:0``), from
    ``state_dict`` (``convert_unet.convert_controlnet_checkpoint`` or
    ``convert_jax``) or random weights from ``generator``, the zero convolutions
    (the hint encoder's last, ``zero_conv_{k}``, ``mid_out``) zero as in training's
    start. Its module is called ``module(x, hint, timesteps, context, y=None)``."""
    device = torch.device(device) if device is not None else default_device()
    if state_dict is None and generator is None:
        raise ValueError("need a generator to initialise (or pass state_dict=)")
    with torch.device("meta"):
        module = ControlNet2D(cfg, hint_channels)
    module = module.to_empty(device=device).eval()
    if state_dict is not None:
        module.load_state_dict(state_dict)
    else:
        init_random_(module, generator)
        with torch.no_grad():
            for conv in module.zero_convs():
                conv.weight.zero_()
    return DiffusionModel(module=module, name=name, config=cfg)


class ControlledModel(nn.Module):
    """Base model + ControlNet + hint as one module: ``forward`` computes the
    ControlNet's residuals (``residuals``), adds residuals that arrive through
    ``control`` (stacked ControlNets), and runs the base with them."""

    def __init__(self, base: nn.Module, control_net: nn.Module, hint: torch.Tensor,
                 strength: float, start_percent: float, end_percent: float):
        super().__init__()
        self.base, self.ctrl = base, control_net
        self.register_buffer("hint", hint)
        self.strength, self.start, self.end = float(strength), float(start_percent), float(
            end_percent)

    def residuals(self, x, timesteps, context=None, y=None) -> dict:
        """This ControlNet's residuals for a batch, scaled by ``strength`` and gated by
        the ``start_percent``/``end_percent`` window."""
        hint = self.hint if self.hint.ndim == 4 else self.hint[None]
        if hint.shape[0] != x.shape[0]:
            if hint.shape[0] != 1:
                # A per-sample hint cannot survive data-parallel splitting, which
                # cuts x but hands every replica the whole hint.
                raise ValueError(
                    f"hint batch {hint.shape[0]} != latent batch {x.shape[0]}: pass ONE "
                    "hint image (it broadcasts to the batch); per-sample hints are not "
                    "supported")
            hint = hint.expand(x.shape[0], *hint.shape[1:])
        want_hw = (x.shape[1] * 8, x.shape[2] * 8)
        if tuple(hint.shape[1:3]) != want_hw:
            hint = resize(hint, (hint.shape[0], *want_hw, hint.shape[-1]), method="bilinear")
        ctrl = self.ctrl(x, hint, timesteps, context, y=y)
        gate = self.strength
        if (self.start, self.end) != (0.0, 1.0):
            gate = gate * progress_window_gate(timesteps, self.start, self.end, x.ndim)
        return {k: [r * gate for r in v] for k, v in ctrl.items()}

    def forward(self, x, timesteps, context=None, control=None, **kwargs):
        ctrl = self.residuals(x, timesteps, context, y=kwargs.get("y"))
        if control is not None:
            ctrl = {k: [a + b for a, b in zip(v, control[k])] for k, v in ctrl.items()}
        return self.base(x, timesteps, context, control=ctrl, **kwargs)


def control_residuals(ctrl: nn.Module, x, timesteps, context=None, *, hint, y=None) -> dict:
    """A ControlNet's raw residuals for a batch whose hint is already at the latent
    batch and 8× its grid: the ``control_apply`` of a ``control_delegate``, which the
    serving lane program calls with the net as its ``ctrl_params``."""
    return ctrl(x, hint, timesteps, context, y=y)


def apply_control(base: DiffusionModel, control_net: DiffusionModel, hint,
                  strength: float = 1.0, start_percent: float = 0.0,
                  end_percent: float = 1.0) -> DiffusionModel:
    """Compose base UNet + ControlNet into one ``DiffusionModel`` whose module
    (``ControlledModel``) holds both networks and the hint (f32 pixels, NHWC, one
    image or a batch of one), so the composition places through ``parallelize``
    like a single model. ``base`` may itself be a composition: stacked ControlNets
    sum their residuals.

    ``start_percent``/``end_percent`` gate the residuals by sampling progress
    (ComfyUI's ControlNetApplyAdvanced), linear in the timestep: progress = 1 −
    t/999 for the eps/v UNet families this serves. A hint whose size is not 8× the
    latent grid is resized bilinearly to it.

    The composition publishes a ``control_delegate`` (the JAX ``apply_control``'s):
    the serving scheduler buckets it on ``base`` and runs the control trunk in the
    lane program. A chained composition (``base`` is one itself) publishes none and
    is served whole."""
    device = next(base.module.parameters()).device
    hint = torch.as_tensor(hint, dtype=torch.float32).to(device)
    module = ControlledModel(base.module, control_net.module, hint, strength, start_percent,
                             end_percent)
    chained = (getattr(base, "control_delegate", None) is not None
               or isinstance(base.module, ControlledModel))
    return DiffusionModel(
        module=module, name=f"{base.name}+control", config=base.config,
        control_delegate=None if chained else {
            "base": base, "ctrl_apply": control_residuals,
            "ctrl_params": control_net.module, "hint": module.hint,
            "strength": float(strength), "start": float(start_percent),
            "end": float(end_percent)})


# ControlNets share the UNet config surface.
ControlNetConfig = UNetConfig
