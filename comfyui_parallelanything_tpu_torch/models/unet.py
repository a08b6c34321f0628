"""SD-family latent UNet (SD1.5 / SD2.x / SDXL / SDXL refiner) in PyTorch
(counterpart of ``comfyui_parallelanything_tpu/models/unet.py``).

NHWC at the public boundary (latents, ControlNet residuals), as in the JAX
package; inside, the convolutions run on contiguous NCHW tensors and the
transformer blocks on (B, H·W, C) tokens. Numerics follow the JAX module:
convolutions and linears compute in ``cfg.dtype`` (weights stored in it),
GroupNorm and LayerNorm at eps 1e-6 with f32 statistics, scale and bias, GEGLU
with the exact (erf) GELU, the timestep embedding in f32 cast to ``cfg.dtype``,
and the final convolution in f32 on an f32 input. ``Downsample`` is a stride-2 convolution padded by 1 on every
side (the VAE's pads asymmetrically); ``Upsample`` is nearest ×2. Attention goes
through ``ops.attention.attention``: on a CUDA tensor that is the flash attention
kernel K1, self-attention over H·W tokens and cross-attention over the text
tokens, every head dim of the configs (40, 80, 160 for SD1.5; 64 for SD2.x and
SDXL) in one call each.

Submodule names follow the flax tree (``in_1_0_attn.block_0.attn1_q``, the
ResBlock's ``GroupNorm_0``/``Conv_0``/``Dense_0``/...), so
``convert_jax.from_jax_unet_params`` is a rename plus layout changes.

The forward is staged — ``prepare`` → ``input_step`` → ``middle_step`` →
``output_step`` → ``finalize`` — over a flat dict carry: ``h``, ``emb``,
``context``, the skip stack as ``skip_{i}`` and ControlNet residuals as
``ctrl_in_{i}``/``ctrl_mid``; ``_unet_pipeline_spec`` describes that staging as
plain data.

Conditioning beside the UNet: ``apply_inpaint_conditioning`` composes the
9-channel inpaint-model input (latent ‖ mask ‖ masked-image latent) into one
``DiffusionModel``, and ``unclip_adm`` builds SD2.x-unCLIP's noise-augmented
image-embedding vector ``y``.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..devices.discovery import default_device
from ..ops.attention import attention
from ..ops.basic import GroupNorm, LayerNorm, flax_apply, init_random_, timestep_embedding
from .api import DiffusionModel, PipelineSegment, PipelineSpec


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    model_channels: int = 320
    num_res_blocks: int = 2
    channel_mult: tuple[int, ...] = (1, 2, 4, 4)
    attention_levels: tuple[int, ...] = (0, 1, 2)
    transformer_depth: tuple[int, ...] = (1, 1, 1, 1)
    num_heads: int = 8  # -1: heads = channels // 64
    context_dim: int = 768
    adm_in_channels: int | None = None  # SDXL pooled-text + size vector
    # Middle transformer depth; None derives it from the deepest encoder level.
    transformer_depth_middle: int | None = None
    norm_groups: int = 32
    prediction: str = "eps"  # the checkpoint's parameterization: "eps" or "v"
    # FreeU (b1, b2, s1, s2, version) on the up path; None = off.
    freeu: tuple | None = None
    dtype: torch.dtype = torch.bfloat16


def sd15_config(**overrides) -> UNetConfig:
    return dataclasses.replace(UNetConfig(), **overrides)


def sd21_config(**overrides) -> UNetConfig:
    """SD2.x: OpenCLIP-H context (1024) and 64-wide heads; the 768-v checkpoints
    take ``prediction="v"``."""
    return dataclasses.replace(UNetConfig(context_dim=1024, num_heads=-1), **overrides)


def sdxl_config(**overrides) -> UNetConfig:
    base = UNetConfig(model_channels=320, channel_mult=(1, 2, 4), attention_levels=(1, 2),
                      transformer_depth=(0, 2, 10), num_heads=-1, context_dim=2048,
                      adm_in_channels=2816)
    return dataclasses.replace(base, **overrides)


def sdxl_refiner_config(**overrides) -> UNetConfig:
    """SDXL refiner: 384 base channels, attention at the middle two levels (depth
    4) plus a depth-4 middle transformer, OpenCLIP-G context (1280), adm 2560."""
    base = UNetConfig(model_channels=384, channel_mult=(1, 2, 4, 4), attention_levels=(1, 2),
                      transformer_depth=(0, 4, 4, 0), transformer_depth_middle=4,
                      num_heads=-1, context_dim=1280, adm_in_channels=2560)
    return dataclasses.replace(base, **overrides)


def _fourier_filter(x: torch.Tensor, threshold: int, scale: float) -> torch.Tensor:
    """FreeU's skip low-frequency rescale on NCHW: scale the centred
    ``2·threshold``-wide low-frequency box of the 2-D spectrum by ``scale`` (FFT in
    f32); the result in x's dtype."""
    xf = torch.fft.fftshift(torch.fft.fft2(x.float(), dim=(-2, -1)), dim=(-2, -1))
    H, W = x.shape[-2:]
    cy, cx = H // 2, W // 2
    mask = torch.ones((1, 1, H, W), dtype=torch.float32, device=x.device)
    mask[..., max(cy - threshold, 0):cy + threshold, max(cx - threshold, 0):cx + threshold] = \
        float(scale)
    out = torch.fft.ifft2(torch.fft.ifftshift(xf * mask, dim=(-2, -1)), dim=(-2, -1)).real
    return out.to(x.dtype)


def _apply_freeu(cfg: UNetConfig, h: torch.Tensor, skip: torch.Tensor):
    """FreeU on one up-block junction (NCHW): at 4× and 2× the base width, scale
    the backbone's first half-channels (by b, or v2's hidden-mean modulation) and
    low-pass-rescale the skip by s."""
    b1, b2, s1, s2, version = cfg.freeu
    C = h.shape[1]
    stage = {cfg.model_channels * 4: (b1, s1), cfg.model_channels * 2: (b2, s2)}
    if C not in stage:
        return h, skip
    b, s = stage[C]
    half = C // 2
    if version >= 2:
        hidden_mean = h.float().mean(dim=1, keepdim=True)
        h_min = hidden_mean.amin(dim=(1, 2, 3), keepdim=True)
        h_max = hidden_mean.amax(dim=(1, 2, 3), keepdim=True)
        hidden_mean = (hidden_mean - h_min) / torch.clamp(h_max - h_min, min=1e-8)
        scale = ((b - 1.0) * hidden_mean + 1.0).to(h.dtype)
    else:
        # A fill kernel, not a host copy, so the up path stays capturable in a graph.
        scale = torch.full((), b, dtype=h.dtype, device=h.device)
    h = torch.cat([h[:, :half] * scale, h[:, half:]], dim=1)
    return h, _fourier_filter(skip, threshold=1, scale=s)


def middle_depth(cfg: UNetConfig) -> int:
    """Middle-block transformer depth, shared by the UNet and the converter. As in
    the JAX package it is the deepest level's depth only when that level has
    attention, so ``sd15_config()`` and ``sd21_config()`` get none."""
    if cfg.transformer_depth_middle is not None:
        return cfg.transformer_depth_middle
    if len(cfg.channel_mult) - 1 in cfg.attention_levels:
        return cfg.transformer_depth[-1]
    return 0


def _heads_for(cfg: UNetConfig, channels: int) -> int:
    if cfg.num_heads == -1:
        return max(1, channels // 64)
    return cfg.num_heads


def _has_attn(cfg: UNetConfig, level: int) -> bool:
    return level in cfg.attention_levels and cfg.transformer_depth[level] > 0


def _input_schedule(cfg: UNetConfig) -> list[tuple[int, int]]:
    """(level, i) of every input (down) block, in execution order."""
    return [(level, i) for level in range(len(cfg.channel_mult))
            for i in range(cfg.num_res_blocks)]


def _output_schedule(cfg: UNetConfig) -> list[tuple[int, int]]:
    """(level, i) of every output (up) block, in execution order."""
    return [(level, i) for level in reversed(range(len(cfg.channel_mult)))
            for i in range(cfg.num_res_blocks + 1)]


def _skip_base(cfg: UNetConfig, level: int) -> int:
    """Index of the first skip pushed by ``level`` (skip_0 is the input conv's)."""
    last = len(cfg.channel_mult) - 1
    return 1 + sum(cfg.num_res_blocks + (1 if m != last else 0) for m in range(level))


def _total_skips(cfg: UNetConfig) -> int:
    return _skip_base(cfg, len(cfg.channel_mult))


def _conv(cin: int, cout: int, k: int, dtype: torch.dtype, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, dtype=dtype)


class ResBlock(nn.Module):
    """GN → SiLU → conv, + the embedding's projection, GN → SiLU → conv, with a
    1×1 convolution on the shortcut when the width changes (NCHW)."""

    def __init__(self, cfg: UNetConfig, in_ch: int, out_ch: int):
        super().__init__()
        dt = cfg.dtype
        self.GroupNorm_0 = GroupNorm(cfg.norm_groups, in_ch, dt)
        self.Conv_0 = _conv(in_ch, out_ch, 3, dt)
        self.Dense_0 = nn.Linear(cfg.model_channels * 4, out_ch, dtype=dt)
        self.GroupNorm_1 = GroupNorm(cfg.norm_groups, out_ch, dt)
        self.Conv_1 = _conv(out_ch, out_ch, 3, dt)
        if in_ch != out_ch:
            self.Conv_2 = _conv(in_ch, out_ch, 1, dt)

    def forward(self, x, emb):
        h = flax_apply(self.Conv_0, F.silu(self.GroupNorm_0(x)))
        h = h + self.Dense_0(F.silu(emb))[:, :, None, None]
        h = flax_apply(self.Conv_1, F.silu(self.GroupNorm_1(h)))
        if hasattr(self, "Conv_2"):
            x = flax_apply(self.Conv_2, x)
        return x + h


class TransformerBlock(nn.Module):
    """LN → self-attn → LN → cross-attn(context) → LN → GEGLU MLP, pre-norm
    residuals, on (B, S, C) tokens."""

    def __init__(self, cfg: UNetConfig, channels: int):
        super().__init__()
        dt = cfg.dtype
        self.heads = _heads_for(cfg, channels)
        self.head_dim = channels // self.heads
        inner = self.heads * self.head_dim
        for n in ("attn1", "attn2"):
            kv_in = channels if n == "attn1" else cfg.context_dim
            setattr(self, f"{n}_q", nn.Linear(channels, inner, bias=False, dtype=dt))
            setattr(self, f"{n}_k", nn.Linear(kv_in, inner, bias=False, dtype=dt))
            setattr(self, f"{n}_v", nn.Linear(kv_in, inner, bias=False, dtype=dt))
            for p in "qkv":  # int8 scales shared across heads, as the reference's
                getattr(self, f"{n}_{p}").int8_row_groups = self.heads
            setattr(self, f"{n}_o", nn.Linear(inner, channels, dtype=dt))
        self.LayerNorm_0 = LayerNorm(channels, out_dtype=dt)
        self.LayerNorm_1 = LayerNorm(channels, out_dtype=dt)
        self.LayerNorm_2 = LayerNorm(channels, out_dtype=dt)
        self.ff_in = nn.Linear(channels, channels * 8, dtype=dt)
        self.ff_out = nn.Linear(channels * 4, channels, dtype=dt)

    def _mha(self, name: str, q_in, kv_in):
        B = q_in.shape[0]

        def heads(t):
            return t.reshape(B, t.shape[1], self.heads, self.head_dim)

        q = heads(getattr(self, f"{name}_q")(q_in))
        k = heads(getattr(self, f"{name}_k")(kv_in))
        v = heads(getattr(self, f"{name}_v")(kv_in))
        o = attention(q, k, v)
        return getattr(self, f"{name}_o")(o.reshape(B, o.shape[1], -1))

    def forward(self, x, context):
        h = self.LayerNorm_0(x)
        x = x + self._mha("attn1", h, h)
        h = self.LayerNorm_1(x)
        x = x + self._mha("attn2", h, h if context is None else context)
        h = self.LayerNorm_2(x)
        a, b = self.ff_in(h).chunk(2, dim=-1)
        # GEGLU with the exact (erf) GELU, the ldm convention (FLUX uses tanh).
        return x + self.ff_out(a * F.gelu(b))


class SpatialTransformer(nn.Module):
    """GN → 1×1 proj_in → transformer blocks over the H·W tokens → 1×1 proj_out,
    with a residual (NCHW in and out)."""

    def __init__(self, cfg: UNetConfig, channels: int, depth: int):
        super().__init__()
        dt = cfg.dtype
        self.GroupNorm_0 = GroupNorm(cfg.norm_groups, channels, dt)
        self.proj_in = _conv(channels, channels, 1, dt)
        self.blocks = nn.ModuleList(TransformerBlock(cfg, channels) for _ in range(depth))
        self.proj_out = _conv(channels, channels, 1, dt)

    def forward(self, x, context):
        B, C, H, W = x.shape
        h = flax_apply(self.proj_in, self.GroupNorm_0(x))
        h = h.permute(0, 2, 3, 1).reshape(B, H * W, C)
        for block in self.blocks:
            h = block(h, context)
        h = h.reshape(B, H, W, C).permute(0, 3, 1, 2).contiguous()
        return x + flax_apply(self.proj_out, h)


class Downsample(nn.Module):
    """Stride-2 3×3 convolution padded by 1 on every side."""

    def __init__(self, cfg: UNetConfig, channels: int):
        super().__init__()
        self.Conv_0 = _conv(channels, channels, 3, cfg.dtype, stride=2)

    def forward(self, x):
        return flax_apply(self.Conv_0, x)


class Upsample(nn.Module):
    """Nearest ×2, then a 3×3 convolution."""

    def __init__(self, cfg: UNetConfig, channels: int):
        super().__init__()
        self.Conv_0 = _conv(channels, channels, 3, cfg.dtype)

    def forward(self, x):
        return flax_apply(self.Conv_0, F.interpolate(x, scale_factor=2, mode="nearest"))


def _nhwc_to_nchw(t: torch.Tensor) -> torch.Tensor:
    # Contiguous NCHW: GroupNorm on CUDA makes its input contiguous anyway, and one
    # layout through the blocks keeps the residual adds and convolutions from
    # mixing channels-last and contiguous operands.
    return t.permute(0, 3, 1, 2).contiguous()


class UNet2D(nn.Module):
    """forward(x NHWC, timesteps (B,), context (B, S, D), y=(B, adm) for SDXL,
    control={"input": [NHWC residual per skip], "middle": [NHWC]}) → NHWC f32.

    ``control`` adds ControlNet residuals: ``input[j]`` to skip j as it is consumed
    (the host UNet's ``hs.pop()`` order), ``middle[0]`` to the middle block's
    output."""

    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        ch, dt = cfg.model_channels, cfg.dtype
        self.time_embed_0 = nn.Linear(ch, ch * 4, dtype=dt)
        self.time_embed_2 = nn.Linear(ch * 4, ch * 4, dtype=dt)
        if cfg.adm_in_channels is not None:
            self.label_embed_0 = nn.Linear(cfg.adm_in_channels, ch * 4, dtype=dt)
            self.label_embed_2 = nn.Linear(ch * 4, ch * 4, dtype=dt)
        self.input_conv = _conv(cfg.in_channels, ch, 3, dt)
        skip_ch = [ch]
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
                skip_ch.append(cur)
            if level != last:
                self.add_module(f"down_{level}", Downsample(cfg, out_ch))
                skip_ch.append(cur)
        mid_ch = ch * cfg.channel_mult[-1]
        self.mid_res1 = ResBlock(cfg, mid_ch, mid_ch)
        if middle_depth(cfg) > 0:
            self.mid_attn = SpatialTransformer(cfg, mid_ch, middle_depth(cfg))
        self.mid_res2 = ResBlock(cfg, mid_ch, mid_ch)
        cur = mid_ch
        for level, i in _output_schedule(cfg):
            out_ch = ch * cfg.channel_mult[level]
            self.add_module(f"out_{level}_{i}_res", ResBlock(cfg, cur + skip_ch.pop(), out_ch))
            if _has_attn(cfg, level):
                self.add_module(f"out_{level}_{i}_attn", SpatialTransformer(
                    cfg, out_ch, cfg.transformer_depth[level]))
            cur = out_ch
            if i == cfg.num_res_blocks and level != 0:
                self.add_module(f"up_{level}", Upsample(cfg, out_ch))
        self.out_norm = GroupNorm(cfg.norm_groups, cur, dt)
        self.out_conv = _conv(cur, cfg.out_channels, 3, torch.float32)

    # -- the staged forward (the PipelineSpec decomposition) -------------------

    def prepare(self, x, timesteps, context=None, y=None, control=None, **kwargs):
        """Embeddings + input conv; seeds the carry with skip_0 and flattens
        ControlNet residuals into ``ctrl_*`` entries (NCHW)."""
        cfg = self.cfg
        emb = self.time_embed_0(timestep_embedding(timesteps, cfg.model_channels).to(cfg.dtype))
        emb = self.time_embed_2(F.silu(emb))
        if cfg.adm_in_channels is not None:
            if y is None:
                raise ValueError("this config requires vector conditioning `y`")
            emb = emb + self.label_embed_2(F.silu(self.label_embed_0(y.to(cfg.dtype))))
        if context is not None:
            context = context.to(cfg.dtype)
        h = flax_apply(self.input_conv, _nhwc_to_nchw(x.to(cfg.dtype)))
        carry = {"h": h, "emb": emb, "context": context, "skip_0": h}
        if control is not None:
            for j, res in enumerate(control.get("input") or ()):
                carry[f"ctrl_in_{j}"] = _nhwc_to_nchw(res)
            mid_residuals = control.get("middle") or ()
            if mid_residuals:
                carry["ctrl_mid"] = _nhwc_to_nchw(mid_residuals[0])
        return carry

    def input_step(self, carry, level: int, i: int):
        cfg = self.cfg
        h = getattr(self, f"in_{level}_{i}_res")(carry["h"], carry["emb"])
        if _has_attn(cfg, level):
            h = getattr(self, f"in_{level}_{i}_attn")(h, carry["context"])
        out = dict(carry)
        idx = _skip_base(cfg, level) + i
        out[f"skip_{idx}"] = h
        if i == cfg.num_res_blocks - 1 and level != len(cfg.channel_mult) - 1:
            h = getattr(self, f"down_{level}")(h)
            out[f"skip_{idx + 1}"] = h
        out["h"] = h
        return out

    def middle_step(self, carry):
        h = self.mid_res1(carry["h"], carry["emb"])
        if middle_depth(self.cfg) > 0:
            h = self.mid_attn(h, carry["context"])
        h = self.mid_res2(h, carry["emb"])
        if "ctrl_mid" in carry:
            h = h + carry["ctrl_mid"].to(h.dtype)
        n_ctrl = sum(1 for k in carry if k.startswith("ctrl_in_"))
        n_skips = sum(1 for k in carry if k.startswith("skip_"))
        if n_ctrl and n_ctrl != n_skips:
            raise ValueError(f"control['input'] has {n_ctrl} residuals for {n_skips} skip "
                             "connections — ControlNet/UNet config mismatch")
        return {**carry, "h": h}

    def output_step(self, carry, level: int, i: int):
        cfg = self.cfg
        # The j-th output block consumes the skip stack last in, first out.
        j = (len(cfg.channel_mult) - 1 - level) * (cfg.num_res_blocks + 1) + i
        idx = _total_skips(cfg) - 1 - j
        out = dict(carry)
        skip = out.pop(f"skip_{idx}")
        ctrl = out.pop(f"ctrl_in_{idx}", None)
        if ctrl is not None:
            skip = skip + ctrl.to(skip.dtype)
        h = out["h"]
        if cfg.freeu is not None:
            h, skip = _apply_freeu(cfg, h, skip)
        h = getattr(self, f"out_{level}_{i}_res")(torch.cat([h, skip], dim=1), out["emb"])
        if _has_attn(cfg, level):
            h = getattr(self, f"out_{level}_{i}_attn")(h, out["context"])
        if i == cfg.num_res_blocks and level != 0:
            h = getattr(self, f"up_{level}")(h)
        out["h"] = h
        return out

    def finalize(self, carry, out_shape: tuple[int, ...]):
        """Final norm + projection in f32, back to NHWC (``out_shape`` is the
        PipelineSpec contract; the carry already knows the geometry)."""
        del out_shape
        h = F.silu(self.out_norm(carry["h"]))
        return self.out_conv(h.float()).permute(0, 2, 3, 1).contiguous()

    def forward(self, x, timesteps, context=None, y=None, control=None, **kwargs):
        cfg = self.cfg
        carry = self.prepare(x, timesteps, context, y=y, control=control)
        for level, i in _input_schedule(cfg):
            carry = self.input_step(carry, level, i)
        carry = self.middle_step(carry)
        for level, i in _output_schedule(cfg):
            carry = self.output_step(carry, level, i)
        return self.finalize(carry, tuple(x.shape))


def _unet_pipeline_spec(cfg: UNetConfig) -> PipelineSpec:
    """Stage decomposition of the UNet forward: embeddings and the input conv on
    the lead device, one segment per input, middle and output block, the final
    norm and projection on the lead. The skips ride the carry as statically
    indexed ``skip_{i}`` entries, so its structure at every boundary is fixed per
    config."""

    def make_input(level, i):
        return lambda module, carry: module.input_step(carry, level, i)

    def make_output(level, i):
        return lambda module, carry: module.output_step(carry, level, i)

    last = len(cfg.channel_mult) - 1
    segments = []
    for level, i in _input_schedule(cfg):
        keys = [f"in_{level}_{i}_res"]
        if _has_attn(cfg, level):
            keys.append(f"in_{level}_{i}_attn")
        if i == cfg.num_res_blocks - 1 and level != last:
            keys.append(f"down_{level}")
        segments.append(PipelineSegment(tuple(keys), make_input(level, i),
                                        f"input[{level}.{i}]"))
    mid_keys = ["mid_res1", "mid_res2"]
    if middle_depth(cfg) > 0:
        mid_keys.insert(1, "mid_attn")
    segments.append(PipelineSegment(tuple(mid_keys),
                                    lambda module, carry: module.middle_step(carry), "middle"))
    for level, i in _output_schedule(cfg):
        keys = [f"out_{level}_{i}_res"]
        if _has_attn(cfg, level):
            keys.append(f"out_{level}_{i}_attn")
        if i == cfg.num_res_blocks and level != 0:
            keys.append(f"up_{level}")
        segments.append(PipelineSegment(tuple(keys), make_output(level, i),
                                        f"output[{level}.{i}]"))
    prepare_keys = ["time_embed_0", "time_embed_2", "input_conv"]
    if cfg.adm_in_channels is not None:
        prepare_keys[2:2] = ["label_embed_0", "label_embed_2"]
    return PipelineSpec(
        prepare_keys=tuple(prepare_keys),
        prepare=lambda module, x, t, context=None, **kw: module.prepare(x, t, context, **kw),
        segments=tuple(segments),
        finalize_keys=("out_norm", "out_conv"),
        finalize=lambda module, carry, out_shape: module.finalize(carry, out_shape),
    )


def build_unet(cfg: UNetConfig, *, device=None, generator: torch.Generator | None = None,
               state_dict: dict | None = None, name: str = "sd-unet") -> DiffusionModel:
    """A UNet ``DiffusionModel`` on ``device`` (default ``cuda:0``), from
    ``state_dict`` (``convert_unet`` or ``convert_jax``) or random weights from
    ``generator``. The module is materialised on the device without a host copy."""
    device = torch.device(device) if device is not None else default_device()
    if state_dict is None and generator is None:
        raise ValueError("need a generator to initialise (or pass state_dict=)")
    with torch.device("meta"):
        module = UNet2D(cfg)
    module = module.to_empty(device=device).eval()
    if state_dict is not None:
        module.load_state_dict(state_dict)
    else:
        init_random_(module, generator)
    return DiffusionModel(module=module, name=name, config=cfg, block_lists=None,
                          pipeline_spec=_unet_pipeline_spec(cfg))


class InpaintConditioned(nn.Module):
    """A 9-channel inpaint UNet with its conditioning channels as buffers: every
    forward's input becomes ``concat([x, mask, masked_latent], channel)``."""

    def __init__(self, base: nn.Module, mask: torch.Tensor, masked_latent: torch.Tensor):
        super().__init__()
        self.base = base
        self.register_buffer("mask", mask)
        self.register_buffer("masked", masked_latent)

    @staticmethod
    def _broadcast(a: torch.Tensor, batch: int) -> torch.Tensor:
        if a.ndim == 3:
            a = a[None]
        if a.shape[0] != batch:
            if a.shape[0] != 1:
                raise ValueError(
                    f"inpaint conditioning batch {a.shape[0]} != latent batch {batch}: pass "
                    "ONE mask/masked-image (it broadcasts); per-sample conditioning is not "
                    "supported")
            a = a.expand(batch, *a.shape[1:])
        return a

    def forward(self, x, timesteps, context=None, **kwargs):
        m = self._broadcast(self.mask, x.shape[0]).to(x.dtype)
        ml = self._broadcast(self.masked, x.shape[0]).to(x.dtype)
        return self.base(torch.cat([x, m, ml], dim=-1), timesteps, context, **kwargs)


def apply_inpaint_conditioning(base: DiffusionModel, mask, masked_latent) -> DiffusionModel:
    """Compose the sd-inpainting checkpoint's input convention (4 + 1 + 4 channels)
    into a ``DiffusionModel``: every denoise step's input becomes ``concat([x, mask,
    masked_latent], channel)``. The conditioning rides the module as buffers, so
    the composition places through ``parallelize`` like a single model. ``mask`` is
    1 where content is regenerated, at latent resolution ((1|B, H, W, 1));
    ``masked_latent`` is the VAE encode of the mask-blanked pixels."""
    device = next(base.module.parameters()).device
    module = InpaintConditioned(
        base.module, torch.as_tensor(mask, dtype=torch.float32).to(device),
        torch.as_tensor(masked_latent, dtype=torch.float32).to(device))
    return DiffusionModel(module=module, name=f"{base.name}+inpaint", config=base.config)


UNCLIP_NOISE_LEVELS = 1000


def unclip_alphas_cumprod() -> torch.Tensor:
    """The squared-cosine alpha-bar table (``squaredcos_cap_v2``, f32) of the host's
    ``CLIPEmbeddingNoiseAugmentation``: beta_t = 1 − bar((t+1)/T)/bar(t/T) capped at
    0.999, with bar(s) = cos²(((s + 0.008)/1.008)·π/2), computed in f64."""
    n = UNCLIP_NOISE_LEVELS
    t = torch.arange(n, dtype=torch.float64)

    def bar(s):
        return torch.cos((s + 0.008) / 1.008 * math.pi / 2.0) ** 2

    betas = torch.clamp(1.0 - bar((t + 1) / n) / bar(t / n), 0.0, 0.999)
    return torch.cumprod(1.0 - betas, dim=0).float()


def unclip_augment(emb: torch.Tensor, aug: float, noise: torch.Tensor, level_dim: int):
    """One noise augmentation: the level ``round(999·aug)`` (aug clamped to [0, 1]),
    ``emb`` q-sampled to it with ``noise`` (DDPM over ``unclip_alphas_cumprod``),
    and the level's ``level_dim``-wide sinusoidal embedding. Returns (noised,
    level embedding), f32."""
    n = UNCLIP_NOISE_LEVELS
    level = int(round((n - 1) * max(0.0, min(1.0, aug))))
    a = unclip_alphas_cumprod()[level].to(emb.device)
    noised = torch.sqrt(a) * emb + torch.sqrt(1.0 - a) * noise
    lvl = torch.full((emb.shape[0],), float(level), dtype=torch.float32, device=emb.device)
    return noised, timestep_embedding(lvl, level_dim)


def unclip_noise(generator: torch.Generator, i: int, shape, device) -> torch.Tensor:
    """The N(0, 1) draw (f32) of augmentation ``i`` (the tags in order, then the
    merge): the next draw of ``generator``, which ``unclip_adm`` draws in that order."""
    return torch.randn(shape, generator=generator, dtype=torch.float32, device=device)


def unclip_adm(tags, adm_in_channels: int, generator: torch.Generator | None = None,
               merge_augmentation: float = 0.05, device=None) -> torch.Tensor:
    """SD2.x-unCLIP's adm vector from ``unCLIPConditioning`` tags: each tag's CLIP
    image embeds (the first row) noise-augmented to its ``noise_augmentation``
    level (``unclip_augment``), joined with the level's sinusoidal embedding,
    weighted by ``strength`` and summed; with more than one tag the summed embeds
    are augmented again at ``merge_augmentation`` (the host's noise_augment_merge).
    Returns (1, adm_in_channels) f32 on ``device`` (default: the first tag's embeds'
    device when they are a tensor, else ``cuda:0``); the caller broadcasts it to the
    batch, and CFG's uncond half takes zeros."""
    if device is None:
        first = tags[0]["embeds"]
        device = first.device if torch.is_tensor(first) else default_device()
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    outs = []
    for i, tag in enumerate(tags):
        emb = torch.as_tensor(tag["embeds"], dtype=torch.float32).to(device)
        if emb.ndim == 1:
            emb = emb[None]
        emb = emb[:1]
        noised, lvl_emb = unclip_augment(
            emb, float(tag.get("noise_augmentation", 0.0)),
            unclip_noise(generator, i, emb.shape, device), adm_in_channels - emb.shape[-1])
        outs.append(torch.cat([noised, lvl_emb], dim=-1) * float(tag.get("strength", 1.0)))
    y = sum(outs)
    if len(outs) > 1:
        emb_dim = torch.as_tensor(tags[0]["embeds"]).shape[-1]
        emb = y[:, :emb_dim]
        noised, lvl_emb = unclip_augment(
            emb, merge_augmentation, unclip_noise(generator, len(outs), emb.shape, device),
            adm_in_channels - emb_dim)
        y = torch.cat([noised, lvl_emb], dim=-1)
    return y
