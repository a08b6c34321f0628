"""Wan-class causal 3D video VAE in PyTorch (counterpart of
``comfyui_parallelanything_tpu/models/video_vae.py``).

Maps pixel clips (B, T, H, W, 3) to latent clips (B, 1 + (T-1)/4, H/8, W/8, z) and
back: 8× spatial and 4× temporal compression, the first frame kept un-downsampled
in time, so a clip of T = 4k+1 frames encodes to k+1 latent frames. Every temporal
convolution is causal (padded at the front only), so frame t's latent never
depends on frames after t. The whole clip is one pass, as in the JAX module (no
streaming feature cache); ``decode_tiled`` bounds memory by spatial tiles.

NTHWC at every public boundary, as in the JAX package; inside, the convolutions run
on NCTHW tensors (the spatial-only convolutions are Conv3d with a 1×3×3 kernel);
above ``CHUNK_ELEMS`` elements the convolutions, norms and resamples run a chunk
of frames at a time (``_by_frames``; the causal convolutions read each chunk's
kt - 1 frames of context), which bounds the full-resolution levels' memory without
changing a value. Numerics follow the JAX module: convolutions compute in
``cfg.dtype`` (weights stored in it); the channel RMS norm (eps 1e-12, an optional
bias in the attention block) in f32. The mid-block attention folds frames into the
batch and runs one head over each frame's H·W positions through
``ops.attention.attention_local``: on a CUDA tensor that is K1 (its ``wide``
variant at the Wan VAE's 384 channels).
Submodule names follow the flax tree (``encoder.down_0_block_0.conv1.conv``), so
``convert_jax.from_jax_video_vae_params`` is a rename plus transposes.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..devices.discovery import default_device
from ..ops.attention import attention_local
from .tiling import blend_mask1d, tile_starts
from .vae import posterior_noise

# Per-channel latent statistics of the Wan 16-channel VAE (the published
# normalization constants; latents are stored as (z - mean) / std).
WAN_LATENT_MEAN = (
    -0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508,
    0.4134, -0.0715, 0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921,
)
WAN_LATENT_STD = (
    2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743,
    3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253, 2.8251, 1.9160,
)


@dataclasses.dataclass(frozen=True)
class VideoVAEConfig:
    in_channels: int = 3
    z_channels: int = 16
    base_channels: int = 96
    channel_mult: tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    # Per non-final level: does its downsample also halve time? (False, True, True)
    # → spatial 8×, temporal 4×.
    temporal_downsample: tuple[bool, ...] = (False, True, True)
    latent_mean: tuple[float, ...] = WAN_LATENT_MEAN
    latent_std: tuple[float, ...] = WAN_LATENT_STD
    dtype: torch.dtype = torch.bfloat16

    @property
    def spatial_factor(self) -> int:
        return 2 ** (len(self.channel_mult) - 1)

    @property
    def temporal_factor(self) -> int:
        return 2 ** sum(self.temporal_downsample)

    def latent_frames(self, t: int) -> int:
        """Pixel frames → latent frames (the first frame is never merged)."""
        f = self.temporal_factor
        if (t - 1) % f:
            raise ValueError(f"frame count must be 1 mod {f}, got {t}")
        return 1 + (t - 1) // f


def wan_vae_config(**overrides) -> VideoVAEConfig:
    return dataclasses.replace(VideoVAEConfig(), **overrides)


# Above this many elements a tensor at a full-resolution level (the Wan VAE's
# outermost levels hold 6.2 GB per tensor at 480×832×81) runs through the
# frame-local and causal operations a chunk of frames at a time, into one
# preallocated output: the padded copies, the f32 statistics and the upsampled
# frames then exist for one chunk only, never for the whole clip.
CHUNK_ELEMS = 2**28


def _chunk_frames(x: torch.Tensor, growth: int = 1) -> int:
    """Frames per chunk for an NCTHW tensor whose per-frame work is ``growth`` times
    its input frame."""
    per_frame = x.numel() // max(1, x.shape[2]) * growth
    return max(1, CHUNK_ELEMS // max(1, per_frame))


def _by_frames(fn, x: torch.Tensor, growth: int = 1) -> torch.Tensor:
    """``fn`` applied to ``x`` (NCTHW) whole, or frame-chunk by frame-chunk into one
    output when ``x`` is large; ``fn`` must be frame-local."""
    n = _chunk_frames(x, growth)
    if n >= x.shape[2]:
        return fn(x)
    out = None
    for a in range(0, x.shape[2], n):
        y = fn(x[:, :, a:a + n])
        if out is None:
            out = y.new_empty((*y.shape[:2], x.shape[2], *y.shape[3:]))
        out[:, :, a:a + n] = y
    return out


class _RMSNormC(nn.Module):
    """Channel RMS norm over dim 1 of NCTHW (Wan's ``F.normalize · √C · γ`` is this
    form) in f32, then the optional bias (the attention block's), as the JAX
    module computes it."""

    def __init__(self, channels: int, bias: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels)) if bias else None

    def _norm(self, x):
        shape = (1, -1) + (1,) * (x.ndim - 2)
        xf = x.float()
        y = xf * torch.rsqrt(xf.square().mean(dim=1, keepdim=True) + 1e-12)
        y = (y * self.weight.view(shape)).to(x.dtype)
        if self.bias is not None:
            y = (y.float() + self.bias.view(shape)).to(x.dtype)
        return y

    def forward(self, x):
        return _by_frames(self._norm, x, growth=4)


class CausalConv3d(nn.Module):
    """3D convolution on NCTHW with causal time padding (front only, kt - 1 frames)
    and SAME spatial padding: with time stride s, T → (T - 1)//s + 1, the
    first-frame-preserving schedule. A large input runs a chunk of output frames at
    a time, each reading its own kt - 1 frames of context."""

    def __init__(self, cin: int, cout: int, kernel=(3, 3, 3), stride=(1, 1, 1),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.kt, kh, kw = kernel
        self.conv = nn.Conv3d(cin, cout, kernel, stride=stride, padding=(0, kh // 2, kw // 2),
                              dtype=dtype)

    def forward(self, x):
        x = x.to(self.conv.weight.dtype)
        kt, st = self.kt, self.conv.stride[0]
        t_out = (x.shape[2] - 1) // st + 1
        n = _chunk_frames(x, growth=kt)
        if n >= x.shape[2]:
            return self.conv(F.pad(x, (0, 0, 0, 0, kt - 1, 0)) if kt > 1 else x)
        n = max(1, n // st)  # output frames per chunk
        out = None
        for o in range(0, t_out, n):
            o_end = min(t_out, o + n)
            lo, hi = o * st - (kt - 1), (o_end - 1) * st + 1  # the input frames read
            xs = x[:, :, max(lo, 0):hi]
            if lo < 0:
                xs = F.pad(xs, (0, 0, 0, 0, -lo, 0))
            y = self.conv(xs)
            if out is None:
                out = y.new_empty((*y.shape[:2], t_out, *y.shape[3:]))
            out[:, :, o:o_end] = y
        return out


class VideoResBlock(nn.Module):
    def __init__(self, cfg: VideoVAEConfig, in_ch: int, out_ch: int):
        super().__init__()
        self.norm1 = _RMSNormC(in_ch)
        self.conv1 = CausalConv3d(in_ch, out_ch, dtype=cfg.dtype)
        self.norm2 = _RMSNormC(out_ch)
        self.conv2 = CausalConv3d(out_ch, out_ch, dtype=cfg.dtype)
        if in_ch != out_ch:
            self.shortcut = CausalConv3d(in_ch, out_ch, kernel=(1, 1, 1), dtype=cfg.dtype)

    def forward(self, x):
        # Each intermediate is dropped as soon as the next exists: at most three
        # full-size tensors live at once.
        h = F.silu(self.norm1(x), inplace=True)
        h = self.conv1(h)
        h = F.silu(self.norm2(h), inplace=True)
        h = self.conv2(h)
        if hasattr(self, "shortcut"):
            x = self.shortcut(x)
        return h.add_(x)


class FrameAttnBlock(nn.Module):
    """Per-frame single-head spatial attention (the mid-block attention): frames
    fold into the batch, so time never mixes here. q/k/v are views of one fused
    1×1×1 projection."""

    def __init__(self, cfg: VideoVAEConfig, ch: int):
        super().__init__()
        self.norm = _RMSNormC(ch, bias=True)
        self.to_qkv = nn.Conv3d(ch, 3 * ch, 1, dtype=cfg.dtype)
        self.proj = nn.Conv3d(ch, ch, 1, dtype=cfg.dtype)

    @staticmethod
    def _linear(conv: nn.Conv3d, h):  # a 1×1×1 convolution on channels-last as a linear
        w = conv.weight
        return F.linear(h.to(w.dtype), w.reshape(w.shape[0], w.shape[1]), conv.bias)

    def forward(self, x):
        B, C, T, H, W = x.shape
        h = self.norm(x).permute(0, 2, 3, 4, 1)  # (B, T, H, W, C)
        qkv = self._linear(self.to_qkv, h).reshape(B * T, H * W, 1, 3 * C)
        q, k, v = qkv.split(C, dim=-1)
        h = attention_local(q, k, v).reshape(B, T, H, W, C)
        return x + self._linear(self.proj, h).permute(0, 4, 1, 2, 3)


class SpatialDownsample(nn.Module):
    """(0, 1) × (0, 1) zero pad + a VALID stride-2 1×3×3 convolution (frame-local);
    in temporal mode then a causal stride-2 time convolution."""

    def __init__(self, cfg: VideoVAEConfig, ch: int, temporal: bool = False):
        super().__init__()
        self.conv = nn.Conv3d(ch, ch, (1, 3, 3), stride=(1, 2, 2), dtype=cfg.dtype)
        if temporal:
            self.time_conv = CausalConv3d(ch, ch, kernel=(3, 1, 1), stride=(2, 1, 1),
                                          dtype=cfg.dtype)

    def _spatial(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)).to(self.conv.weight.dtype))

    def forward(self, x):
        h = _by_frames(self._spatial, x, growth=2)
        if hasattr(self, "time_conv"):
            h = self.time_conv(h)
        return h


class SpatialUpsample(nn.Module):
    """Nearest 2× on H, W + a 1×3×3 convolution halving channels; in temporal mode a
    causal time convolution first emits two frames per input frame, interleaved in
    time, and the first duplicate is dropped: T latent frames → 2T - 1."""

    def __init__(self, cfg: VideoVAEConfig, ch: int, temporal: bool = False):
        super().__init__()
        if temporal:
            self.time_conv = CausalConv3d(ch, 2 * ch, kernel=(3, 1, 1), dtype=cfg.dtype)
        self.conv = nn.Conv3d(ch, ch // 2, (1, 3, 3), padding=(0, 1, 1), dtype=cfg.dtype)

    def _spatial(self, x):
        x = F.interpolate(x, scale_factor=(1, 2, 2), mode="nearest")
        return self.conv(x.to(self.conv.weight.dtype))

    def forward(self, x):
        if hasattr(self, "time_conv"):
            B, C, T, H, W = x.shape
            h = self.time_conv(x).reshape(B, 2, C, T, H, W)
            # Channel half s of frame t becomes frame 2t + s.
            x = h.permute(0, 2, 3, 1, 4, 5).reshape(B, C, 2 * T, H, W)[:, :, 1:]
        return _by_frames(self._spatial, x, growth=6)


class _Stack(nn.Module):
    """conv_in → the named blocks in the order added → RMS norm, SiLU, conv_out."""

    def __init__(self):
        super().__init__()
        self._names: list[str] = []

    def _add(self, name: str, module: nn.Module) -> None:
        self.add_module(name, module)
        self._names.append(name)

    def forward(self, x):
        h = self.conv_in(x)
        for name in self._names:
            h = getattr(self, name)(h)
        return self.conv_out(F.silu(self.norm_out(h), inplace=True))


class VideoEncoder(_Stack):
    def __init__(self, cfg: VideoVAEConfig):
        super().__init__()
        ch = cfg.base_channels
        self.conv_in = CausalConv3d(cfg.in_channels, ch, dtype=cfg.dtype)
        for level, mult in enumerate(cfg.channel_mult):
            out = cfg.base_channels * mult
            for i in range(cfg.num_res_blocks):
                self._add(f"down_{level}_block_{i}", VideoResBlock(cfg, ch, out))
                ch = out
            if level != len(cfg.channel_mult) - 1:
                self._add(f"down_{level}_downsample",
                          SpatialDownsample(cfg, ch, cfg.temporal_downsample[level]))
        self._add("mid_block_1", VideoResBlock(cfg, ch, ch))
        self._add("mid_attn_1", FrameAttnBlock(cfg, ch))
        self._add("mid_block_2", VideoResBlock(cfg, ch, ch))
        self.norm_out = _RMSNormC(ch)
        self.conv_out = CausalConv3d(ch, 2 * cfg.z_channels, dtype=cfg.dtype)


class VideoDecoder(_Stack):
    """Mirror of the encoder. Each upsample halves the channels, so the first block
    of every post-upsample level re-expands from half the previous level's width."""

    def __init__(self, cfg: VideoVAEConfig):
        super().__init__()
        ch = cfg.base_channels * cfg.channel_mult[-1]
        self.conv_in = CausalConv3d(cfg.z_channels, ch, dtype=cfg.dtype)
        self._add("mid_block_1", VideoResBlock(cfg, ch, ch))
        self._add("mid_attn_1", FrameAttnBlock(cfg, ch))
        self._add("mid_block_2", VideoResBlock(cfg, ch, ch))
        temporal_up = tuple(reversed(cfg.temporal_downsample))
        n = len(cfg.channel_mult)
        for j, level in enumerate(reversed(range(n))):
            out = cfg.base_channels * cfg.channel_mult[level]
            for i in range(cfg.num_res_blocks + 1):
                self._add(f"up_{level}_block_{i}", VideoResBlock(cfg, ch, out))
                ch = out
            if j != n - 1:
                self._add(f"up_{level}_upsample", SpatialUpsample(cfg, ch, temporal_up[j]))
                ch //= 2
        self.norm_out = _RMSNormC(ch)
        self.conv_out = CausalConv3d(ch, cfg.in_channels, dtype=cfg.dtype)


class VideoAutoencoderKL(nn.Module):
    """Encoder + decoder; every method takes and returns NTHWC tensors."""

    def __init__(self, cfg: VideoVAEConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = VideoEncoder(cfg)
        self.decoder = VideoDecoder(cfg)
        z = cfg.z_channels
        self.quant_conv = CausalConv3d(2 * z, 2 * z, kernel=(1, 1, 1), dtype=cfg.dtype)
        self.post_quant_conv = CausalConv3d(z, z, kernel=(1, 1, 1), dtype=cfg.dtype)

    def _stats(self, like: torch.Tensor):
        mu = torch.tensor(self.cfg.latent_mean, dtype=like.dtype, device=like.device)
        sd = torch.tensor(self.cfg.latent_std, dtype=like.dtype, device=like.device)
        return mu, sd

    def moments(self, x):
        """Clip (B, T, H, W, 3 in [-1, 1]) → (mean, logvar) of the latent posterior."""
        h = self.quant_conv(self.encoder(x.permute(0, 4, 1, 2, 3)))
        mean, logvar = h.permute(0, 2, 3, 4, 1).chunk(2, dim=-1)
        return mean, torch.clamp(logvar, -30.0, 20.0)

    def encode(self, x, rng: torch.Generator | None = None):
        """Clip (T ≡ 1 mod the temporal factor) → normalised latent
        (B, 1 + (T-1)/tf, H/8, W/8, z): the posterior mean, or with ``rng`` its
        sample drawn from that generator."""
        mean, logvar = self.moments(x)
        z = mean
        if rng is not None:
            z = mean + torch.exp(0.5 * logvar) * posterior_noise(
                mean.shape, mean.dtype, mean.device, rng)
        mu, sd = self._stats(z)
        return (z - mu) / sd

    def decode(self, z):
        """Normalised latent → clip (B, tf·(T-1) + 1, 8·H, 8·W, 3)."""
        mu, sd = self._stats(z)
        h = self.post_quant_conv((z * sd + mu).permute(0, 4, 1, 2, 3))
        return self.decoder(h).permute(0, 2, 3, 4, 1)

    def forward(self, x, rng: torch.Generator | None = None):
        return self.decode(self.encode(x, rng))


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


@dataclasses.dataclass
class VideoVAE:
    """The video VAE handle: a ``VideoAutoencoderKL`` and its config, with the image
    ``VAE``'s interface so nodes and pipelines treat both alike. Methods take NTHWC
    tensors (or numpy arrays), move them to the module's device and run without
    gradients."""

    module: VideoAutoencoderKL
    cfg: VideoVAEConfig

    @property
    def device(self) -> torch.device:
        return self.module.decoder.conv_in.conv.weight.device

    def _in(self, a) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def encode(self, x, rng: torch.Generator | None = None) -> torch.Tensor:
        with torch.no_grad():
            return self.module.encode(self._in(x), rng)

    def decode(self, z) -> torch.Tensor:
        with torch.no_grad():
            return self.module.decode(self._in(z))

    @property
    def spatial_factor(self) -> int:
        return self.cfg.spatial_factor

    @property
    def temporal_factor(self) -> int:
        return self.cfg.temporal_factor

    def decode_tiled(self, z, tile: int = 32, overlap: int = 8) -> torch.Tensor:
        """Spatially tiled decode with linear overlap blending on the host, time kept
        whole (the temporal convolutions are causal along an axis tiling never
        cuts), with the JAX package's window starts and blend ramps. Returns f32."""
        B, T, H, W, _ = z.shape
        if H <= tile and W <= tile:
            return self.decode(z)
        if not 0 <= overlap < tile:
            raise ValueError(f"need 0 <= overlap < tile, got {overlap=} {tile=}")
        f = self.spatial_factor
        t_out = self.temporal_factor * (T - 1) + 1
        stride = tile - overlap
        z = self._in(z)
        th, tw = min(tile, H), min(tile, W)
        mask = (blend_mask1d(th, overlap, f)[:, None]
                * blend_mask1d(tw, overlap, f)[None, :])[None, None, :, :, None]
        out = np.zeros((B, t_out, H * f, W * f, self.cfg.in_channels), np.float32)
        weight = np.zeros((1, 1, H * f, W * f, 1), np.float32)
        for hs in tile_starts(H, th, stride):
            for ws in tile_starts(W, tw, stride):
                dec = _host(self.decode(z[:, :, hs : hs + th, ws : ws + tw, :]))
                out[:, :, hs * f : (hs + th) * f, ws * f : (ws + tw) * f] += dec * mask
                weight[:, :, hs * f : (hs + th) * f, ws * f : (ws + tw) * f] += mask
        return torch.from_numpy(out / weight).to(self.device)


@torch.no_grad()
def init_random_(module: nn.Module, generator: torch.Generator) -> None:
    """Random weights from ``generator``, in place: every convolution N(0, 1/fan_in)
    with zero bias, every RMS norm scale one and bias zero."""
    for m in module.modules():
        if isinstance(m, nn.Conv3d):
            m.weight.normal_(0.0, 1.0 / math.sqrt(m.weight[0].numel()), generator=generator)
            m.bias.zero_()
        elif isinstance(m, _RMSNormC):
            m.weight.fill_(1.0)
            if m.bias is not None:
                m.bias.zero_()


def build_video_vae(cfg: VideoVAEConfig, *, device=None,
                    generator: torch.Generator | None = None,
                    state_dict: dict | None = None) -> VideoVAE:
    """A video VAE on ``device`` (default ``cuda:0``), from ``state_dict``
    (``convert_wan_vae`` or ``convert_jax``) or random weights from ``generator``."""
    device = torch.device(device) if device is not None else default_device()
    if state_dict is None and generator is None:
        raise ValueError("need a generator to initialise (or pass state_dict=)")
    with torch.device("meta"):
        module = VideoAutoencoderKL(cfg)
    module = module.to_empty(device=device).eval()
    with torch.no_grad():
        if state_dict is not None:
            module.load_state_dict(state_dict)
        else:
            init_random_(module, generator)
    return VideoVAE(module=module, cfg=cfg)
