"""AutoencoderKL (the SD/SDXL/SD3/FLUX image VAE) in PyTorch (counterpart of
``comfyui_parallelanything_tpu/models/vae.py``).

NHWC at every public boundary, as in the JAX package; inside, the convolutions
run on NCHW tensors. Numerics follow the JAX module: convolutions compute in
``cfg.dtype`` (weights stored in it, as flax casts them to it before use),
GroupNorm at eps 1e-6 in f32 with f32 scale and bias, the result cast back to
``cfg.dtype``. The mid-block attention is one head over all H·W positions
through ``ops.attention.attention_local``: on a CUDA tensor that is the flash
attention kernel K1 (its ``d512`` variant for the 512-wide head). ``Downsample``
pads (0, 1) × (0, 1) and runs a VALID stride-2 convolution; ``Upsample`` is
nearest ×2. Submodule names follow the flax tree (``encoder.down_0_block_0.conv1``),
so ``convert_jax.from_jax_vae_params`` is a rename plus transposes.

``VAE.encode_tiled`` / ``decode_tiled`` accumulate the blended tiles on the host
in numpy, with the JAX package's window starts and blend ramps.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..devices.discovery import default_device
from ..ops.attention import attention_local
from ..ops.basic import GroupNorm, flax_apply, init_random_
from ..ops.resize import resize
from .tiling import blend_mask1d, tile_starts


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    z_channels: int = 4
    base_channels: int = 128
    channel_mult: tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    norm_groups: int = 32
    # latent = (encode(x) - shift) * scale; decode takes latent / scale + shift.
    scaling_factor: float = 0.18215
    shift_factor: float = 0.0
    # SD-family checkpoints carry 1x1 quant/post_quant convs around the latent;
    # FLUX's ae.safetensors does not.
    use_quant_conv: bool = True
    dtype: torch.dtype = torch.bfloat16


def sd_vae_config(**overrides) -> VAEConfig:
    """SD1.5 kl-f8 VAE (also the SD2.x shape)."""
    return dataclasses.replace(VAEConfig(), **overrides)


def sdxl_vae_config(**overrides) -> VAEConfig:
    return dataclasses.replace(VAEConfig(scaling_factor=0.13025), **overrides)


def sd3_vae_config(**overrides) -> VAEConfig:
    """SD3's 16-channel autoencoder (no quant convs; scale/shift from the SD3 release)."""
    base = VAEConfig(z_channels=16, scaling_factor=1.5305, shift_factor=0.0609,
                     use_quant_conv=False)
    return dataclasses.replace(base, **overrides)


def flux_vae_config(**overrides) -> VAEConfig:
    """FLUX/Z-Image 16-channel autoencoder (scale/shift from the flux repo)."""
    base = VAEConfig(z_channels=16, scaling_factor=0.3611, shift_factor=0.1159,
                     use_quant_conv=False)
    return dataclasses.replace(base, **overrides)


def _conv(cin: int, cout: int, k: int, cfg: VAEConfig, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2 if stride == 1 else 0,
                     dtype=cfg.dtype)


class VAEResBlock(nn.Module):
    def __init__(self, cfg: VAEConfig, in_ch: int, out_ch: int):
        super().__init__()
        self.norm1 = GroupNorm(cfg.norm_groups, in_ch, cfg.dtype)
        self.conv1 = _conv(in_ch, out_ch, 3, cfg)
        self.norm2 = GroupNorm(cfg.norm_groups, out_ch, cfg.dtype)
        self.conv2 = _conv(out_ch, out_ch, 3, cfg)
        if in_ch != out_ch:
            self.nin_shortcut = _conv(in_ch, out_ch, 1, cfg)

    def forward(self, x):
        h = flax_apply(self.conv1, F.silu(self.norm1(x)))
        h = flax_apply(self.conv2, F.silu(self.norm2(h)))
        if hasattr(self, "nin_shortcut"):
            x = flax_apply(self.nin_shortcut, x)
        return x + h


class VAEAttnBlock(nn.Module):
    """Single-head full spatial self-attention (the kl-f8 mid-block attention)."""

    def __init__(self, cfg: VAEConfig, ch: int):
        super().__init__()
        self.norm = GroupNorm(cfg.norm_groups, ch, cfg.dtype)
        self.q = _conv(ch, ch, 1, cfg)
        self.k = _conv(ch, ch, 1, cfg)
        self.v = _conv(ch, ch, 1, cfg)
        self.proj_out = _conv(ch, ch, 1, cfg)

    @staticmethod
    def _proj(conv: nn.Conv2d, h):  # a 1×1 convolution on NHWC as a linear
        w = conv.weight
        return F.linear(h.to(w.dtype), w.reshape(w.shape[0], w.shape[1]), conv.bias)

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.norm(x).permute(0, 2, 3, 1)  # NHWC
        # (B, H·W, 1 head, C) through the backend-dispatched attention.
        q, k, v = (self._proj(m, h).reshape(B, H * W, 1, C) for m in (self.q, self.k, self.v))
        h = attention_local(q, k, v).reshape(B, H, W, C)
        h = self._proj(self.proj_out, h).permute(0, 3, 1, 2)
        return x + h


class Downsample(nn.Module):
    def __init__(self, cfg: VAEConfig, ch: int):
        super().__init__()
        self.conv = _conv(ch, ch, 3, cfg, stride=2)

    def forward(self, x):
        # ldm kl-f8: asymmetric (0,1)x(0,1) padding + VALID stride-2 conv.
        return flax_apply(self.conv, F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    def __init__(self, cfg: VAEConfig, ch: int):
        super().__init__()
        self.conv = _conv(ch, ch, 3, cfg)

    def forward(self, x):
        return flax_apply(self.conv, F.interpolate(x, scale_factor=2, mode="nearest"))


class _Stack(nn.Module):
    """conv_in → the named blocks in the order they were added → GroupNorm, SiLU,
    conv_out (NCHW)."""

    def __init__(self):
        super().__init__()
        self._names: list[str] = []

    def _add(self, name: str, module: nn.Module) -> None:
        self.add_module(name, module)
        self._names.append(name)

    def forward(self, x):
        h = flax_apply(self.conv_in, x)
        for name in self._names:
            h = getattr(self, name)(h)
        return flax_apply(self.conv_out, F.silu(self.norm_out(h)))


class Encoder(_Stack):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.conv_in = _conv(cfg.in_channels, cfg.base_channels, 3, cfg)
        ch = cfg.base_channels
        for level, mult in enumerate(cfg.channel_mult):
            out = cfg.base_channels * mult
            for i in range(cfg.num_res_blocks):
                self._add(f"down_{level}_block_{i}", VAEResBlock(cfg, ch, out))
                ch = out
            if level != len(cfg.channel_mult) - 1:
                self._add(f"down_{level}_downsample", Downsample(cfg, ch))
        self._add("mid_block_1", VAEResBlock(cfg, ch, ch))
        self._add("mid_attn_1", VAEAttnBlock(cfg, ch))
        self._add("mid_block_2", VAEResBlock(cfg, ch, ch))
        self.norm_out = GroupNorm(cfg.norm_groups, ch, cfg.dtype)
        self.conv_out = _conv(ch, 2 * cfg.z_channels, 3, cfg)


class Decoder(_Stack):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        ch = cfg.base_channels * cfg.channel_mult[-1]
        self.conv_in = _conv(cfg.z_channels, ch, 3, cfg)
        self._add("mid_block_1", VAEResBlock(cfg, ch, ch))
        self._add("mid_attn_1", VAEAttnBlock(cfg, ch))
        self._add("mid_block_2", VAEResBlock(cfg, ch, ch))
        for level in reversed(range(len(cfg.channel_mult))):
            out = cfg.base_channels * cfg.channel_mult[level]
            for i in range(cfg.num_res_blocks + 1):
                self._add(f"up_{level}_block_{i}", VAEResBlock(cfg, ch, out))
                ch = out
            if level != 0:
                self._add(f"up_{level}_upsample", Upsample(cfg, ch))
        self.norm_out = GroupNorm(cfg.norm_groups, ch, cfg.dtype)
        self.conv_out = _conv(ch, cfg.in_channels, 3, cfg)


def posterior_noise(shape, dtype, device, generator: torch.Generator | None) -> torch.Tensor:
    """The N(0, 1) draw of ``AutoencoderKL.encode``'s posterior sample."""
    return torch.randn(shape, generator=generator, dtype=dtype, device=device)


class AutoencoderKL(nn.Module):
    """Encoder + decoder; every method takes and returns NHWC tensors."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        if cfg.use_quant_conv:
            self.quant_conv = _conv(2 * cfg.z_channels, 2 * cfg.z_channels, 1, cfg)
            self.post_quant_conv = _conv(cfg.z_channels, cfg.z_channels, 1, cfg)

    def moments(self, x):
        """Pixels (B,H,W,3 in [-1,1]) → (mean, logvar) of the latent posterior."""
        h = self.encoder(x.permute(0, 3, 1, 2))
        if self.cfg.use_quant_conv:
            h = flax_apply(self.quant_conv, h)
        mean, logvar = h.permute(0, 2, 3, 1).chunk(2, dim=-1)
        return mean, torch.clamp(logvar, -30.0, 20.0)

    def encode(self, x, rng: torch.Generator | None = None):
        """Pixels → scaled latent. Deterministic (posterior mean) without ``rng``;
        with it, the posterior sample drawn from that generator."""
        mean, logvar = self.moments(x)
        z = mean
        if rng is not None:
            noise = posterior_noise(mean.shape, mean.dtype, mean.device, rng)
            z = mean + torch.exp(0.5 * logvar) * noise
        return (z - self.cfg.shift_factor) * self.cfg.scaling_factor

    def decode(self, z):
        """Scaled latent → pixels (B, f·H, f·W, 3)."""
        h = (z / self.cfg.scaling_factor + self.cfg.shift_factor).permute(0, 3, 1, 2)
        if self.cfg.use_quant_conv:
            h = flax_apply(self.post_quant_conv, h)
        return self.decoder(h).permute(0, 2, 3, 1)

    def forward(self, x, rng: torch.Generator | None = None):
        return self.decode(self.encode(x, rng))


def vae_output_to_images(decoded: torch.Tensor) -> torch.Tensor:
    """Decoder output ([-1, 1] convention) → float images in [0, 1], NHWC."""
    return torch.clamp(decoded * 0.5 + 0.5, 0.0, 1.0)


def images_to_vae_input(images: torch.Tensor) -> torch.Tensor:
    """Float images in [0, 1] → the encoder/decoder [-1, 1] convention."""
    return images * 2.0 - 1.0


def normalize_mask(mask, hw: tuple, method: str = "nearest") -> torch.Tensor:
    """A mask in any of its shapes ((H, W) / (B, H, W) / (B, H, W, 1)) → float
    (B, H, W, 1) at the ``hw`` spatial size."""
    m = torch.as_tensor(mask, dtype=torch.float32)
    if m.ndim == 2:
        m = m[None]
    if m.ndim == 3:
        m = m[..., None]
    if tuple(m.shape[1:3]) != tuple(hw):
        m = resize(m, (m.shape[0], *hw, 1), method=method)
    return m


def encode_maybe_tiled(vae, x, tile: int = 0) -> torch.Tensor:
    """Encode ``x`` through ``vae``, tiled when ``tile > 0``: overlap = tile/4,
    both floored to the VAE's spatial-factor alignment."""
    if tile:
        f = vae.spatial_factor
        tile = max(f, tile // f * f)
        # overlap stays < tile (encode_tiled's contract); a one-cell tile has none.
        overlap = min(max(f, tile // 4 // f * f), tile - f)
        return vae.encode_tiled(x, tile=tile, overlap=max(0, overlap))
    return vae.encode(x)


def decode_maybe_tiled(vae, z, tile: int = 0) -> torch.Tensor:
    """Decode ``z`` through ``vae``, tiled when ``tile > 0`` (overlap = tile/4)."""
    if tile:
        return vae.decode_tiled(z, tile=tile, overlap=tile // 4)
    return vae.decode(z)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


@dataclasses.dataclass
class VAE:
    """The VAE handle: an ``AutoencoderKL`` and its config. Methods take NHWC
    tensors (or numpy arrays), move them to the module's device and run without
    gradients."""

    module: AutoencoderKL
    cfg: VAEConfig

    @property
    def device(self) -> torch.device:
        return self.module.decoder.conv_in.weight.device

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
        """Pixels per latent cell along each spatial dim (8 for the kl-f8 family)."""
        return 2 ** (len(self.cfg.channel_mult) - 1)

    def encode_tiled(self, x, tile: int = 512, overlap: int = 128) -> torch.Tensor:
        """Encode in fixed-size overlapping PIXEL tiles (dims in pixels, multiples
        of the spatial factor), blending the latent overlaps on the host.
        Deterministic (posterior mean) only; returns f32."""
        B, H, W, _ = x.shape
        if H <= tile and W <= tile:
            return self.encode(x)
        f = self.spatial_factor
        if tile % f or overlap % f:
            raise ValueError(f"tile/overlap must be multiples of {f}")
        if not 0 <= overlap < tile:
            raise ValueError(f"need 0 <= overlap < tile, got {overlap=} {tile=}")
        th, tw = min(tile, H), min(tile, W)
        mask = (blend_mask1d(th // f, overlap // f, 1)[:, None]
                * blend_mask1d(tw // f, overlap // f, 1)[None, :])[None, :, :, None]
        out = np.zeros((B, H // f, W // f, self.cfg.z_channels), np.float32)
        weight = np.zeros((1, H // f, W // f, 1), np.float32)
        x_host = _host(x) if torch.is_tensor(x) else np.asarray(x, np.float32)
        # Window starts on the latent grid, scaled back up so edge tiles stay aligned.
        hs_list = [s * f for s in tile_starts(H // f, th // f, (tile - overlap) // f)]
        ws_list = [s * f for s in tile_starts(W // f, tw // f, (tile - overlap) // f)]
        for hs in hs_list:
            for ws in ws_list:
                enc = _host(self.encode(x_host[:, hs : hs + th, ws : ws + tw, :]))
                hl, wl = hs // f, ws // f
                out[:, hl : hl + th // f, wl : wl + tw // f] += enc * mask
                weight[:, hl : hl + th // f, wl : wl + tw // f] += mask
        return torch.from_numpy(out / weight).to(self.device)

    def decode_tiled(self, z, tile: int = 64, overlap: int = 16) -> torch.Tensor:
        """Decode in fixed-size overlapping latent tiles, linearly blending the
        overlaps on the host; edge tiles slide the window back inside the image,
        never pad. Returns f32."""
        B, H, W, C = z.shape
        if H <= tile and W <= tile:
            return self.decode(z)
        if not 0 <= overlap < tile:
            raise ValueError(f"need 0 <= overlap < tile, got {overlap=} {tile=}")
        f = self.spatial_factor
        stride = tile - overlap
        z = self._in(z)
        th, tw = min(tile, H), min(tile, W)
        mask = (blend_mask1d(th, overlap, f)[:, None]
                * blend_mask1d(tw, overlap, f)[None, :])[None, :, :, None]
        out = np.zeros((B, H * f, W * f, self.cfg.in_channels), np.float32)
        weight = np.zeros((1, H * f, W * f, 1), np.float32)
        for hs in tile_starts(H, th, stride):
            for ws in tile_starts(W, tw, stride):
                dec = _host(self.decode(z[:, hs : hs + th, ws : ws + tw, :]))
                out[:, hs * f : (hs + th) * f, ws * f : (ws + tw) * f] += dec * mask
                weight[:, hs * f : (hs + th) * f, ws * f : (ws + tw) * f] += mask
        return torch.from_numpy(out / weight).to(self.device)


def build_vae(cfg: VAEConfig, *, device=None, generator: torch.Generator | None = None,
              state_dict: dict | None = None) -> VAE:
    """A VAE on ``device`` (default ``cuda:0``), from ``state_dict``
    (``convert_vae`` or ``convert_jax``) or random weights from ``generator``."""
    device = torch.device(device) if device is not None else default_device()
    if state_dict is None and generator is None:
        raise ValueError("need a generator to initialise (or pass state_dict=)")
    with torch.device("meta"):
        module = AutoencoderKL(cfg)
    module = module.to_empty(device=device).eval()
    with torch.no_grad():
        if state_dict is not None:
            module.load_state_dict(state_dict)
        else:
            init_random_(module, generator)
    return VAE(module=module, cfg=cfg)
