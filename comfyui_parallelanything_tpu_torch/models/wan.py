"""Wan-class video DiT in PyTorch (counterpart of ``comfyui_parallelanything_tpu/models/wan.py``).

Architecture (public Wan2.x recipe): a video latent (B, T, H, W, C) patchified
(1×2×2) into space-time tokens; sinusoidal timestep → MLP → 6-way adaLN
modulation; ``depth`` identical blocks of [modulated self-attention over every
space-time token with 3-axis (t, h, w) RoPE and q/k RMSNorm] → [cross-attention to
the text context, plus a second attention over CLIP-vision tokens in the
Wan2.1-style i2v checkpoints] → [modulated GELU FFN]; a modulated head projecting
back to patches.

Numerics follow the JAX module: linears compute in ``cfg.dtype`` (weights stored
in it); the time MLP, the modulation and the head in f32. The q/k RMSNorm runs in
f32 over the full H·D width before the head split (eps 1e-6); the affine-free
LayerNorms (norm1, norm2, the head's) at eps 1e-6 in f32; the affine ``norm3`` at
eps 1e-6 and the image-embedding LayerNorms at eps 1e-5. GELU is the tanh form.
Every attention call goes through ``ops.attention.attention``: on a CUDA tensor
that is the flash-attention kernel K1 (its ``sm90`` variant at head dim 128).
Submodule names follow the flax parameter tree (``blocks.0.self_q``,
``blocks.0.modulation``, ``head_modulation.bias``), so
``convert_jax.from_jax_wan_params`` is a rename plus transposes.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..devices.discovery import default_device
from ..ops import basic
from ..ops.attention import attention
from ..ops.basic import LayerNorm, modulate, rms_normalize, timestep_embedding
from ..ops.rope import apply_rope, axis_rope_freqs
from ..utils.logging import get_logger
from .api import DiffusionModel, PipelineSegment, PipelineSpec


@dataclasses.dataclass(frozen=True)
class WanConfig:
    in_channels: int = 16
    out_channels: int = 16
    hidden_size: int = 1536
    ffn_dim: int = 8960
    num_heads: int = 12
    depth: int = 30
    text_dim: int = 4096       # umt5-xxl features
    freq_dim: int = 256        # sinusoidal timestep embedding width
    patch_size: tuple[int, int, int] = (1, 2, 2)  # (t, h, w)
    qk_norm_eps: float = 1e-6
    theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16
    # Rectified-flow velocity parameterization: routes the KSampler node's
    # k-sampler menu through flow-time sampling.
    prediction: str = "flow"
    # CLIP-vision context width (Wan2.1-style i2v checkpoints: the img_emb MLP
    # projects ViT-H penultimate states (B, 257, 1280) into extra cross-attention
    # context). None = no image branch (t2v, and Wan2.2 i2v).
    img_dim: int | None = None

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def axes_dim(self) -> tuple[int, int, int]:
        """Per-axis RoPE dims over (t, h, w), summing to head_dim: the temporal axis
        takes the remainder after h/w get 2·(d//6) each (the public Wan split)."""
        d = self.head_dim
        hw = 2 * (d // 6)
        return (d - 2 * hw, hw, hw)


def wan_1_3b_config(**overrides) -> WanConfig:
    return dataclasses.replace(WanConfig(), **overrides)


def wan_14b_config(**overrides) -> WanConfig:
    base = WanConfig(hidden_size=5120, ffn_dim=13824, num_heads=40, depth=40)
    return dataclasses.replace(base, **overrides)


def wan_14b_i2v_config(**overrides) -> WanConfig:
    """The i2v variant: 36 in-channels = noisy latent 16 + frame mask 4 + encoded
    image cond latent 16 (Wan2.2 channel-concat conditioning, no CLIP branch)."""
    return wan_14b_config(in_channels=36, **overrides)


def wan_14b_i2v_clip_config(**overrides) -> WanConfig:
    """The Wan2.1-style i2v variant: channel-concat conditioning (36 in-channels)
    plus the CLIP-vision branch (``img_emb`` and per-block ``k_img``/``v_img``
    over 257 extra context tokens)."""
    return wan_14b_config(in_channels=36, img_dim=1280, **overrides)


def _layer_norm(x: torch.Tensor) -> torch.Tensor:
    """LayerNorm without scale or bias, eps 1e-6, computed in f32, in x's dtype."""
    return F.layer_norm(x.float(), (x.shape[-1],), eps=1e-6).to(x.dtype)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


class _RMSNorm(nn.Module):
    """RMSNorm in f32 with a learned f32 scale over the last dim."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return rms_normalize(x, self.weight, self.eps)


class _HeadModulation(nn.Module):
    """Learned (1, 2, D) f32 bias + time vector → the head's shift/scale."""

    def __init__(self, hidden: int):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(1, 2, hidden))

    def forward(self, vec):
        return self.bias + vec[:, None, :]


class WanBlock(nn.Module):
    """Modulated self-attention (3-axis RoPE) → cross-attention (text, and CLIP
    image tokens where the config has ``img_dim``) → modulated FFN."""

    def __init__(self, cfg: WanConfig):
        super().__init__()
        self.cfg = cfg
        hidden, inner, dt = cfg.hidden_size, cfg.num_heads * cfg.head_dim, cfg.dtype
        # Learned per-block modulation bias added to the shared time modulation (f32).
        self.modulation = nn.Parameter(torch.zeros(1, 6, hidden))
        for p in ("self", "cross"):
            for proj in "qkv":
                setattr(self, f"{p}_{proj}", nn.Linear(hidden, inner, dtype=dt))
            setattr(self, f"{p}_o", nn.Linear(inner, hidden, dtype=dt))
            setattr(self, f"{p}_q_norm", _RMSNorm(inner, cfg.qk_norm_eps))
            setattr(self, f"{p}_k_norm", _RMSNorm(inner, cfg.qk_norm_eps))
        self.norm3 = LayerNorm(hidden, eps=1e-6, out_dtype=dt)
        if cfg.img_dim is not None:
            self.cross_k_img = nn.Linear(hidden, inner, dtype=dt)
            self.cross_v_img = nn.Linear(hidden, inner, dtype=dt)
            self.cross_k_img_norm = _RMSNorm(inner, cfg.qk_norm_eps)
        self.ffn_in = nn.Linear(hidden, cfg.ffn_dim, dtype=dt)
        self.ffn_out = nn.Linear(cfg.ffn_dim, hidden, dtype=dt)

    def forward(self, x, context, e, rope, context_img=None):
        """x: (B, S, D) space-time tokens; context: (B, L, D) projected text; e:
        (B, 6, D) f32 modulation; rope: (cos, sin); context_img: optional
        (B, Li, D) projected CLIP-vision tokens, attended by the k_img/v_img heads
        with the same queries and summed with the text attention before the output
        projection."""
        cfg = self.cfg
        H, D = cfg.num_heads, cfg.head_dim
        e = (e + self.modulation).float()
        shift1, scale1, gate1, shift2, scale2, gate2 = (e[:, i][:, None, :] for i in range(6))
        B, S, _ = x.shape

        # Self-attention; q/k RMSNorm over the full H·D width before the head split.
        h = modulate(_layer_norm(x), shift1, scale1)
        q = self.self_q_norm(self.self_q(h)).reshape(B, S, H, D)
        k = self.self_k_norm(self.self_k(h)).reshape(B, S, H, D)
        v = self.self_v(h).reshape(B, S, H, D)
        cos, sin = rope
        attn = attention(apply_rope(q, cos, sin), apply_rope(k, cos, sin), v)
        x = x + gate1.to(cfg.dtype) * self.self_o(attn.reshape(B, S, -1))

        # Cross-attention to the text (no rope, no gate; affine pre-norm).
        L = context.shape[1]
        h = self.norm3(x)
        q = self.cross_q_norm(self.cross_q(h)).reshape(B, S, H, D)
        k = self.cross_k_norm(self.cross_k(context)).reshape(B, L, H, D)
        v = self.cross_v(context).reshape(B, L, H, D)
        attn = attention(q, k, v)
        if context_img is not None:
            Li = context_img.shape[1]
            k_i = self.cross_k_img_norm(self.cross_k_img(context_img)).reshape(B, Li, H, D)
            v_i = self.cross_v_img(context_img).reshape(B, Li, H, D)
            attn = attn + attention(q, k_i, v_i)
        x = x + self.cross_o(attn.reshape(B, S, -1))

        # FFN.
        h = modulate(_layer_norm(x), shift2, scale2)
        h = self.ffn_out(_gelu(self.ffn_in(h)))
        return x + gate2.to(cfg.dtype) * h


class WanModel(nn.Module):
    """forward(x video latent (B, T, H, W, C), timesteps (B,), context (B, L,
    text_dim), clip_fea=(B, 257, img_dim) optional) -> (B, T, H, W, out_channels)
    velocity (f32).

    The forward decomposes into ``prepare`` / ``block_step`` / ``finalize``; the
    carry between stages is a flat dict of tensors: x, context, e, vec, rope_cos,
    rope_sin and, with image tokens, context_img.
    """

    def __init__(self, cfg: WanConfig):
        super().__init__()
        self.cfg = cfg
        hidden, dt = cfg.hidden_size, cfg.dtype
        pt, ph, pw = cfg.patch_size
        self.patch_embedding = nn.Linear(pt * ph * pw * cfg.in_channels, hidden, dtype=dt)
        self.text_in = nn.Linear(cfg.text_dim, hidden, dtype=dt)
        self.text_hidden = nn.Linear(hidden, hidden, dtype=dt)
        self.time_in = nn.Linear(cfg.freq_dim, hidden, dtype=torch.float32)
        self.time_hidden = nn.Linear(hidden, hidden, dtype=torch.float32)
        self.time_projection = nn.Linear(hidden, 6 * hidden, dtype=torch.float32)
        self.blocks = nn.ModuleList(WanBlock(cfg) for _ in range(cfg.depth))
        if cfg.img_dim is not None:
            # The public i2v img_emb MLPProj: LN(img_dim) → Linear → GELU → Linear → LN.
            self.img_ln_in = LayerNorm(cfg.img_dim, eps=1e-5)
            self.img_in = nn.Linear(cfg.img_dim, hidden, dtype=dt)
            self.img_hidden = nn.Linear(hidden, hidden, dtype=dt)
            self.img_ln_out = LayerNorm(hidden, eps=1e-5)
        self.head_modulation = _HeadModulation(hidden)
        self.head_proj = nn.Linear(hidden, pt * ph * pw * cfg.out_channels, dtype=torch.float32)

    def prepare(self, x, timesteps, context=None, clip_fea=None, **kwargs):
        """Patch, text, time and image embeddings + RoPE tables → the stage carry."""
        cfg = self.cfg
        B, T, Hh, Ww, C = x.shape
        pt, ph, pw = cfg.patch_size
        tp, hp, wp = T // pt, Hh // ph, Ww // pw
        # (1, 2, 2) patchify → (B, tp·hp·wp, pt·ph·pw·C) in (pt, ph, pw, C) order.
        tok = x.to(cfg.dtype).reshape(B, tp, pt, hp, ph, wp, pw, C)
        tok = tok.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(B, tp * hp * wp, pt * ph * pw * C)
        tok = self.patch_embedding(tok)

        if context is None:
            raise ValueError("Wan requires text context tokens")
        ctx = self.text_hidden(_gelu(self.text_in(context.to(cfg.dtype))))

        vec = self.time_hidden(F.silu(self.time_in(
            timestep_embedding(timesteps, cfg.freq_dim, time_factor=1000.0))))
        e = self.time_projection(F.silu(vec)).reshape(B, 6, cfg.hidden_size)

        # 3-axis (t, h, w) position ids for RoPE.
        grid = torch.stack(torch.meshgrid(
            *(torch.arange(n, dtype=torch.int32, device=x.device) for n in (tp, hp, wp)),
            indexing="ij"), dim=-1).reshape(1, tp * hp * wp, 3)
        cos, sin = axis_rope_freqs(grid.expand(B, -1, -1), cfg.axes_dim, cfg.theta)
        carry = {"x": tok, "context": ctx, "e": e, "vec": vec.float(),
                 "rope_cos": cos, "rope_sin": sin}
        if clip_fea is not None:
            if cfg.img_dim is None:
                raise ValueError(
                    "clip_fea passed but this Wan config has no CLIP-vision branch "
                    "(img_dim=None) — load a Wan2.1-style i2v checkpoint "
                    "(wan_14b_i2v_clip_config)")
            ci = self.img_ln_in(clip_fea.float())
            ci = self.img_hidden(_gelu(self.img_in(ci.to(cfg.dtype))))
            carry["context_img"] = self.img_ln_out(ci).to(cfg.dtype)
        return carry

    def block_step(self, carry, i: int):
        x = self.blocks[i](carry["x"], carry["context"], carry["e"],
                           (carry["rope_cos"], carry["rope_sin"]),
                           context_img=carry.get("context_img"))
        return {**carry, "x": x}

    def finalize(self, carry, out_shape: tuple[int, ...]):
        """The modulated head back to (B, T, H, W, out_channels) patches, f32."""
        cfg = self.cfg
        B, T, Hh, Ww, _ = out_shape
        pt, ph, pw = cfg.patch_size
        tp, hp, wp = T // pt, Hh // ph, Ww // pw
        mod = self.head_modulation(carry["vec"])
        shift, scale = mod[:, 0][:, None, :], mod[:, 1][:, None, :]
        x = self.head_proj(modulate(_layer_norm(carry["x"]), shift, scale).float())
        x = x.reshape(B, tp, hp, wp, pt, ph, pw, cfg.out_channels)
        x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
        return x.reshape(B, T, Hh, Ww, cfg.out_channels)

    def forward(self, x, timesteps, context=None, clip_fea=None, **kwargs):
        carry = self.prepare(x, timesteps, context, clip_fea=clip_fea)
        for i in range(self.cfg.depth):
            carry = self.block_step(carry, i)
        return self.finalize(carry, tuple(x.shape))


def _wan_pipeline_spec(cfg: WanConfig) -> PipelineSpec:
    """Stage decomposition: embeddings on the lead device, one segment per block,
    the head on the lead."""

    def make_block(i):
        return lambda module, carry: module.block_step(carry, i)

    prepare_keys = ("patch_embedding", "text_in", "text_hidden",
                    "time_in", "time_hidden", "time_projection")
    if cfg.img_dim is not None:
        prepare_keys += ("img_ln_in", "img_in", "img_hidden", "img_ln_out")
    return PipelineSpec(
        prepare_keys=prepare_keys,
        prepare=lambda module, x, t, context=None, clip_fea=None, **kw: module.prepare(
            x, t, context, clip_fea=clip_fea),
        segments=tuple(PipelineSegment((f"blocks.{i}",), make_block(i), f"blocks[{i}]")
                       for i in range(cfg.depth)),
        finalize_keys=("head_modulation", "head_proj"),
        finalize=lambda module, carry, out_shape: module.finalize(carry, out_shape),
    )


class I2VConditioned(nn.Module):
    """A Wan DiT with its image-to-video conditioning as buffers: every forward's
    input becomes ``concat([x, cond], channel)`` (or zeros in the concat slots when
    no ``cond`` was given to an i2v checkpoint), and ``clip_fea`` rides the call.
    CFG's doubled batch tiles both."""

    def __init__(self, base: nn.Module, cond: torch.Tensor | None,
                 clip_fea: torch.Tensor | None, fill_channels: int | None):
        super().__init__()
        self.base = base
        self.fill_channels = fill_channels
        self.register_buffer("cond", cond)
        self.register_buffer("clip_fea", clip_fea)

    @staticmethod
    def _tile_to(a: torch.Tensor, batch: int) -> torch.Tensor:
        if a.shape[0] != batch:
            if batch % a.shape[0]:
                raise ValueError(f"i2v conditioning batch {a.shape[0]} does not divide "
                                 f"model batch {batch}")
            a = a.repeat(batch // a.shape[0], *([1] * (a.ndim - 1)))
        return a

    def forward(self, x, timesteps, context=None, **kwargs):
        x_in = x
        if self.cond is not None:
            x_in = torch.cat([x, self._tile_to(self.cond, x.shape[0]).to(x.dtype)], dim=-1)
        elif self.fill_channels:
            # No start-image cond on an i2v checkpoint: zero-fill the concat slots.
            x_in = torch.cat([x, x.new_zeros((*x.shape[:-1], self.fill_channels))], dim=-1)
        if self.clip_fea is not None:
            kwargs = {**kwargs, "clip_fea": self._tile_to(self.clip_fea, x.shape[0])}
        return self.base(x_in, timesteps, context, **kwargs)


def apply_i2v_conditioning(base: DiffusionModel, cond=None, clip_fea=None) -> DiffusionModel:
    """Compose Wan i2v conditioning into a ``DiffusionModel``: every denoise step's
    input becomes ``concat([x, cond], channel)`` (``cond`` = 4-channel frame mask ‖
    encoded start-frames latent) and, when ``clip_fea`` is given (Wan2.1-style
    checkpoints with the img_emb branch), the CLIP-vision penultimate states ride
    the call. The tensors ride the module as buffers, so the composition places
    through ``parallelize`` like a single model.

    Config-aware, as the host's concat_cond: on a t2v model (in_channels ==
    out_channels) the tag is ignored with a warning; on an i2v model without a
    ``cond`` the missing channels zero-fill; a ``cond`` of the wrong width raises;
    ``clip_fea`` on a model without the CLIP branch is dropped with a warning."""
    cfg = base.config
    expected = None
    in_ch = getattr(cfg, "in_channels", None)
    out_ch = getattr(cfg, "out_channels", None)
    if in_ch is not None and out_ch is not None:
        expected = in_ch - out_ch  # extra channels the checkpoint consumes
        if expected <= 0:
            if cond is not None or clip_fea is not None:
                get_logger().warning(
                    f"i2v conditioning on a t2v checkpoint (in_channels == {in_ch}, no "
                    "concat slots) — ignored, sampling proceeds unconditioned (stock "
                    "concat_cond semantics)")
            return base
        if cond is not None and cond.shape[-1] != expected:
            raise ValueError(
                f"i2v cond carries {cond.shape[-1]} channels but the checkpoint "
                f"concatenates {expected} (in {in_ch} − latent {out_ch}) — the "
                "WanImageToVideo VAE does not match this model")
    if clip_fea is not None and getattr(cfg, "img_dim", None) is None:
        get_logger().warning(
            "clip_vision_output on a Wan checkpoint without the CLIP-vision branch (no "
            "img_emb weights; Wan2.2-style) — image embeds ignored, channel-concat "
            "conditioning still applies")
        clip_fea = None
    device = next(base.module.parameters()).device

    def buffer(a):
        return None if a is None else torch.as_tensor(a, dtype=torch.float32).to(device)

    module = I2VConditioned(base.module, buffer(cond), buffer(clip_fea),
                            expected if cond is None else None)
    return DiffusionModel(module=module, name=f"{base.name}+i2v", config=base.config)


@torch.no_grad()
def init_random_(module: nn.Module, generator: torch.Generator) -> None:
    """Random weights from ``generator``, in place: every linear N(0, 1/fan_in) with
    zero bias and every LayerNorm at one and zero (``ops.basic.init_random_``), the
    RMSNorm scales one, the modulation biases N(0, 0.02) as flax initialises them."""
    basic.init_random_(module, generator)
    for m in module.modules():
        if isinstance(m, _RMSNorm):
            m.weight.fill_(1.0)
        elif isinstance(m, WanBlock):
            m.modulation.normal_(0.0, 0.02, generator=generator)
        elif isinstance(m, _HeadModulation):
            m.bias.normal_(0.0, 0.02, generator=generator)


def build_wan(
    cfg: WanConfig,
    *,
    device=None,
    generator: torch.Generator | None = None,
    state_dict: dict | None = None,
    name: str = "wan",
) -> DiffusionModel:
    """Build a Wan ``DiffusionModel`` on ``device`` (default ``cuda:0``), from
    ``state_dict`` (``convert_wan.convert_wan_checkpoint`` or
    ``convert_jax.from_jax_wan_params``) or random weights from ``generator``. The
    module is created without memory and materialised on the device in
    ``cfg.dtype``."""
    device = torch.device(device) if device is not None else default_device()
    if state_dict is None and generator is None:
        raise ValueError("need a generator to initialise (or pass state_dict=)")
    with torch.device("meta"):
        module = WanModel(cfg)
    module = module.to_empty(device=device).eval()
    if state_dict is not None:
        module.load_state_dict(state_dict)
    else:
        init_random_(module, generator)
    return DiffusionModel(
        module=module,
        name=name,
        config=cfg,
        block_lists={"blocks": cfg.depth},
        pipeline_spec=_wan_pipeline_spec(cfg),
    )
