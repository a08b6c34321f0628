"""FLUX-class MMDiT in PyTorch (counterpart of ``comfyui_parallelanything_tpu/models/flux.py``).

Architecture (public FLUX.1 recipe): NHWC latent 2×2-patchified to 64-channel
tokens; text tokens projected from T5 features; (timestep, pooled vector,
guidance) → modulation vector; ``depth`` double-stream blocks (separate img/txt
weights, joint attention over [txt ‖ img]); ``depth_single_blocks`` fused-stream
blocks; adaLN-modulated final projection back to NHWC.

Numerics follow the JAX module: linears compute in ``cfg.dtype`` (weights stored
in it), modulation and the final projection in f32 (weights stored in f32),
LayerNorm without scale or bias at eps 1e-6 computed in f32, GELU with the tanh
approximation, RoPE on interleaved pairs. Submodule names follow the flax
parameter tree, so ``convert_jax.from_jax_params`` is a rename plus transposes.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..devices.discovery import default_device
from ..ops.attention import attention
from ..ops import basic
from ..ops.basic import modulate, rms_normalize, timestep_embedding
from ..ops.rope import apply_rope, axis_rope_freqs
from .api import DiffusionModel, PipelineSegment, PipelineSpec


@dataclasses.dataclass(frozen=True)
class FluxConfig:
    in_channels: int = 64          # 16 latent ch × 2×2 patch
    hidden_size: int = 3072
    num_heads: int = 24            # head_dim 128
    depth: int = 19                # double blocks
    depth_single_blocks: int = 38
    mlp_ratio: float = 4.0
    context_in_dim: int = 4096     # T5 features
    vec_in_dim: int = 768          # pooled CLIP
    axes_dim: tuple[int, ...] = (16, 56, 56)
    theta: float = 10000.0
    guidance_embed: bool = True
    patch_size: int = 2
    dtype: torch.dtype = torch.bfloat16
    prediction: str = "flow"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def flux_dev_config(**overrides) -> FluxConfig:
    return dataclasses.replace(FluxConfig(), **overrides)


def flux_schnell_config(**overrides) -> FluxConfig:
    return dataclasses.replace(FluxConfig(guidance_embed=False), **overrides)


def z_image_turbo_config(**overrides) -> FluxConfig:
    """Z_Image-class turbo DiT: a few double blocks feeding a deep single-block
    stack at FLUX's width, no guidance embed."""
    base = FluxConfig(depth=6, depth_single_blocks=26, guidance_embed=False)
    return dataclasses.replace(base, **overrides)


def _layer_norm(x: torch.Tensor) -> torch.Tensor:
    """LayerNorm without scale or bias, eps 1e-6, computed in f32, in x's dtype."""
    return F.layer_norm(x.float(), (x.shape[-1],), eps=1e-6).to(x.dtype)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


class MLPEmbedder(nn.Module):
    def __init__(self, in_dim: int, cfg: FluxConfig):
        super().__init__()
        self.in_layer = nn.Linear(in_dim, cfg.hidden_size, dtype=cfg.dtype)
        self.out_layer = nn.Linear(cfg.hidden_size, cfg.hidden_size, dtype=cfg.dtype)

    def forward(self, x):
        return self.out_layer(F.silu(self.in_layer(x)))


class Modulation(nn.Module):
    """vec → (shift, scale, gate) × n sets, computed in f32."""

    def __init__(self, cfg: FluxConfig, n_sets: int):
        super().__init__()
        self.n = 3 * n_sets
        self.lin = nn.Linear(cfg.hidden_size, self.n * cfg.hidden_size, dtype=torch.float32)

    def forward(self, vec):
        return self.lin(F.silu(vec.float()))[:, None, :].chunk(self.n, dim=-1)


class QKNorm(nn.Module):
    """Per-head RMSNorm on q and k (f32 scales)."""

    def __init__(self, head_dim: int):
        super().__init__()
        self.query_norm = nn.Parameter(torch.ones(head_dim))
        self.key_norm = nn.Parameter(torch.ones(head_dim))

    def forward(self, q, k):
        return rms_normalize(q, self.query_norm), rms_normalize(k, self.key_norm)


def _split_qkv(h: torch.Tensor, heads: int, head_dim: int):
    h = h.reshape(h.shape[0], h.shape[1], 3, heads, head_dim)
    return h[:, :, 0], h[:, :, 1], h[:, :, 2]


class DoubleBlock(nn.Module):
    """Separate img/txt streams; one joint attention over [txt ‖ img] tokens."""

    def __init__(self, cfg: FluxConfig):
        super().__init__()
        self.cfg = cfg
        hidden, dt = cfg.hidden_size, cfg.dtype
        mlp_dim = int(hidden * cfg.mlp_ratio)
        for s in ("img", "txt"):
            setattr(self, f"{s}_mod", Modulation(cfg, 2))
            setattr(self, f"{s}_attn_qkv", nn.Linear(hidden, 3 * hidden, dtype=dt))
            # int8 scales shared over q/k/v and heads, as the reference's
            getattr(self, f"{s}_attn_qkv").int8_row_groups = 3 * cfg.num_heads
            setattr(self, f"{s}_attn_norm", QKNorm(cfg.head_dim))
            setattr(self, f"{s}_attn_proj", nn.Linear(hidden, hidden, dtype=dt))
            setattr(self, f"{s}_mlp_in", nn.Linear(hidden, mlp_dim, dtype=dt))
            setattr(self, f"{s}_mlp_out", nn.Linear(mlp_dim, hidden, dtype=dt))

    def forward(self, img, txt, vec, rope):
        cfg = self.cfg
        H, D = cfg.num_heads, cfg.head_dim
        im_shift1, im_scale1, im_gate1, im_shift2, im_scale2, im_gate2 = self.img_mod(vec)
        tx_shift1, tx_scale1, tx_gate1, tx_shift2, tx_scale2, tx_gate2 = self.txt_mod(vec)

        iq, ik, iv = _split_qkv(self.img_attn_qkv(modulate(_layer_norm(img), im_shift1, im_scale1)), H, D)
        iq, ik = self.img_attn_norm(iq, ik)
        tq, tk, tv = _split_qkv(self.txt_attn_qkv(modulate(_layer_norm(txt), tx_shift1, tx_scale1)), H, D)
        tq, tk = self.txt_attn_norm(tq, tk)

        cos, sin = rope
        q = apply_rope(torch.cat([tq, iq], dim=1), cos, sin)
        k = apply_rope(torch.cat([tk, ik], dim=1), cos, sin)
        v = torch.cat([tv, iv], dim=1)
        attn = attention(q, k, v)
        attn = attn.reshape(attn.shape[0], attn.shape[1], -1)
        txt_len = txt.shape[1]
        txt_attn, img_attn = attn[:, :txt_len], attn[:, txt_len:]

        img = img + im_gate1.to(cfg.dtype) * self.img_attn_proj(img_attn)
        txt = txt + tx_gate1.to(cfg.dtype) * self.txt_attn_proj(txt_attn)
        img_m = modulate(_layer_norm(img), im_shift2, im_scale2)
        txt_m = modulate(_layer_norm(txt), tx_shift2, tx_scale2)
        img = img + im_gate2.to(cfg.dtype) * self.img_mlp_out(_gelu(self.img_mlp_in(img_m)))
        txt = txt + tx_gate2.to(cfg.dtype) * self.txt_mlp_out(_gelu(self.txt_mlp_in(txt_m)))
        return img, txt


class SingleBlock(nn.Module):
    """Fused stream: one linear makes qkv + mlp_in together, one linear closes."""

    def __init__(self, cfg: FluxConfig):
        super().__init__()
        self.cfg = cfg
        hidden, dt = cfg.hidden_size, cfg.dtype
        mlp_dim = int(hidden * cfg.mlp_ratio)
        self.modulation = Modulation(cfg, 1)
        self.linear1 = nn.Linear(hidden, 3 * hidden + mlp_dim, dtype=dt)
        self.norm = QKNorm(cfg.head_dim)
        self.linear2 = nn.Linear(hidden + mlp_dim, hidden, dtype=dt)

    def forward(self, x, vec, rope):
        cfg = self.cfg
        shift, scale, gate = self.modulation(vec)
        fused = self.linear1(modulate(_layer_norm(x), shift, scale))
        qkv, mlp = fused[..., : 3 * cfg.hidden_size], fused[..., 3 * cfg.hidden_size :]
        q, k, v = _split_qkv(qkv, cfg.num_heads, cfg.head_dim)
        q, k = self.norm(q, k)
        cos, sin = rope
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        attn = attention(q, k, v).reshape(x.shape[0], x.shape[1], -1)
        out = self.linear2(torch.cat([attn, _gelu(mlp)], dim=-1))
        return x + gate.to(cfg.dtype) * out


class FluxModel(nn.Module):
    """forward(x latent NHWC, timesteps (B,), context (B,S,ctx_dim),
    y=(B,vec_dim) pooled vector, guidance=(B,) optional) -> NHWC velocity (f32).

    The forward decomposes into ``prepare`` / ``double_step`` / ``single_step`` /
    ``finalize``; the carry between stages is a flat dict of tensors: img, txt,
    vec, rope_cos, rope_sin.
    """

    def __init__(self, cfg: FluxConfig):
        super().__init__()
        self.cfg = cfg
        hidden, dt = cfg.hidden_size, cfg.dtype
        self.img_in = nn.Linear(cfg.in_channels, hidden, dtype=dt)
        self.txt_in = nn.Linear(cfg.context_in_dim, hidden, dtype=dt)
        self.time_in = MLPEmbedder(256, cfg)
        if cfg.guidance_embed:
            self.guidance_in = MLPEmbedder(256, cfg)
        self.vector_in = MLPEmbedder(cfg.vec_in_dim, cfg)
        self.double_blocks = nn.ModuleList(DoubleBlock(cfg) for _ in range(cfg.depth))
        self.single_blocks = nn.ModuleList(SingleBlock(cfg) for _ in range(cfg.depth_single_blocks))
        self.final_mod = nn.Linear(hidden, 2 * hidden, dtype=torch.float32)
        self.final_proj = nn.Linear(hidden, cfg.in_channels, dtype=torch.float32)

    def prepare(self, x, timesteps, context=None, y=None, guidance=None, **kwargs):
        """Embeddings + position tables → the stage carry."""
        cfg = self.cfg
        B, Hh, Ww, C = x.shape
        p = cfg.patch_size
        hp, wp = Hh // p, Ww // p
        img = x.to(cfg.dtype).reshape(B, hp, p, wp, p, C)
        img = self.img_in(img.permute(0, 1, 3, 2, 4, 5).reshape(B, hp * wp, p * p * C))

        if context is None:
            raise ValueError("FLUX requires text context tokens")
        txt = self.txt_in(context.to(cfg.dtype))

        vec = self.time_in(timestep_embedding(timesteps, 256, time_factor=1000.0).to(cfg.dtype))
        if cfg.guidance_embed:
            if guidance is None:
                guidance = torch.full((B,), 4.0, dtype=torch.float32, device=x.device)
            vec = vec + self.guidance_in(
                timestep_embedding(guidance, 256, time_factor=1000.0).to(cfg.dtype)
            )
        if y is None:
            y = torch.zeros((B, cfg.vec_in_dim), dtype=torch.float32, device=x.device)
        vec = vec + self.vector_in(y.to(cfg.dtype))

        # Position ids: txt tokens all zero, img tokens (0, h, w) on the patch grid.
        txt_ids = torch.zeros((B, txt.shape[1], 3), dtype=torch.int32, device=x.device)
        hh, ww = torch.meshgrid(
            torch.arange(hp, dtype=torch.int32, device=x.device),
            torch.arange(wp, dtype=torch.int32, device=x.device),
            indexing="ij",
        )
        grid = torch.stack([torch.zeros_like(hh), hh, ww], dim=-1).reshape(1, hp * wp, 3)
        ids = torch.cat([txt_ids, grid.expand(B, -1, -1)], dim=1)
        cos, sin = axis_rope_freqs(ids, cfg.axes_dim, cfg.theta)
        return {"img": img, "txt": txt, "vec": vec, "rope_cos": cos, "rope_sin": sin}

    def double_step(self, carry, i: int):
        img, txt = self.double_blocks[i](
            carry["img"], carry["txt"], carry["vec"], (carry["rope_cos"], carry["rope_sin"])
        )
        return {**carry, "img": img, "txt": txt}

    def single_step(self, carry, i: int):
        txt_len = carry["txt"].shape[1]
        x = torch.cat([carry["txt"], carry["img"]], dim=1)
        x = self.single_blocks[i](x, carry["vec"], (carry["rope_cos"], carry["rope_sin"]))
        return {**carry, "txt": x[:, :txt_len], "img": x[:, txt_len:]}

    def finalize(self, carry, out_shape: tuple[int, ...]):
        """Final adaLN + projection back to NHWC patches (f32)."""
        cfg = self.cfg
        img, vec = carry["img"], carry["vec"]
        B, Hh, Ww, C = out_shape
        p = cfg.patch_size
        hp, wp = Hh // p, Ww // p
        shift, scale = self.final_mod(F.silu(vec.float()))[:, None, :].chunk(2, dim=-1)
        img = self.final_proj(modulate(_layer_norm(img), shift, scale).float())
        img = img.reshape(B, hp, wp, p, p, C).permute(0, 1, 3, 2, 4, 5)
        return img.reshape(B, Hh, Ww, C)

    def forward(self, x, timesteps, context=None, y=None, guidance=None, **kwargs):
        carry = self.prepare(x, timesteps, context, y=y, guidance=guidance)
        for i in range(self.cfg.depth):
            carry = self.double_step(carry, i)
        for i in range(self.cfg.depth_single_blocks):
            carry = self.single_step(carry, i)
        return self.finalize(carry, tuple(x.shape))


def _flux_pipeline_spec(cfg: FluxConfig) -> PipelineSpec:
    """Stage decomposition in the reference's block-list walk order: embeddings on
    the lead device, one segment per block, final projection on the lead."""

    def make_double(i):
        return lambda module, carry: module.double_step(carry, i)

    def make_single(i):
        return lambda module, carry: module.single_step(carry, i)

    segments = tuple(
        PipelineSegment((f"double_blocks.{i}",), make_double(i), f"double_blocks[{i}]")
        for i in range(cfg.depth)
    ) + tuple(
        PipelineSegment((f"single_blocks.{i}",), make_single(i), f"single_blocks[{i}]")
        for i in range(cfg.depth_single_blocks)
    )
    prepare_keys = ["img_in", "txt_in", "time_in", "vector_in"]
    if cfg.guidance_embed:
        prepare_keys.append("guidance_in")
    return PipelineSpec(
        prepare_keys=tuple(prepare_keys),
        prepare=lambda module, x, t, context=None, **kw: module.prepare(x, t, context, **kw),
        segments=segments,
        finalize_keys=("final_mod", "final_proj"),
        finalize=lambda module, carry, out_shape: module.finalize(carry, out_shape),
    )


@torch.no_grad()
def init_random_(module: nn.Module, generator: torch.Generator) -> None:
    """Random weights from ``generator``, in place: every linear N(0, 1/fan_in)
    with zero bias (``ops.basic.init_random_``), every QKNorm scale one."""
    basic.init_random_(module, generator)
    for m in module.modules():
        if isinstance(m, QKNorm):
            m.query_norm.fill_(1.0)
            m.key_norm.fill_(1.0)


def build_flux(
    cfg: FluxConfig,
    *,
    device=None,
    generator: torch.Generator | None = None,
    state_dict: dict | None = None,
    name: str = "flux",
    assign: bool = False,
) -> DiffusionModel:
    """Build a FLUX DiffusionModel on ``device`` (default ``cuda:0``).

    Weights come from ``state_dict`` (e.g. ``convert_jax.from_jax_params``) or,
    without one, from ``init_random_`` with ``generator``. The module is created
    without memory and then materialised on the device, so no host copy of the
    weights is ever made. ``assign=True`` takes the state dict's tensors as the
    parameters instead of copying them (``convert.convert_flux_checkpoint`` gives
    each its parameter's dtype), so the weights are never held twice.
    """
    device = torch.device(device) if device is not None else default_device()
    if state_dict is None and generator is None:
        raise ValueError("need a generator to initialise (or pass state_dict=)")
    with torch.device("meta"):
        module = FluxModel(cfg)
    if assign and state_dict is not None:
        module.load_state_dict(state_dict, assign=True)
        module = module.to(device).eval()
    else:
        module = module.to_empty(device=device).eval()
        if state_dict is not None:
            module.load_state_dict(state_dict)
        else:
            init_random_(module, generator)
    return DiffusionModel(
        module=module,
        name=name,
        config=cfg,
        block_lists={"double_blocks": cfg.depth, "single_blocks": cfg.depth_single_blocks},
        pipeline_spec=_flux_pipeline_spec(cfg),
    )
