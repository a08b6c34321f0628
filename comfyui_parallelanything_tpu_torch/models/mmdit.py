"""SD3/SD3.5-class MMDiT in PyTorch (counterpart of
``comfyui_parallelanything_tpu/models/mmdit.py``).

Architecture (the public SAI MMDiT): NHWC latent 2×2-patchified and projected to
``hidden = 64·depth`` tokens, plus a fixed 2-D sincos position table centre-cropped
to the token grid (no RoPE); text tokens projected from the joint CLIP ‖ T5
context; (timestep, pooled CLIP-L ‖ G vector) → modulation vector; ``depth``
joint blocks (separate context/x weights, one attention over [context ‖ x], 64-wide
heads, optional per-head q/k RMS norm for SD3.5); adaLN-modulated final
projection back to NHWC. The last block's context side is pre-only (it feeds q/k/v
to the joint attention and has no output path); SD3.5-medium (mmdit-x) adds a
second self-attention over x alone in the blocks ``x_block_self_attn_layers``
names.

Numerics follow the JAX module as the port's FLUX does: linears compute in
``cfg.dtype`` (weights stored in it), the adaLN and final linears in f32
(weights stored in f32), LayerNorm without scale or bias at eps 1e-6 computed in
f32, GELU with the tanh approximation. Submodule names follow the flax tree
(``blocks.{i}.x_attn_in.qkv``, ``x_adaln.lin``, ``pos_embed.table``), so
``convert_jax.from_jax_mmdit_params`` is a rename plus transposes. Attention goes
through ``ops.attention.attention``: on a CUDA tensor that is the flash attention
kernel K1. Concatenating the two streams' q/k/v makes them contiguous, so the
joint call is TMA-ready; the x-only call of a dual-attention block reads v as a
strided view of the fused qkv output.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..devices.discovery import default_device
from ..ops import basic
from ..ops.attention import attention
from ..ops.basic import modulate, rms_normalize, timestep_embedding
from .api import DiffusionModel, PipelineSegment, PipelineSpec
from .flux import MLPEmbedder, _gelu, _layer_norm, _split_qkv


@dataclasses.dataclass(frozen=True)
class MMDiTConfig:
    in_channels: int = 16          # latent channels (token width = p²·C)
    patch_size: int = 2
    depth: int = 24                # joint blocks; hidden = 64·depth, heads = depth
    context_in_dim: int = 4096     # T5 ‖ padded CLIP joint stream
    pooled_dim: int = 2048         # CLIP-L ‖ CLIP-G pooled
    pos_embed_max: int = 192       # the checkpoint's (max², hidden) table, cropped
    mlp_ratio: float = 4.0
    qk_norm: bool = False          # SD3.5's per-head q/k RMS norm
    # SD3.5-medium (mmdit-x): blocks with a second self-attention over x alone.
    x_block_self_attn_layers: tuple[int, ...] = ()
    dtype: torch.dtype = torch.bfloat16
    prediction: str = "flow"

    @property
    def hidden_size(self) -> int:
        return 64 * self.depth

    @property
    def num_heads(self) -> int:
        return self.depth

    @property
    def head_dim(self) -> int:
        return 64


def sd3_medium_config(**overrides) -> MMDiTConfig:
    """SD3-medium (2B): depth 24, no q/k norm."""
    return dataclasses.replace(MMDiTConfig(), **overrides)


def sd35_large_config(**overrides) -> MMDiTConfig:
    """SD3.5-large (8B): depth 38, q/k RMS norm."""
    return dataclasses.replace(MMDiTConfig(depth=38, qk_norm=True), **overrides)


def sd35_medium_config(**overrides) -> MMDiTConfig:
    """SD3.5-medium (2.5B, mmdit-x): depth 24, q/k RMS norm, a 384² position table
    and dual attention in the first 13 blocks (the published checkpoint's
    x_block_self_attn_layers)."""
    base = MMDiTConfig(depth=24, qk_norm=True, pos_embed_max=384,
                       x_block_self_attn_layers=tuple(range(13)))
    return dataclasses.replace(base, **overrides)


def sincos_pos_embed(max_size: int, dim: int) -> np.ndarray:
    """The fixed 2-D sincos table SD3 ships in its checkpoints, (max_size², dim)
    f32, half the width per axis; the width axis's half comes first, as SAI's
    ``get_2d_sincos_pos_embed`` orders it."""
    def axis_table(n, d):
        omega = 1.0 / (10000 ** (np.arange(d // 2, dtype=np.float64) / (d // 2)))
        out = np.einsum("p,f->pf", np.arange(n, dtype=np.float64), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    axis = axis_table(max_size, dim // 2)
    table = np.concatenate([np.tile(axis, (max_size, 1)), np.repeat(axis, max_size, axis=0)],
                           axis=1)
    return table.astype(np.float32)


class _AdaLN(nn.Module):
    """vec → ``n_chunks`` modulation tensors (f32), SAI chunk order."""

    def __init__(self, cfg: MMDiTConfig, n_chunks: int):
        super().__init__()
        self.n = n_chunks
        self.lin = nn.Linear(cfg.hidden_size, n_chunks * cfg.hidden_size, dtype=torch.float32)

    def forward(self, vec):
        return self.lin(F.silu(vec.float()))[:, None, :].chunk(self.n, dim=-1)


class _StreamAttnIn(nn.Module):
    """Pre-norm + modulation + fused qkv (+ per-head q/k RMS norm): q, k, v as
    (B, S, H, D)."""

    def __init__(self, cfg: MMDiTConfig):
        super().__init__()
        self.cfg = cfg
        self.qkv = nn.Linear(cfg.hidden_size, 3 * cfg.hidden_size, dtype=cfg.dtype)
        self.qkv.int8_row_groups = 3 * cfg.num_heads  # int8 scales shared over q/k/v heads
        self.qkv.jax_out_shape = (3, cfg.num_heads, cfg.head_dim)  # the JAX DenseGeneral's
        if cfg.qk_norm:
            self.ln_q = nn.Parameter(torch.ones(cfg.head_dim))
            self.ln_k = nn.Parameter(torch.ones(cfg.head_dim))

    def forward(self, x, shift, scale):
        cfg = self.cfg
        h = modulate(_layer_norm(x), shift, scale)
        q, k, v = _split_qkv(self.qkv(h), cfg.num_heads, cfg.head_dim)
        if cfg.qk_norm:
            q, k = rms_normalize(q, self.ln_q), rms_normalize(k, self.ln_k)
        return q, k, v


def _flat_attention(q, k, v):
    out = attention(q, k, v)
    return out.reshape(out.shape[0], out.shape[1], -1)


class JointBlock(nn.Module):
    """One MMDiT block: context and x streams modulate and project qkv separately,
    attend jointly over [context ‖ x], then run per-stream projection and MLP.
    ``pre_only`` (the last block's context side) has no output path;
    ``dual_attn`` adds mmdit-x's second self-attention over x alone, fed from the
    same pre-norm x and gated by the adaLN's third triple."""

    def __init__(self, cfg: MMDiTConfig, pre_only: bool = False, dual_attn: bool = False):
        super().__init__()
        self.cfg, self.pre_only, self.dual_attn = cfg, pre_only, dual_attn
        hidden, dt = cfg.hidden_size, cfg.dtype
        mlp_dim = int(hidden * cfg.mlp_ratio)
        self.x_adaln = _AdaLN(cfg, 9 if dual_attn else 6)
        self.x_attn_in = _StreamAttnIn(cfg)
        self.x_attn_proj = nn.Linear(hidden, hidden, dtype=dt)
        if dual_attn:
            self.x_attn_in2 = _StreamAttnIn(cfg)
            self.x_attn2_proj = nn.Linear(hidden, hidden, dtype=dt)
        self.x_mlp_in = nn.Linear(hidden, mlp_dim, dtype=dt)
        self.x_mlp_out = nn.Linear(mlp_dim, hidden, dtype=dt)
        self.ctx_adaln = _AdaLN(cfg, 2 if pre_only else 6)
        self.ctx_attn_in = _StreamAttnIn(cfg)
        if not pre_only:
            self.ctx_attn_proj = nn.Linear(hidden, hidden, dtype=dt)
            self.ctx_mlp_in = nn.Linear(hidden, mlp_dim, dtype=dt)
            self.ctx_mlp_out = nn.Linear(mlp_dim, hidden, dtype=dt)

    def forward(self, x, ctx, vec):
        dt = self.cfg.dtype
        x_mods = self.x_adaln(vec)
        xs1, xc1, xg1, xs2, xc2, xg2 = x_mods[:6]
        xq, xk, xv = self.x_attn_in(x, xs1, xc1)
        ctx_mods = self.ctx_adaln(vec)
        cq, ck, cv = self.ctx_attn_in(ctx, *ctx_mods[:2])

        ctx_len = ctx.shape[1]
        attn = _flat_attention(torch.cat([cq, xq], dim=1), torch.cat([ck, xk], dim=1),
                               torch.cat([cv, xv], dim=1))
        ctx_attn, x_attn = attn[:, :ctx_len], attn[:, ctx_len:]

        out = x + xg1.to(dt) * self.x_attn_proj(x_attn)
        if self.dual_attn:
            x2s, x2c, x2g = x_mods[6:]
            attn2 = _flat_attention(*self.x_attn_in2(x, x2s, x2c))
            out = out + x2g.to(dt) * self.x_attn2_proj(attn2)
        xm = modulate(_layer_norm(out), xs2, xc2)
        out = out + xg2.to(dt) * self.x_mlp_out(_gelu(self.x_mlp_in(xm)))
        if self.pre_only:
            return out, ctx
        _, _, cg1, cs2, cc2, cg2 = ctx_mods
        ctx = ctx + cg1.to(dt) * self.ctx_attn_proj(ctx_attn)
        cm = modulate(_layer_norm(ctx), cs2, cc2)
        ctx = ctx + cg2.to(dt) * self.ctx_mlp_out(_gelu(self.ctx_mlp_in(cm)))
        return out, ctx


class _PosTable(nn.Module):
    """The checkpoint's (max², hidden) sincos table, stored in ``cfg.dtype`` (the
    JAX module casts its f32 table to it before use)."""

    def __init__(self, cfg: MMDiTConfig):
        super().__init__()
        self.table = nn.Parameter(torch.empty(cfg.pos_embed_max ** 2, cfg.hidden_size,
                                              dtype=cfg.dtype))


class MMDiTModel(nn.Module):
    """forward(x latent NHWC, timesteps (B,) flow time in [0, 1], context (B, S,
    context_in_dim), y=(B, pooled_dim)) → NHWC velocity (f32).

    The forward is staged — ``prepare`` → ``block_step`` × depth → ``finalize`` —
    over a flat dict carry: img, ctx, vec."""

    def __init__(self, cfg: MMDiTConfig):
        super().__init__()
        self.cfg = cfg
        hidden, dt = cfg.hidden_size, cfg.dtype
        self.x_in = nn.Linear(cfg.patch_size ** 2 * cfg.in_channels, hidden, dtype=dt)
        self.pos_embed = _PosTable(cfg)
        self.context_in = nn.Linear(cfg.context_in_dim, hidden, dtype=dt)
        self.time_in = MLPEmbedder(256, cfg)
        self.vector_in = MLPEmbedder(cfg.pooled_dim, cfg)
        self.blocks = nn.ModuleList(
            JointBlock(cfg, pre_only=i == cfg.depth - 1,
                       dual_attn=i in cfg.x_block_self_attn_layers)
            for i in range(cfg.depth))
        self.final_mod = nn.Linear(hidden, 2 * hidden, dtype=torch.float32)
        self.final_proj = nn.Linear(hidden, cfg.patch_size ** 2 * cfg.in_channels,
                                    dtype=torch.float32)

    def _cropped_pos(self, hp: int, wp: int) -> torch.Tensor:
        """The table centre-cropped to the (hp, wp) token grid, (1, hp·wp, hidden)."""
        m = self.cfg.pos_embed_max
        if hp > m or wp > m:
            raise ValueError(f"latent grid {hp}x{wp} exceeds pos table {m}x{m}")
        top, left = (m - hp) // 2, (m - wp) // 2
        table = self.pos_embed.table.reshape(m, m, -1)
        return table[top:top + hp, left:left + wp].reshape(1, hp * wp, -1)

    def prepare(self, x, timesteps, context=None, y=None, **kwargs):
        """Patch and text embeddings, position table and modulation vector → the
        stage carry."""
        cfg = self.cfg
        B, Hh, Ww, C = x.shape
        p = cfg.patch_size
        hp, wp = Hh // p, Ww // p
        img = x.to(cfg.dtype).reshape(B, hp, p, wp, p, C)
        img = self.x_in(img.permute(0, 1, 3, 2, 4, 5).reshape(B, hp * wp, p * p * C))
        img = img + self._cropped_pos(hp, wp).to(cfg.dtype)
        if context is None:
            raise ValueError("SD3 requires text context tokens")
        ctx = self.context_in(context.to(cfg.dtype))
        vec = self.time_in(timestep_embedding(timesteps, 256, time_factor=1000.0).to(cfg.dtype))
        if y is None:
            y = torch.zeros((B, cfg.pooled_dim), dtype=torch.float32, device=x.device)
        vec = vec + self.vector_in(y.to(cfg.dtype))
        return {"img": img, "ctx": ctx, "vec": vec}

    def block_step(self, carry, i: int):
        img, ctx = self.blocks[i](carry["img"], carry["ctx"], carry["vec"])
        return {**carry, "img": img, "ctx": ctx}

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

    def forward(self, x, timesteps, context=None, y=None, **kwargs):
        carry = self.prepare(x, timesteps, context, y=y)
        for i in range(self.cfg.depth):
            carry = self.block_step(carry, i)
        return self.finalize(carry, tuple(x.shape))


def _mmdit_pipeline_spec(cfg: MMDiTConfig) -> PipelineSpec:
    """Embeddings on the lead device, one segment per joint block, the final
    projection on the lead (the final LayerNorm has no parameters)."""

    def make_block(i):
        return lambda module, carry: module.block_step(carry, i)

    return PipelineSpec(
        prepare_keys=("x_in", "pos_embed", "context_in", "time_in", "vector_in"),
        prepare=lambda module, x, t, context=None, **kw: module.prepare(x, t, context, **kw),
        segments=tuple(PipelineSegment((f"blocks.{i}",), make_block(i), f"joint_{i}")
                       for i in range(cfg.depth)),
        finalize_keys=("final_mod", "final_proj"),
        finalize=lambda module, carry, out_shape: module.finalize(carry, out_shape),
    )


@torch.no_grad()
def init_random_(module: MMDiTModel, generator: torch.Generator) -> None:
    """Random weights from ``generator``, in place: every linear N(0, 1/fan_in) with
    zero bias (``ops.basic.init_random_``), the q/k norm scales one, the position
    table the sincos table SD3's checkpoints ship."""
    basic.init_random_(module, generator)
    for m in module.modules():
        if isinstance(m, _StreamAttnIn) and m.cfg.qk_norm:
            m.ln_q.fill_(1.0)
            m.ln_k.fill_(1.0)
    cfg = module.cfg
    module.pos_embed.table.copy_(torch.from_numpy(
        sincos_pos_embed(cfg.pos_embed_max, cfg.hidden_size)))


def build_mmdit(cfg: MMDiTConfig, *, device=None, generator: torch.Generator | None = None,
                state_dict: dict | None = None, name: str = "mmdit") -> DiffusionModel:
    """An SD3-class MMDiT ``DiffusionModel`` on ``device`` (default ``cuda:0``),
    from ``state_dict`` (``convert_mmdit`` or ``convert_jax``) or random weights
    from ``generator``. The module is materialised on the device without a host
    copy of its weights."""
    device = torch.device(device) if device is not None else default_device()
    if state_dict is None and generator is None:
        raise ValueError("need a generator to initialise (or pass state_dict=)")
    with torch.device("meta"):
        module = MMDiTModel(cfg)
    module = module.to_empty(device=device).eval()
    if state_dict is not None:
        module.load_state_dict(state_dict)
    else:
        init_random_(module, generator)
    return DiffusionModel(module=module, name=name, config=cfg,
                          block_lists={"joint_blocks": cfg.depth},
                          pipeline_spec=_mmdit_pipeline_spec(cfg))
