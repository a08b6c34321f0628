"""Text encoders (CLIP-L / OpenCLIP-H / OpenCLIP-G / T5) in PyTorch (counterpart
of ``comfyui_parallelanything_tpu/models/text_encoders.py``).

- **CLIP** (SD1.5 context; SDXL & FLUX pooled vector): pre-LN causal transformer,
  quick-gelu (CLIP-L) or exact gelu (OpenCLIP), 77-token window; returns the final
  LayerNormed stream, the penultimate stream and the first-EOS pooled vector.
- **T5 encoder** (FLUX/WAN context): RMSNorm, relative-position-bucket attention
  bias (shared from layer 0, or one table per layer for UMT5), key mask, unscaled
  logits, tanh-GELU gated FFN.
- **SDXL and SD3 conditioning**: ``sdxl_text_conditioning``,
  ``sdxl_refiner_text_conditioning`` and ``sd3_text_conditioning`` assemble the
  diffusion model's (context, y) pair from the towers' outputs.

Numerics follow the JAX module: linears and embeddings compute in ``cfg.dtype``
(weights stored in it, as flax casts them to it before use), CLIP's LayerNorms
at eps 1e-5 in f32 with f32 parameters, T5's RMSNorm at eps 1e-6 with the
normalised value cast back to the input dtype before an f32 scale (so its output
is f32), attention logits in f32 under ``-inf`` masks, probabilities cast back to
the value dtype. The attention here is plain matmul + softmax: the JAX module
computes it with einsums outside its Pallas kernel. Submodule and parameter names
follow the flax tree (``layers.{i}.q``, ``rel_bias``, ``tok_emb``), so
``convert_jax.from_jax_text_params`` is a rename plus transposes.

At T5-XXL size (4.76 B parameters) the weights take 9.5 GB in bf16 against 19 GB
in f32; only the relative-bias tables and norm scales stay f32.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..devices.discovery import default_device
from ..ops import basic
from ..ops.basic import LayerNorm, flax_apply, timestep_embedding

# ---------------------------------------------------------------------------
# CLIP text towers
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_len: int = 77
    intermediate_size: int | None = None  # default 4*hidden
    act: str = "quick_gelu"  # "quick_gelu" (CLIP-L) | "gelu" (OpenCLIP)
    eos_id: int = 49407
    projection_dim: int | None = None  # text_projection for pooled (OpenCLIP / SDXL)
    # SD2's FrozenOpenCLIPEmbedder applies ln_final to the penultimate stream;
    # SDXL consumes it raw.
    penultimate_ln: bool = False
    dtype: torch.dtype = torch.bfloat16

    @property
    def d_ff(self) -> int:
        return self.intermediate_size or 4 * self.hidden_size


def clip_l_config(**overrides) -> CLIPTextConfig:
    """OpenAI CLIP ViT-L/14 text tower (SD1.5 context encoder; SDXL/FLUX 'clip_l')."""
    return dataclasses.replace(CLIPTextConfig(), **overrides)


def open_clip_h_config(**overrides) -> CLIPTextConfig:
    """OpenCLIP ViT-H/14 text tower (SD2.x context encoder): 1024 wide, 24 layers,
    plain gelu; SD2.x conditions on the penultimate layer."""
    base = CLIPTextConfig(hidden_size=1024, num_layers=24, num_heads=16, act="gelu",
                          projection_dim=1024, penultimate_ln=True)
    return dataclasses.replace(base, **overrides)


def open_clip_g_config(**overrides) -> CLIPTextConfig:
    """OpenCLIP bigG/14 text tower (SDXL's second encoder)."""
    base = CLIPTextConfig(hidden_size=1280, num_layers=32, num_heads=20, act="gelu",
                          projection_dim=1280)
    return dataclasses.replace(base, **overrides)


def _act(name: str):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    if name == "gelu":
        return lambda x: F.gelu(x)  # HF/OpenCLIP "gelu" is the exact erf form
    raise ValueError(f"unknown activation {name!r}")



class _CLIPBlock(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        w, dt = cfg.hidden_size, cfg.dtype
        self.cfg = cfg
        self.ln1 = LayerNorm(w, 1e-5)
        self.q = nn.Linear(w, w, dtype=dt)
        self.k = nn.Linear(w, w, dtype=dt)
        self.v = nn.Linear(w, w, dtype=dt)
        self.out = nn.Linear(w, w, dtype=dt)
        self.ln2 = LayerNorm(w, 1e-5)
        self.fc1 = nn.Linear(w, cfg.d_ff, dtype=dt)
        self.fc2 = nn.Linear(cfg.d_ff, w, dtype=dt)
        self.act = _act(cfg.act)

    def forward(self, x, bias):
        cfg = self.cfg
        H = cfg.num_heads
        D = cfg.hidden_size // H
        h = self.ln1(x)
        B, S, _ = h.shape
        q, k, v = (flax_apply(m, h).reshape(B, S, H, D) for m in (self.q, self.k, self.v))
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * (D**-0.5)
        probs = torch.softmax(logits.float() + bias, dim=-1)
        attn = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
        x = x + flax_apply(self.out, attn.reshape(B, S, cfg.hidden_size))
        h = self.act(flax_apply(self.fc1, self.ln2(x)))
        return x + flax_apply(self.fc2, h)


class CLIPTextModel(nn.Module):
    """Returns (last_hidden, penultimate_hidden, pooled). ``last_hidden`` has the
    final LayerNorm applied; ``penultimate_hidden`` is the raw layer-(N-1) stream
    unless ``cfg.penultimate_ln``. ``pooled`` reads the first-EOS position of the
    final-LN stream, projected when ``cfg.projection_dim`` is set."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        self.tok_emb = nn.Embedding(cfg.vocab_size, cfg.hidden_size, dtype=cfg.dtype)
        self.pos_emb = nn.Parameter(torch.zeros(cfg.max_len, cfg.hidden_size))
        self.layers = nn.ModuleList(_CLIPBlock(cfg) for _ in range(cfg.num_layers))
        self.final_ln = LayerNorm(cfg.hidden_size, 1e-5)
        if cfg.projection_dim is not None:
            self.text_proj = nn.Linear(cfg.hidden_size, cfg.projection_dim, bias=False,
                                       dtype=cfg.dtype)

    def forward(self, tokens):
        cfg = self.cfg
        B, S = tokens.shape
        x = self.tok_emb(tokens) + self.pos_emb[None, :S].to(cfg.dtype)
        causal = torch.full((S, S), -math.inf, device=x.device).triu(1)[None, None]
        penultimate = None
        for i, layer in enumerate(self.layers):
            if i == cfg.num_layers - 1:
                penultimate = x
            x = layer(x, causal)
        last = self.final_ln(x)
        if cfg.penultimate_ln:
            penultimate = self.final_ln(penultimate)
        eos_pos = torch.argmax((tokens == cfg.eos_id).int(), dim=-1)
        pooled = last[torch.arange(B, device=last.device), eos_pos]
        if cfg.projection_dim is not None:
            pooled = flax_apply(self.text_proj, pooled)
        return last, penultimate, pooled


# ---------------------------------------------------------------------------
# T5 encoder
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 4096
    num_layers: int = 24
    num_heads: int = 64
    d_kv: int = 64
    d_ff: int = 10240
    relative_buckets: int = 32
    relative_max_distance: int = 128
    # UMT5 gives every layer its own relative-position bias table; classic T5
    # shares layer 0's.
    per_layer_bias: bool = False
    dtype: torch.dtype = torch.bfloat16


def t5_xxl_config(**overrides) -> T5Config:
    """google/t5-v1_1-xxl encoder — the FLUX 't5xxl' conditioning tower."""
    return dataclasses.replace(T5Config(), **overrides)


def umt5_xxl_config(**overrides) -> T5Config:
    """google/umt5-xxl encoder — the WAN conditioning tower (256k-token vocab,
    per-layer relative bias; otherwise the XXL geometry)."""
    return dataclasses.replace(T5Config(vocab_size=256384, per_layer_bias=True), **overrides)


def _t5_relative_buckets(rel_pos: torch.Tensor, num_buckets: int,
                         max_distance: int) -> torch.Tensor:
    """Bidirectional T5 bucket scheme: sign split, then exact small distances,
    log-spaced large ones (f32 arithmetic, truncated, as the JAX module)."""
    num_buckets //= 2
    ret = torch.where(rel_pos > 0, num_buckets, 0)
    n = rel_pos.abs()
    max_exact = num_buckets // 2
    # Distances below max_exact take the exact branch; clamping keeps log finite.
    ratio = torch.log(n.clamp(min=1).float() / max_exact)
    denom = torch.log(torch.tensor(max_distance / max_exact, dtype=torch.float32))
    large = max_exact + (ratio / denom.to(ratio.device) * (num_buckets - max_exact)).int()
    large = torch.clamp(large, max=num_buckets - 1)
    return ret + torch.where(n < max_exact, n, large)


class _T5RMSNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        var = x.float().square().mean(dim=-1, keepdim=True)
        return (x * torch.rsqrt(var + 1e-6)).to(x.dtype) * self.weight


class _T5Block(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.cfg = cfg
        inner, dt = cfg.num_heads * cfg.d_kv, cfg.dtype
        self.ln1 = _T5RMSNorm(cfg.d_model)
        self.q = nn.Linear(cfg.d_model, inner, bias=False, dtype=dt)
        self.k = nn.Linear(cfg.d_model, inner, bias=False, dtype=dt)
        self.v = nn.Linear(cfg.d_model, inner, bias=False, dtype=dt)
        self.o = nn.Linear(inner, cfg.d_model, bias=False, dtype=dt)
        self.ln2 = _T5RMSNorm(cfg.d_model)
        self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False, dtype=dt)
        self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False, dtype=dt)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False, dtype=dt)

    def forward(self, x, bias):
        cfg = self.cfg
        H, D = cfg.num_heads, cfg.d_kv
        h = self.ln1(x)
        B, S, _ = h.shape
        q, k, v = (flax_apply(m, h).reshape(B, S, H, D) for m in (self.q, self.k, self.v))
        # Unscaled dot products (T5 folds 1/sqrt(d) into its init).
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() + bias
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        attn = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, S, H * D)
        x = x + flax_apply(self.o, attn)
        h = self.ln2(x)
        h = F.gelu(flax_apply(self.wi_0, h), approximate="tanh") * flax_apply(self.wi_1, h)
        return x + flax_apply(self.wo, h)


class T5Encoder(nn.Module):
    """Bidirectional T5 v1.1 / UMT5 encoder stack; returns the final RMS-normed
    stream (f32). The relative-position bias table ``rel_bias`` is shared by all
    layers unless ``cfg.per_layer_bias`` (UMT5: ``rel_bias_{i}`` per layer);
    ``mask`` (B, S) of 0/1 marks real tokens; a row with none comes out NaN."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.cfg = cfg
        self.tok_emb = nn.Embedding(cfg.vocab_size, cfg.d_model, dtype=cfg.dtype)
        shape = (cfg.relative_buckets, cfg.num_heads)
        if cfg.per_layer_bias:
            for i in range(cfg.num_layers):
                self.register_parameter(f"rel_bias_{i}", nn.Parameter(torch.zeros(shape)))
        else:
            self.rel_bias = nn.Parameter(torch.zeros(shape))
        self.blocks = nn.ModuleList(_T5Block(cfg) for _ in range(cfg.num_layers))
        self.final_ln = _T5RMSNorm(cfg.d_model)

    def forward(self, tokens, mask=None):
        cfg = self.cfg
        S = tokens.shape[1]
        x = self.tok_emb(tokens)
        pos = torch.arange(S, device=tokens.device)
        buckets = _t5_relative_buckets(pos[None, :] - pos[:, None], cfg.relative_buckets,
                                       cfg.relative_max_distance)
        mask_bias = 0.0
        if mask is not None:
            # A row with no real token softmaxes over all -inf: NaN, as in JAX.
            mask_bias = torch.where(mask[:, None, None, :] > 0, 0.0, -math.inf)

        def layer_bias(table):
            return table[buckets].permute(2, 0, 1)[None].float() + mask_bias

        bias = None if cfg.per_layer_bias else layer_bias(self.rel_bias)
        for i, block in enumerate(self.blocks):
            b = layer_bias(getattr(self, f"rel_bias_{i}")) if cfg.per_layer_bias else bias
            x = block(x, b)
        return self.final_ln(x)


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TextEncoder:
    """An encoder and its config: ``__call__`` takes int token ids (numpy or
    tensor), moves them to the module's device and runs it without gradients."""

    module: nn.Module
    cfg: object

    @property
    def device(self) -> torch.device:
        return self.module.tok_emb.weight.device

    def __call__(self, tokens, **kw):
        def ids(a):
            return torch.as_tensor(a, device=self.device).long()

        with torch.no_grad():
            return self.module(ids(tokens), **{k: ids(v) for k, v in kw.items()})


def init_random_(module: nn.Module, generator: torch.Generator) -> None:
    """Random weights from ``generator``, in place: linears, embeddings and
    LayerNorms as ``ops.basic.init_random_`` sets them, T5's RMSNorm scales one,
    CLIP's position table N(0, 0.01) and T5's bias tables N(0, 1)."""
    basic.init_random_(module, generator)
    for m in module.modules():
        if isinstance(m, _T5RMSNorm):
            m.weight.fill_(1.0)
    for name, p in module.named_parameters(recurse=False):
        if name == "pos_emb":
            p.normal_(0.0, 0.01, generator=generator)
        elif name.startswith("rel_bias"):
            p.normal_(0.0, 1.0, generator=generator)


def _build(module_cls, cfg, device, generator, state_dict) -> TextEncoder:
    device = torch.device(device) if device is not None else default_device()
    if state_dict is None and generator is None:
        raise ValueError("need a generator to initialise (or pass state_dict=)")
    with torch.device("meta"):
        module = module_cls(cfg)
    module = module.to_empty(device=device).eval()
    with torch.no_grad():
        if state_dict is not None:
            module.load_state_dict(state_dict)
        else:
            init_random_(module, generator)
    return TextEncoder(module=module, cfg=cfg)


def build_clip_text(cfg: CLIPTextConfig, *, device=None, generator: torch.Generator | None = None,
                    state_dict: dict | None = None) -> TextEncoder:
    """A CLIP text tower on ``device`` (default ``cuda:0``), from ``state_dict``
    (``convert_text`` or ``convert_jax``) or random weights from ``generator``."""
    return _build(CLIPTextModel, cfg, device, generator, state_dict)


def build_t5_encoder(cfg: T5Config, *, device=None, generator: torch.Generator | None = None,
                     state_dict: dict | None = None) -> TextEncoder:
    """A T5 encoder on ``device`` (default ``cuda:0``), from ``state_dict`` or
    random weights from ``generator``."""
    return _build(T5Encoder, cfg, device, generator, state_dict)


# ---------------------------------------------------------------------------
# SDXL conditioning
# ---------------------------------------------------------------------------


def _size_embeddings(pooled: torch.Tensor, values) -> torch.Tensor:
    """``pooled`` (f32) ⊕ a 256-wide sinusoidal embedding of each value."""
    B = pooled.shape[0]
    embs = [timestep_embedding(torch.full((B,), float(v), dtype=torch.float32,
                                          device=pooled.device), 256) for v in values]
    return torch.cat([pooled.float(), *embs], dim=-1)


def sdxl_text_conditioning(l_penultimate, g_penultimate, g_pooled, width: int, height: int,
                           crop_x: int = 0, crop_y: int = 0, target_width: int | None = None,
                           target_height: int | None = None):
    """SDXL's (context, y): context = CLIP-L ⊕ OpenCLIP-G penultimate streams
    (768 + 1280 = 2048 wide, f32); y = G pooled (1280) ⊕ six sinusoidal embeddings
    of height, width, crop_y, crop_x, target height and width (256 each → 2816 =
    the UNet's adm_in_channels)."""
    context = torch.cat([l_penultimate.float(), g_penultimate.float()], dim=-1)
    sizes = [height, width, crop_y, crop_x, target_height or height, target_width or width]
    return context, _size_embeddings(g_pooled, sizes)


def sdxl_refiner_text_conditioning(g_penultimate, g_pooled, width: int, height: int,
                                   ascore: float, crop_x: int = 0, crop_y: int = 0):
    """The SDXL refiner's (context, y): context = the OpenCLIP-G penultimate stream
    (1280 wide, f32); y = G pooled (1280) ⊕ five sinusoidal embeddings of height,
    width, crop_y, crop_x and the aesthetic score (→ 2560)."""
    return g_penultimate.float(), _size_embeddings(g_pooled, [height, width, crop_y, crop_x,
                                                              ascore])


def sd3_text_conditioning(l_penultimate, g_penultimate, l_pooled, g_pooled,
                          t5_context=None, context_dim: int = 4096):
    """SD3's (context, y): the CLIP joint stream (L ⊕ G penultimate, 768 + 1280)
    zero-padded to ``context_dim`` and joined along the sequence axis with the T5
    stream when there is one; y = L pooled ⊕ G pooled (2048). All f32."""
    clip_joint = torch.cat([l_penultimate.float(), g_penultimate.float()], dim=-1)
    pad = context_dim - clip_joint.shape[-1]
    if pad < 0:
        raise ValueError(f"CLIP joint width {clip_joint.shape[-1]} exceeds {context_dim}")
    context = F.pad(clip_joint, (0, pad))
    if t5_context is not None:
        context = torch.cat([context, t5_context.float()], dim=1)
    return context, torch.cat([l_pooled.float(), g_pooled.float()], dim=-1)
