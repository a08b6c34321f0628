"""CLIP vision towers (ViT) in PyTorch (counterpart of
``comfyui_parallelanything_tpu/models/vision.py``).

The image half of CLIP, read by unCLIP checkpoints and the stock
``CLIPVisionLoader`` / ``CLIPVisionEncode`` nodes: a patch convolution, the CLS
token and learned positions, a pre-LN, then the text towers' pre-LN block
(``text_encoders._CLIPBlock``, with a zero additive bias: no mask) and a post-LN on
the CLS token only, optionally projected. Images are NHWC, as in the JAX module.

Outputs follow the host's CLIP_VISION_OUTPUT: the projected ``image_embeds``, the
raw last hidden states (HF's convention: the post-LN applies to the pooled CLS
only) and the raw penultimate hidden states.

Numerics follow the JAX module: the patch convolution, the linears and the CLS and
position tables compute in ``cfg.dtype``; the LayerNorms in f32 at eps 1e-5. The
attention is the text block's plain matmul + softmax (the JAX module computes it
with einsums outside its Pallas kernel), so no call reaches K1. Parameter names
follow the flax tree (``patch_embed``, ``class_embedding``, ``pos_emb``,
``pre_ln``, ``layers.{i}``, ``post_ln``, ``visual_proj``), so
``convert_jax.from_jax_vision_params`` is a rename plus transposes.

Checkpoints: the HF ``vision_model.*`` layout (``convert_clip_vision_checkpoint``,
the tower sniffed by ``sniff_vision_config``), and OpenCLIP's ``visual.*`` layout
(the sd21-unclip checkpoints' bundled ViT-H), remapped by
``openclip_visual_to_hf``.
"""

from __future__ import annotations

import dataclasses
import re
from collections.abc import Mapping
from typing import Any

import torch
from torch import nn

from ..devices.discovery import default_device
from ..ops.basic import LayerNorm, flax_apply, init_random_
from .convert_text import to_f32
from .text_encoders import CLIPTextConfig, _CLIPBlock

# OpenAI CLIP preprocessing constants (the host's clip_preprocess).
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int | None = None  # default 4*hidden
    act: str = "quick_gelu"  # ViT-L; ViT-H/bigG use "gelu"
    projection_dim: int | None = 768
    dtype: torch.dtype = torch.bfloat16

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    def block_cfg(self) -> CLIPTextConfig:
        """The text towers' block config for this width (the same pre-LN block)."""
        return CLIPTextConfig(hidden_size=self.hidden_size, num_heads=self.num_heads,
                              intermediate_size=self.intermediate_size, act=self.act,
                              dtype=self.dtype)


def clip_vit_l_14_config(**overrides) -> CLIPVisionConfig:
    """OpenAI CLIP ViT-L/14 vision tower (SD unCLIP-small / IPAdapter sd15)."""
    return dataclasses.replace(CLIPVisionConfig(), **overrides)


def clip_vit_h_14_config(**overrides) -> CLIPVisionConfig:
    """OpenCLIP ViT-H/14 vision tower (the common IPAdapter image encoder)."""
    base = CLIPVisionConfig(hidden_size=1280, num_layers=32, num_heads=16, act="gelu",
                            projection_dim=1024)
    return dataclasses.replace(base, **overrides)


def clip_vit_bigg_14_config(**overrides) -> CLIPVisionConfig:
    """OpenCLIP bigG/14 vision tower (SDXL-family image conditioning)."""
    base = CLIPVisionConfig(hidden_size=1664, num_layers=48, num_heads=16,
                            intermediate_size=8192, act="gelu", projection_dim=1280)
    return dataclasses.replace(base, **overrides)


class CLIPVisionModel(nn.Module):
    """forward(images NHWC, clip-preprocessed to (B, image_size, image_size, 3)) →
    (image_embeds, last_hidden, penultimate)."""

    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.cfg = cfg
        w, p, dt = cfg.hidden_size, cfg.patch_size, cfg.dtype
        self.patch_embed = nn.Conv2d(3, w, p, stride=p, bias=False, dtype=dt)
        self.class_embedding = nn.Parameter(torch.zeros(w))
        self.pos_emb = nn.Parameter(torch.zeros(cfg.num_patches + 1, w))
        self.pre_ln = LayerNorm(w, 1e-5)
        block = cfg.block_cfg()
        self.layers = nn.ModuleList(_CLIPBlock(block) for _ in range(cfg.num_layers))
        self.post_ln = LayerNorm(w, 1e-5)
        if cfg.projection_dim is not None:
            self.visual_proj = nn.Linear(w, cfg.projection_dim, bias=False, dtype=dt)

    def forward(self, images):
        cfg = self.cfg
        x = flax_apply(self.patch_embed, images.permute(0, 3, 1, 2))
        B = x.shape[0]
        x = x.permute(0, 2, 3, 1).reshape(B, -1, cfg.hidden_size)
        cls = self.class_embedding.to(cfg.dtype).expand(B, 1, cfg.hidden_size)
        x = torch.cat([cls, x], dim=1) + self.pos_emb[None].to(cfg.dtype)
        x = self.pre_ln(x)
        bias = torch.zeros((1, 1, 1, 1), device=x.device)  # no mask for vision
        penultimate = None
        for i, layer in enumerate(self.layers):
            if i == cfg.num_layers - 1:
                penultimate = x
            x = layer(x, bias)
        pooled = self.post_ln(x[:, 0])
        if cfg.projection_dim is not None:
            pooled = flax_apply(self.visual_proj, pooled)
        return pooled, x, penultimate


@dataclasses.dataclass
class VisionEncoder:
    """A vision tower and its config: ``__call__`` takes preprocessed NHWC images,
    moves them to the module's device and runs it without gradients."""

    module: nn.Module
    cfg: CLIPVisionConfig
    name: str = "clip-vision"

    @property
    def device(self) -> torch.device:
        return self.module.pos_emb.device

    def __call__(self, images):
        with torch.no_grad():
            return self.module(torch.as_tensor(images, device=self.device))


def build_clip_vision(cfg: CLIPVisionConfig, *, device=None,
                      generator: torch.Generator | None = None,
                      state_dict: dict | None = None, name: str = "clip-vision") -> VisionEncoder:
    """A vision tower on ``device`` (default ``cuda:0``), from ``state_dict``
    (``convert_clip_vision_checkpoint`` or ``convert_jax``) or random weights from
    ``generator`` (the CLS token and positions N(0, 0.02), as flax initialises
    them)."""
    device = torch.device(device) if device is not None else default_device()
    if state_dict is None and generator is None:
        raise ValueError("need a generator to initialise (or pass state_dict=)")
    with torch.device("meta"):
        module = CLIPVisionModel(cfg)
    module = module.to_empty(device=device).eval()
    with torch.no_grad():
        if state_dict is not None:
            module.load_state_dict(state_dict)
        else:
            init_random_(module, generator)
            module.class_embedding.normal_(0.0, 0.02, generator=generator)
            module.pos_emb.normal_(0.0, 0.02, generator=generator)
    return VisionEncoder(module=module, cfg=cfg, name=name)


def clip_preprocess(images, size: int = 224, crop: bool = True) -> torch.Tensor:
    """The host's clip_preprocess: [0, 1] NHWC images → ``size``-square,
    CLIP-normalised f32 input. ``crop=True`` resizes the short side bicubically and
    centre-crops (the OpenAI/HF image processor); ``crop=False`` squashes straight
    to the square (the stock node's crop="none")."""
    from ..ops.resize import resize

    img = torch.as_tensor(images).float()
    if img.ndim == 3:
        img = img[None]
    B, H, W, C = img.shape
    if crop:
        scale = size / min(H, W)
        nh, nw = max(size, round(H * scale)), max(size, round(W * scale))
        img = resize(img, (B, nh, nw, C), method="cubic")
        y0, x0 = (nh - size) // 2, (nw - size) // 2
        img = img[:, y0:y0 + size, x0:x0 + size, :]
    else:
        img = resize(img, (B, size, size, C), method="cubic")
    mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=img.device)
    std = torch.tensor(CLIP_STD, dtype=torch.float32, device=img.device)
    return (torch.clamp(img, 0.0, 1.0) - mean) / std


# ---------------------------------------------------------------------------
# Checkpoint conversion (HF CLIPVisionModel layout)
# ---------------------------------------------------------------------------


def sniff_vision_config(sd: Mapping[str, Any]) -> CLIPVisionConfig:
    """The tower of an HF-layout state dict: width and patch from the patch
    convolution, image size from the position table, depth from the layer indices,
    heads and activation by the known families."""
    hidden, _, patch, _ = sd["vision_model.embeddings.patch_embedding.weight"].shape
    n_pos = sd["vision_model.embeddings.position_embedding.weight"].shape[0]
    image_size = int(round((n_pos - 1) ** 0.5)) * patch
    layers = 1 + max(int(m.group(1)) for k in sd
                     if (m := re.match(r"vision_model\.encoder\.layers\.(\d+)\.", k)))
    fc1 = sd["vision_model.encoder.layers.0.mlp.fc1.weight"].shape
    proj = None
    if "visual_projection.weight" in sd:
        proj = int(sd["visual_projection.weight"].shape[0])
    # OpenAI ViT-B/L keep 64-wide heads (12/16); OpenCLIP ViT-H (1280) and bigG
    # (1664) both use 16 heads (80- and 104-wide).
    heads = {768: 12, 1024: 16, 1280: 16, 1664: 16}.get(int(hidden), max(1, int(hidden) // 64))
    return CLIPVisionConfig(image_size=image_size, patch_size=int(patch),
                            hidden_size=int(hidden), num_layers=layers, num_heads=heads,
                            intermediate_size=int(fc1[0]),
                            act="quick_gelu" if hidden <= 1024 else "gelu",
                            projection_dim=proj)


_OPENCLIP_LAYER = {"ln_1": "layer_norm1", "ln_2": "layer_norm2", "attn": "self_attn",
                   "mlp": "mlp", "c_fc": "fc1", "c_proj": "fc2", "out_proj": "out_proj"}


def openclip_visual_to_hf(sd: Mapping[str, Any]) -> dict:
    """OpenCLIP ``visual.*`` layout (keys relative to the ``visual.`` root) → HF
    ``vision_model.*`` names: the fused qkv ``in_proj`` split in thirds, the raw
    ``proj`` matrix transposed, every other key renamed. The sd21-unclip checkpoints
    bundle their ViT-H image encoder this way (``embedder.model.visual.*``)."""
    out: dict = {}
    for k, v in sd.items():
        parts = k.split(".")
        if k == "conv1.weight":
            out["vision_model.embeddings.patch_embedding.weight"] = v
        elif k == "class_embedding":
            out["vision_model.embeddings.class_embedding"] = v
        elif k == "positional_embedding":
            out["vision_model.embeddings.position_embedding.weight"] = v
        elif parts[0] == "ln_pre":
            out[f"vision_model.pre_layrnorm.{parts[1]}"] = v
        elif parts[0] == "ln_post":
            out[f"vision_model.post_layernorm.{parts[1]}"] = v
        elif k == "proj":
            out["visual_projection.weight"] = to_f32(v).T
        elif parts[0] == "transformer" and parts[1] == "resblocks":
            lp = f"vision_model.encoder.layers.{parts[2]}."
            rest = ".".join(parts[3:])
            if rest in ("attn.in_proj_weight", "attn.in_proj_bias"):
                arr = to_f32(v)
                third = arr.shape[0] // 3
                kind = "weight" if rest.endswith("weight") else "bias"
                for i, name in enumerate(("q_proj", "k_proj", "v_proj")):
                    out[f"{lp}self_attn.{name}.{kind}"] = arr[i * third:(i + 1) * third]
            else:
                out[lp + ".".join(_OPENCLIP_LAYER.get(p, p) for p in parts[3:])] = v
        else:
            raise KeyError(f"unrecognized OpenCLIP visual key: {k}")
    return out


def convert_clip_vision_checkpoint(sd: Mapping[str, Any], cfg: CLIPVisionConfig | None = None
                                   ) -> tuple[dict[str, torch.Tensor], CLIPVisionConfig]:
    """HF ``vision_model.*`` state dict → (``CLIPVisionModel`` state dict, config).
    OpenCLIP ``visual.*`` dicts are detected and remapped first; every tensor is
    upcast to f32 (loading casts it to the module's dtype)."""
    if "conv1.weight" in sd and "class_embedding" in sd:
        sd = openclip_visual_to_hf(sd)
    if cfg is None:
        cfg = sniff_vision_config(sd)
    pre = "vision_model."

    def t(key):
        return to_f32(sd[key])

    out = {
        "patch_embed.weight": t(f"{pre}embeddings.patch_embedding.weight"),
        "class_embedding": t(f"{pre}embeddings.class_embedding").reshape(-1),
        "pos_emb": t(f"{pre}embeddings.position_embedding.weight"),
        "pre_ln.weight": t(f"{pre}pre_layrnorm.weight"),  # HF's own spelling
        "pre_ln.bias": t(f"{pre}pre_layrnorm.bias"),
        "post_ln.weight": t(f"{pre}post_layernorm.weight"),
        "post_ln.bias": t(f"{pre}post_layernorm.bias"),
    }
    names = {"ln1": "layer_norm1", "ln2": "layer_norm2", "q": "self_attn.q_proj",
             "k": "self_attn.k_proj", "v": "self_attn.v_proj", "out": "self_attn.out_proj",
             "fc1": "mlp.fc1", "fc2": "mlp.fc2"}
    for i in range(cfg.num_layers):
        for mine, theirs in names.items():
            for leaf in ("weight", "bias"):
                out[f"layers.{i}.{mine}.{leaf}"] = t(
                    f"{pre}encoder.layers.{i}.{theirs}.{leaf}")
    if cfg.projection_dim is not None and "visual_projection.weight" in sd:
        out["visual_proj.weight"] = t("visual_projection.weight")
    return out, cfg


def load_clip_vision_checkpoint(src: Any, cfg: CLIPVisionConfig | None = None,
                                name: str = "clip-vision", device=None) -> VisionEncoder:
    """A CLIP vision checkpoint (path or state dict, HF or OpenCLIP layout) → a
    ``VisionEncoder`` on ``device`` (default ``cuda:0``)."""
    from .loader import _resolve_state_dict

    state, cfg = convert_clip_vision_checkpoint(_resolve_state_dict(src), cfg)
    return build_clip_vision(cfg, device=device, state_dict=state, name=name)
