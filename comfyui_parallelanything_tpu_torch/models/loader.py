"""Checkpoint loading: a .safetensors file or a state dict → converted weights →
a ready model (counterpart of ``comfyui_parallelanything_tpu/models/loader.py``).

    model = load_flux_checkpoint("flux1-dev-fp8.safetensors", flux_dev_config(),
                                 lora="my_lora.safetensors")
    pm = parallelize(model, [("cuda:0", 97), ("cpu", 3)])

- The safetensors reader is the port's own (the ``safetensors`` package is not a
  dependency): the 8-byte little-endian header length, the JSON header, then each
  tensor's raw bytes read into its own buffer and viewed with ``torch.frombuffer``
  in the dtype stored (F64, F32, F16, BF16, F8_E4M3, F8_E5M2, I64, I32, I16, I8,
  U8, BOOL). Nothing is upcast on read: the converters cast each tensor to the
  dtype of the parameter it becomes. A truncated file, an unknown dtype or a
  header whose offsets do not match its shapes raises ``ValueError``.
  ``save_safetensors`` writes the same format (``SaveLatent``, the test and
  smoke-run checkpoints).
- LoRA bakes before conversion (``convert.bake_lora``; a stack of
  ``(lora, strength)`` pairs applies in order), as the reference bakes before it
  replicates (any_device_parallel.py:992-1004).
- Every loader builds its model on ``device`` (default ``cuda:0``).

Left out, with the work that needs them: the weight-streaming and planner helpers
(``params_nbytes``, ``pin_params_host``, ``carve_ranges``, ``segment_nbytes``,
``carve_stages``; ROADMAP Queue 1 items 6 and 8) and the Wan loaders (item 10),
whose ``load_wan_checkpoint`` raises.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import struct
import types
from collections.abc import Mapping
from typing import Any

import torch

from .api import DiffusionModel
from .convert import bake_lora, convert_flux_checkpoint
from .convert_unet import convert_sd_unet_checkpoint, strip_prefix
from .flux import FluxConfig, build_flux
from .unet import UNetConfig, build_unet

logger = logging.getLogger(__name__)

SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "F8_E4M3": torch.float8_e4m3fn, "F8_E5M2": torch.float8_e5m2,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}


def _read_header(f) -> tuple[dict, int]:
    """The JSON header of an open .safetensors file (``__metadata__`` dropped) and
    the file offset where the data begins."""
    raw = f.read(8)
    if len(raw) != 8:
        raise ValueError("not a safetensors file: shorter than its 8-byte header length")
    (n,) = struct.unpack("<Q", raw)
    text = f.read(n)
    if len(text) != n:
        raise ValueError(f"truncated safetensors header: {len(text)} of {n} bytes")
    header = json.loads(text)
    header.pop("__metadata__", None)
    return header, 8 + n


def _spec(key: str, entry: dict) -> tuple[torch.dtype, tuple[int, ...], int, int]:
    dtype = SAFETENSORS_DTYPES.get(entry["dtype"])
    if dtype is None:
        raise ValueError(f"{key}: unsupported safetensors dtype {entry['dtype']!r}")
    shape = tuple(int(d) for d in entry["shape"])
    begin, end = (int(o) for o in entry["data_offsets"])
    numel = 1
    for d in shape:
        numel *= d
    if end - begin != numel * torch.empty((), dtype=dtype).element_size():
        raise ValueError(f"{key}: {end - begin} bytes for shape {shape} of {entry['dtype']}")
    return dtype, shape, begin, end


def _read_tensors(path, keep=lambda key: True) -> dict[str, torch.Tensor]:
    out: dict[str, torch.Tensor] = {}
    with open(os.fspath(path), "rb") as f:
        header, start = _read_header(f)
        size = os.fstat(f.fileno()).st_size
        for key, entry in header.items():
            if not keep(key):
                continue
            dtype, shape, begin, end = _spec(key, entry)
            if start + end > size:
                raise ValueError(f"truncated safetensors file: {key} ends at byte "
                                 f"{start + end} of {size}")
            if end == begin:
                out[key] = torch.empty(shape, dtype=dtype)
                continue
            buf = bytearray(end - begin)
            f.seek(start + begin)
            if f.readinto(buf) != len(buf):
                raise ValueError(f"truncated safetensors file while reading {key}")
            out[key] = torch.frombuffer(buf, dtype=dtype).reshape(shape)
    return out


def load_safetensors(path: str | os.PathLike) -> dict[str, torch.Tensor]:
    """Every tensor of a .safetensors file, on the CPU, in its stored dtype."""
    return _read_tensors(path)


def peek_safetensors(path: str | os.PathLike) -> dict[str, Any]:
    """Key → ``SimpleNamespace(shape, dtype)`` for every tensor, from the header
    alone (no tensor data is read): enough for ``sniff_model_family``."""
    with open(os.fspath(path), "rb") as f:
        header, _ = _read_header(f)
    out = {}
    for key, entry in header.items():
        dtype, shape, _, _ = _spec(key, entry)
        out[key] = types.SimpleNamespace(shape=shape, dtype=dtype)
    return out


def load_safetensors_subset(path: str | os.PathLike, *prefixes: str) -> dict[str, torch.Tensor]:
    """Only the tensors whose keys start with one of ``prefixes`` (e.g. a bundled
    ``cond_stage_model.`` text tower); the rest of the file is never read."""
    return _read_tensors(path, lambda key: key.startswith(prefixes))


def save_safetensors(path: str | os.PathLike, tensors: Mapping[str, torch.Tensor]) -> None:
    """A .safetensors file of ``tensors``: the 8-byte little-endian header length,
    the JSON header (dtype, shape and byte range of each tensor, in key order,
    padded with spaces to 8 bytes), then each tensor's raw bytes, in its dtype."""
    names = {dt: name for name, dt in SAFETENSORS_DTYPES.items()}
    header, blobs, offset = {}, [], 0
    for key in sorted(tensors):
        t = torch.as_tensor(tensors[key]).detach().contiguous().cpu()
        if t.dtype not in names:
            raise ValueError(f"{key}: no safetensors dtype for {t.dtype}")
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b""
        header[key] = {"dtype": names[t.dtype], "shape": list(t.shape),
                       "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(os.fspath(path), "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in blobs:
            f.write(raw)


def _resolve_state_dict(src: Any) -> Mapping[str, Any]:
    """A path to a .safetensors file, or an in-memory ``{name: tensor}`` mapping."""
    if isinstance(src, (str, os.PathLike)):
        return load_safetensors(src)
    if isinstance(src, Mapping):
        return src
    raise TypeError(f"expected a path or state dict, got {type(src).__name__}")


def _maybe_bake(sd: Mapping, lora: Any, strength: float) -> Mapping:
    """Bake one LoRA, or a stack: ``lora`` may be a list of ``(lora, strength)``
    pairs, applied in order (a chain of LoraLoader nodes)."""
    if lora is None:
        return sd
    stack = lora if isinstance(lora, (list, tuple)) else [(lora, strength)]
    for item in stack:
        src_i, s_i = item if isinstance(item, (list, tuple)) else (item, strength)
        lora_sd = _resolve_state_dict(src_i)
        logger.info("baking LoRA (%d tensors, strength %.2f)", len(lora_sd), s_i)
        sd = bake_lora(sd, lora_sd, s_i)
    return sd


def load_flux_checkpoint(src: Any, cfg: FluxConfig, lora: Any = None,
                         lora_strength: float = 1.0, name: str = "flux",
                         device=None) -> DiffusionModel:
    """FLUX checkpoint (path or state dict, official BFL layout, fp8 blocks
    included) → DiffusionModel on ``device``. Each tensor is converted straight to
    its parameter's dtype on ``device`` and becomes the parameter, so the weights
    are held once."""
    from ..devices.discovery import default_device

    device = torch.device(device) if device is not None else default_device()
    sd = _maybe_bake(_resolve_state_dict(src), lora, lora_strength)
    return build_flux(cfg, name=name, device=device, assign=True,
                      state_dict=convert_flux_checkpoint(sd, cfg, device=device))


def load_sd_unet_checkpoint(src: Any, cfg: UNetConfig, lora: Any = None,
                            lora_strength: float = 1.0, name: str = "sd-unet",
                            device=None) -> DiffusionModel:
    """SD1.5/SDXL checkpoint → DiffusionModel: a full ComfyUI checkpoint (the
    ``model.diffusion_model.*`` subtree is selected) or a bare UNet dict."""
    sd = _maybe_bake(strip_prefix(_resolve_state_dict(src)), lora, lora_strength)
    return build_unet(cfg, name=name, device=device,
                      state_dict=convert_sd_unet_checkpoint(sd, cfg))


def load_controlnet_checkpoint(src: Any, cfg: UNetConfig | None = None,
                               name: str = "controlnet", device=None) -> DiffusionModel:
    """ControlNet checkpoint (ldm single-file layout, bare or under
    ``control_model.``, or the diffusers ``ControlNetModel`` layout, told by its
    ``controlnet_cond_embedding.*`` keys) → a ControlNet for ``apply_control``.
    With ``cfg=None`` the base family comes from the cross-attention context width
    (768 → sd15, 1024 → sd21, 2048 or a ``label_emb`` → sdxl)."""
    from . import sd15_config, sd21_config, sdxl_config
    from .controlnet import build_controlnet
    from .convert_unet import convert_controlnet_checkpoint, diffusers_controlnet_to_ldm

    sd = dict(_resolve_state_dict(src))
    if any(k.startswith("control_model.") for k in sd):
        sd = strip_prefix(sd, "control_model.")
    if any(k.startswith("controlnet_cond_embedding.") for k in sd):
        sd = diffusers_controlnet_to_ldm(sd)
    if cfg is None:
        key = next((k for k in sd if k.endswith("attn2.to_k.weight")
                    and k.startswith("input_blocks.")), None)
        ctx = int(sd[key].shape[1]) if key else 768
        if any(k.startswith("label_emb.") for k in sd) or ctx == 2048:
            cfg = sdxl_config()
        elif ctx == 1024:
            cfg = sd21_config()
        else:
            cfg = sd15_config()
    return build_controlnet(cfg, name=name, device=device,
                            state_dict=convert_controlnet_checkpoint(sd, cfg))


def sniff_model_family(state_dict: Mapping[str, Any]) -> str:
    """The model family id (the JAX nodes' ``_MODEL_FAMILIES`` vocabulary) from the
    checkpoint's key signatures; keys bare or under ``model.diffusion_model.``.
    Anything with a ``shape`` serves as a value (``peek_safetensors``' stubs)."""
    pfx = "model.diffusion_model."
    names = {k[len(pfx):] if k.startswith(pfx) else k: k for k in state_dict}

    def has(prefix: str) -> bool:
        return any(n.startswith(prefix) for n in names)

    def dim(name: str, axis: int) -> int | None:
        key = names.get(name)
        if key is None:
            return None
        shape = getattr(state_dict[key], "shape", None)
        return None if shape is None else int(shape[axis])

    def depth(prefix: str) -> int:
        return 1 + max(int(n.split(".")[1]) for n in names if n.startswith(prefix))

    if has("double_blocks."):
        if has("guidance_in."):
            return "flux-dev"
        # schnell runs the full 19 double blocks; the z-image proxy is shallow.
        return "flux-schnell" if depth("double_blocks.") >= 12 else "zimage-turbo"
    if has("joint_blocks."):
        if any(".x_block.attn2." in n for n in names):
            return "sd35-medium"  # dual-attention mmdit-x
        return "sd35-large" if depth("joint_blocks.") >= 38 else "sd3-medium"
    if has("blocks.0.self_attn.") or has("blocks.0.cross_attn."):
        width = dim("blocks.0.self_attn.q.weight", 0)
        return "wan-14b" if width is not None and width >= 5120 else "wan-1.3b"
    if has("input_blocks."):
        # 9 input channels (latent 4 + mask 1 + masked latent 4): an inpaint variant.
        inpaint = "-inpaint" if dim("input_blocks.0.0.weight", 1) == 9 else ""
        ctx = dim("input_blocks.1.1.transformer_blocks.0.attn2.to_k.weight", 1)
        if has("label_emb."):
            # SD2.1-unCLIP keeps SD2's layout (a 1024-wide transformer at
            # input_blocks.1); the SDXL refiner's first attention is 1280-wide.
            if ctx == 1024:
                return "sd21-unclip"
            first_attn = next((n for n in sorted(names)
                               if n.endswith("transformer_blocks.0.attn2.to_k.weight")
                               and n.startswith("input_blocks.")), None)
            if first_attn is not None and dim(first_attn, 1) == 1280:
                return "sdxl-refiner"
            return "sdxl" + inpaint
        if ctx == 768 and inpaint:
            return "sd15-inpaint"
        if ctx == 1024 and inpaint:
            return "sd21-inpaint"
        if inpaint:
            raise ValueError(
                f"9-channel (inpainting) checkpoint with an unrecognized context width {ctx} "
                "— supported inpaint families: sd15-inpaint, sd21-inpaint, sdxl-inpaint")
        if ctx == 1024:
            logger.warning(
                "SD2.x checkpoint sniffed as 'sd21' (eps-prediction). If this is a "
                "v-prediction model (e.g. the common 768-v checkpoint), pass family='sd21-v' "
                "or images will be garbage.")
            return "sd21"
        return "sd15"
    raise ValueError(
        "cannot sniff model family: no known diffusion-model key signature "
        "(double_blocks/joint_blocks/self_attn/input_blocks) in checkpoint")


def sniff_vae_config(state_dict: Mapping[str, Any]):
    """``flux_vae_config()`` for a 16-channel latent, ``sd_vae_config()`` for 4 (read
    off ``decoder.conv_in``, prefixed layouts handled). SD1.5 and SDXL VAEs have
    the same shapes but different scaling factors: pass ``sdxl_vae_config()``
    explicitly for SDXL (the 4-channel default warns)."""
    from .convert_vae import strip_vae_prefix
    from .vae import flux_vae_config, sd_vae_config

    sd = strip_vae_prefix(state_dict)
    if "decoder.conv_in.weight" not in sd:
        raise KeyError("decoder.conv_in.weight not found — not an AutoencoderKL dict")
    shape = tuple(sd["decoder.conv_in.weight"].shape)
    z_ch = shape[1] if len(shape) == 4 else shape[-1]
    if z_ch == 16:
        return flux_vae_config()
    logger.warning("4-channel VAE: defaulting to sd_vae_config() (scaling 0.18215); SDXL "
                   "VAEs are shape-identical but need sdxl_vae_config() (scaling 0.13025) "
                   "— pass cfg= explicitly for SDXL")
    return sd_vae_config()


def load_vae_checkpoint(src: Any, cfg=None, device=None):
    """AutoencoderKL checkpoint (a standalone vae/ae file, a full ComfyUI checkpoint's
    ``first_stage_model.*``, or a state dict) → VAE; ``cfg`` defaults through
    ``sniff_vae_config``."""
    from .convert_vae import convert_vae_checkpoint
    from .vae import build_vae

    sd = _resolve_state_dict(src)
    if cfg is None:
        cfg = sniff_vae_config(sd)
    return build_vae(cfg, device=device, state_dict=convert_vae_checkpoint(sd, cfg))


def load_clip_text_checkpoint(src: Any, cfg=None, open_clip: bool = False, device=None):
    """CLIP text tower → TextEncoder: the HF ``text_model.*`` layout (SD1.5, SDXL's
    first encoder, FLUX's clip_l), or with ``open_clip=True`` the OpenCLIP
    resblocks layout (SDXL's second encoder)."""
    from .convert_text import convert_clip_text_checkpoint, convert_open_clip_checkpoint
    from .text_encoders import build_clip_text, clip_l_config, open_clip_g_config

    sd = _resolve_state_dict(src)
    if cfg is None:
        cfg = open_clip_g_config() if open_clip else clip_l_config()
    convert = convert_open_clip_checkpoint if open_clip else convert_clip_text_checkpoint
    return build_clip_text(cfg, device=device, state_dict=convert(sd, cfg))


def load_t5_checkpoint(src: Any, cfg=None, device=None):
    """T5 encoder checkpoint (HF layout) → TextEncoder (FLUX's t5xxl)."""
    from .convert_text import convert_t5_checkpoint
    from .text_encoders import build_t5_encoder, t5_xxl_config

    cfg = cfg or t5_xxl_config()
    return build_t5_encoder(cfg, device=device,
                            state_dict=convert_t5_checkpoint(_resolve_state_dict(src), cfg))


def load_mmdit_checkpoint(src: Any, cfg, lora: Any = None, lora_strength: float = 1.0,
                          name: str = "mmdit", device=None) -> DiffusionModel:
    """SD3/SD3.5 MMDiT checkpoint (SAI/ComfyUI single file, bare or under
    ``model.diffusion_model.``) → DiffusionModel. The config's dual-attention
    layers and q/k norm are aligned to what the checkpoint holds (the converter
    stays strict on both)."""
    from .convert_mmdit import convert_mmdit_checkpoint, strip_mmdit_prefix
    from .mmdit import build_mmdit

    sd = _maybe_bake(strip_mmdit_prefix(_resolve_state_dict(src)), lora, lora_strength)
    attn2_layers = tuple(sorted(int(k.split(".")[1]) for k in sd
                                if k.startswith("joint_blocks.")
                                and k.endswith(".x_block.attn2.qkv.weight")))
    has_qk_norm = any(k.startswith("joint_blocks.") and k.endswith(".attn.ln_q.weight")
                      for k in sd)
    if attn2_layers != tuple(cfg.x_block_self_attn_layers) or has_qk_norm != cfg.qk_norm:
        logger.info("aligning MMDiT config to checkpoint: dual-attention layers %s, "
                    "qk_norm=%s", list(attn2_layers), has_qk_norm)
        cfg = dataclasses.replace(cfg, x_block_self_attn_layers=attn2_layers,
                                  qk_norm=has_qk_norm)
    return build_mmdit(cfg, name=name, device=device,
                       state_dict=convert_mmdit_checkpoint(sd, cfg))


def load_wan_checkpoint(*args, **kwargs):
    """The Wan family is not ported yet (``sniff_model_family`` names it)."""
    raise NotImplementedError("Wan checkpoints are not ported to PyTorch yet "
                              "(ROADMAP Queue 1 item 10, the other model families)")

