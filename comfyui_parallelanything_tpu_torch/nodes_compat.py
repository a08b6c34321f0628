"""Stock-ComfyUI node-name shims (counterpart of
``comfyui_parallelanything_tpu/nodes_compat.py``).

Workflows exported from a stock ComfyUI install name the builtin node classes
(``CheckpointLoaderSimple``, ``CLIPTextEncode``, ``KSampler``, ``VAEDecode``, …),
not this package's ``TPU*`` names. With these shims, merged into
``nodes.NODE_CLASS_MAPPINGS`` (native names win), such a graph runs unchanged on
the port's host. Each shim keeps the JAX shim's class name, ``INPUT_TYPES``,
``RETURN_TYPES`` and ``FUNCTION``. Most adapt a ``TPU*`` node: they rename stock
input keys (``latent_image`` → ``latent``, ``samples`` → ``latent``, ``pixels`` →
``image``), resolve bare file names against the ComfyUI directory layout and sniff
what stock nodes leave implicit (the model family, ``models.loader.
sniff_model_family``). The image, mask and latent operations run in torch where
their inputs live.

Where the work runs: every loader shim, ``LoadImage``, ``LoadImageMask``,
``LoadLatent``, ``SolidMask`` and the empty latents take the hidden ``device``
input the graph host fills (``host.run_workflow(device=...)``); called directly
they use ``default_device()``, which raises without a GPU. ``CLIPLoader`` keeps
stock's own ``device`` widget (``"cpu"`` loads the tower on the host), so its
hidden input is ``host_device``.

File resolution (the stand-ins for ComfyUI's folder_paths):

- ``PA_MODELS_DIR`` (default ``models``): ``checkpoints/``, ``clip/``,
  ``text_encoders/``, ``vae/``, ``loras/``, ``diffusion_models/``, ``unet/``,
  ``upscale_models/``, ``controlnet/`` and ``clip_vision/`` are searched as each
  loader needs, then the directory itself, then the bare name as a path.
- ``PA_INPUT_DIR`` (default ``input``): ``LoadImage`` names (``LoadLatent``: ``.``).
- ``PA_TOKENIZER_JSON``, or ``PA_CLIP_VOCAB`` + ``PA_CLIP_MERGES``: the tokenizer
  tables of CLIP towers read out of checkpoints (which carry no tokenizer data).
- ``PA_T5_TOKENIZER_JSON``: the T5/UMT5 tokenizer.

``LoraLoader`` bakes, re-bakes and stacks as the JAX shim does, and attaches the
serving tier's ``lora_delegate`` (``_lane_delegate``): the unpatched base and the
factors the bake recovers to, so a served LoRA prompt rides a lane of the base's
bucket.
"""

from __future__ import annotations

import copy
import dataclasses as dc
import math
import os

import torch
import torch.nn.functional as F

from .nodes import DEVICE_INPUT, SEED_MAX, _log, resolve_device

CATEGORY = "TPU-ParallelAnything/compat"


def _models_dir() -> str:
    return os.environ.get("PA_MODELS_DIR", "models")


def resolve_model_file(name: str, *subdirs: str) -> str:
    """A stock widget's bare file name → an existing path, searched through the
    ComfyUI folder layout; else the name itself (absolute and cwd-relative paths
    keep working)."""
    root = _models_dir()
    for sub in subdirs:
        cand = os.path.join(root, sub, name)
        if os.path.exists(cand):
            return cand
    cand = os.path.join(root, name)
    if os.path.exists(cand):
        return cand
    return name


def _clip_tokenizer(max_len: int = 77, pad_id: int | None = None):
    """The CLIP BPE tokenizer from the env-configured tables, or None (the error
    surfaces at encode time with instructions, not at load time)."""
    from .utils.tokenizer import CLIPBPETokenizer, load_tokenizer_json

    tok_json = os.environ.get("PA_TOKENIZER_JSON", "")
    vocab = os.environ.get("PA_CLIP_VOCAB", "")
    merges = os.environ.get("PA_CLIP_MERGES", "")
    if tok_json:
        return load_tokenizer_json(tok_json, max_len=max_len)
    if vocab and merges:
        return CLIPBPETokenizer.from_files(vocab, merges, max_len=max_len, pad_id=pad_id)
    return None


_TOKENIZER_HELP = (
    "checkpoints bundle text-encoder weights but never tokenizer tables; set "
    "PA_TOKENIZER_JSON (a tokenizer.json) or PA_CLIP_VOCAB + PA_CLIP_MERGES "
    "(vocab.json + merges.txt), or wire a TPUCLIPLoader node instead"
)


def _tokenizer_kwargs(encoder_type: str, what: str) -> dict:
    """``TPUCLIPLoader``'s tokenizer inputs from the env: ``tokenizer_json`` for
    T5/UMT5 (required), else ``tokenizer_json`` or ``vocab_path`` + ``merges_path``."""
    if encoder_type in ("t5", "umt5"):
        tok_json = os.environ.get("PA_T5_TOKENIZER_JSON", "")
        if not tok_json:
            raise ValueError(f"{what} needs PA_T5_TOKENIZER_JSON (no vocab/merges form "
                             "exists for T5 tokenizers)")
        return {"tokenizer_json": tok_json}
    tok_json = os.environ.get("PA_TOKENIZER_JSON", "")
    if tok_json:
        return {"tokenizer_json": tok_json}
    return {"vocab_path": os.environ.get("PA_CLIP_VOCAB", ""),
            "merges_path": os.environ.get("PA_CLIP_MERGES", "")}


def _batched(x) -> torch.Tensor:
    """An IMAGE as a (B, H, W, C) tensor (a lone (H, W, C) image gets a batch)."""
    x = torch.as_tensor(x)
    return x[None] if x.ndim == 3 else x


def _mask3(mask) -> torch.Tensor:
    """A MASK as an f32 (B, H, W) tensor."""
    m = torch.as_tensor(mask, dtype=torch.float32)
    return m[None] if m.ndim == 2 else m


# ---------------------------------------------------------------------------
# Loaders
# ---------------------------------------------------------------------------


class CheckpointLoaderSimple:
    """Stock loader: (ckpt_name) → (MODEL, CLIP, VAE). The family is sniffed off
    the checkpoint's keys; CLIP comes from the bundled ``cond_stage_model`` /
    ``conditioner`` towers of the SD families (SDXL gives the dual L+G wire)."""

    DESCRIPTION = "Stock-name checkpoint loader (family sniffed, bundled CLIP)."
    RETURN_TYPES = ("MODEL", "CLIP", "VAE")
    RETURN_NAMES = ("model", "clip", "vae")
    FUNCTION = "load"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"ckpt_name": ("STRING", {"default": ""})}, "hidden": DEVICE_INPUT}

    def load(self, ckpt_name: str, device=None):
        from .models.loader import peek_safetensors, sniff_model_family
        from .nodes import TPUCheckpointLoader

        dev = resolve_device(device)
        path = resolve_model_file(ckpt_name, "checkpoints")
        # Family sniffing reads the header only; the tensors are read once, below.
        family = sniff_model_family(peek_safetensors(path))
        model, vae = TPUCheckpointLoader().load(ckpt_path=path, family=family, device=dev)
        # LoraLoader re-bakes from this file (a LoRA applies to the checkpoint
        # layout before conversion).
        model.source = {"path": path, "family": family}
        # source_ckpt marks this wire as rebuildable from the checkpoint, so
        # LoraLoader's strength_clip never clobbers a wire from another loader.
        clip = {**self._bundled_clip(path, family, device=dev), "source_ckpt": path}
        return model, clip, vae

    @staticmethod
    def _te_filtered(loras, *prefixes: str):
        """Per-tower text-encoder LoRA sub-stacks: only keys under the given kohya
        tower prefixes (te1 = CLIP-L, te2 = OpenCLIP-G)."""
        from .models.loader import load_safetensors

        out = []
        for src, strength in loras or ():
            if strength == 0.0:
                continue
            sd = src if isinstance(src, dict) else load_safetensors(src)
            sub = {k: v for k, v in sd.items() if k.startswith(prefixes)}
            if sub:
                out.append((sub, strength))
        return out

    def _bundled_clip(self, path, family: str, te_loras=None, device=None):
        import hashlib

        from .models import bake_lora, load_clip_text_checkpoint, open_clip_g_config
        from .models.embed_cache import file_stamp
        from .models.loader import load_safetensors_subset

        def error_wire(msg: str):
            return {"encoder": None, "tokenizer": None, "type": "error", "tokenizer_error": msg}

        def stamp(*parts):
            """The embed cache's model key: the file's identity and the tower; a
            LoRA-baked tower falls back to the cache's per-object key (None)."""
            if te_loras:
                return None
            return hashlib.md5(repr((file_stamp(path),) + parts).encode()).hexdigest()

        def baked(tower, *prefixes):
            for sub, s in self._te_filtered(te_loras, *prefixes):
                tower = bake_lora(tower, sub, s)
            return tower

        def wire(enc, tok, key):
            return {"encoder": enc, "tokenizer": tok, "type": "clip", "model_key": key,
                    "tokenizer_error": None if tok else _TOKENIZER_HELP}

        try:
            if family in ("sd15", "sd21", "sd21-v", "sd21-unclip"):
                open_clip = family.startswith("sd21")
                cfg = None
                if open_clip:
                    from .models import open_clip_h_config

                    cfg = open_clip_h_config()
                tower = load_safetensors_subset(path, "cond_stage_model.")
                if not tower:
                    return error_wire("checkpoint has no bundled cond_stage_model tower; "
                                      "wire a TPUCLIPLoader node instead")
                tower = baked(tower, "lora_te_", "lora_te1_")
                enc = load_clip_text_checkpoint(tower, cfg=cfg, open_clip=open_clip,
                                                device=device)
                tok = _clip_tokenizer(max_len=enc.cfg.max_len, pad_id=0 if open_clip else None)
                return wire(enc, tok, stamp(family, "cond_stage_model"))
            if family == "sdxl-refiner":
                # One tower: OpenCLIP-G under conditioner.embedders.0.model.*.
                tower = load_safetensors_subset(path, "conditioner.embedders.0.")
                if not tower:
                    return error_wire("sdxl-refiner checkpoint has no bundled conditioner "
                                      "tower; wire TPUCLIPLoader type=open-clip-g instead")
                tower = baked(tower, "lora_te2_", "lora_te_")
                enc_g = load_clip_text_checkpoint(tower, cfg=open_clip_g_config(),
                                                  open_clip=True, device=device)
                tok_g = _clip_tokenizer(max_len=enc_g.cfg.max_len, pad_id=0)
                return wire(enc_g, tok_g, stamp(family, "conditioner.0"))
            if family == "sdxl":
                # embedders.0 = CLIP-L (HF layout), embedders.1 = OpenCLIP-G.
                towers = load_safetensors_subset(path, "conditioner.embedders.0.",
                                                 "conditioner.embedders.1.")
                sub_l = {k: v for k, v in towers.items()
                         if k.startswith("conditioner.embedders.0.")}
                sub_g = {k: v for k, v in towers.items()
                         if k.startswith("conditioner.embedders.1.")}
                if not sub_l or not sub_g:
                    return error_wire("sdxl checkpoint has no bundled conditioner towers; "
                                      "wire TPUCLIPLoader nodes instead")
                sub_l = baked(sub_l, "lora_te1_", "lora_te_")
                sub_g = baked(sub_g, "lora_te2_")
                enc_l = load_clip_text_checkpoint(sub_l, device=device)
                enc_g = load_clip_text_checkpoint(sub_g, cfg=open_clip_g_config(),
                                                  open_clip=True, device=device)
                tok_l = _clip_tokenizer(max_len=enc_l.cfg.max_len)
                tok_g = _clip_tokenizer(max_len=enc_g.cfg.max_len, pad_id=0)
                err = None if (tok_l and tok_g) else _TOKENIZER_HELP
                return {
                    "type": "sdxl-dual",
                    "l": {**wire(enc_l, tok_l, stamp(family, "embedders.0")),
                          "tokenizer_error": err},
                    "g": {**wire(enc_g, tok_g, stamp(family, "embedders.1")),
                          "tokenizer_error": err},
                    "tokenizer_error": err,
                }
            return error_wire(f"{family} checkpoints do not bundle text encoders; wire "
                              "TPUCLIPLoader (or the DualCLIPLoader shim) instead")
        except Exception as e:  # noqa: BLE001 - degrade to an encode-time error
            return error_wire(f"bundled text-encoder extraction failed: {e}")


def _clip_wire(path: str, encoder_type: str, what: str, device, **extra):
    from .nodes import TPUCLIPLoader

    kw = {**_tokenizer_kwargs(encoder_type, what), **extra}
    (wire,) = TPUCLIPLoader().load(path, encoder_type, device=device, **kw)
    return wire


class DualCLIPLoader:
    """Stock dual loader (FLUX/SDXL/SD3 workflows): two encoder files → one CLIP
    wire. ``type=flux`` pairs T5-XXL (context) with CLIP-L (pooled)."""

    DESCRIPTION = "Stock-name dual text-encoder loader (flux/sdxl/sd3 pairs)."
    RETURN_TYPES = ("CLIP",)
    RETURN_NAMES = ("clip",)
    FUNCTION = "load"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "clip_name1": ("STRING", {"default": ""}),
                "clip_name2": ("STRING", {"default": ""}),
                "type": (["flux", "sdxl", "sd3"], {"default": "flux"}),
            },
            "hidden": DEVICE_INPUT,
        }

    def load(self, clip_name1: str, clip_name2: str, type: str = "flux", device=None):
        dev = resolve_device(device)

        def clip_wire(name: str, encoder_type: str):
            path = resolve_model_file(name, "clip", "text_encoders")
            return _clip_wire(path, encoder_type, f"DualCLIPLoader {encoder_type} tower", dev)

        if type == "flux":
            # Stock order: name1 = t5xxl, name2 = clip_l. A "t5" in only the second
            # name corrects swapped wiring; otherwise the order is trusted.
            n1 = os.path.basename(clip_name1).lower()
            n2 = os.path.basename(clip_name2).lower()
            swapped = "t5" not in n1 and "t5" in n2
            t5_name = clip_name2 if swapped else clip_name1
            l_name = clip_name1 if swapped else clip_name2
            return ({"type": "flux-dual", "t5": clip_wire(t5_name, "t5"),
                     "l": clip_wire(l_name, "clip-l"), "tokenizer_error": None},)
        if type == "sdxl":
            return ({"type": "sdxl-dual", "l": clip_wire(clip_name1, "clip-l"),
                     "g": clip_wire(clip_name2, "open-clip-g"), "tokenizer_error": None},)
        # sd3: classify both files (name markers, then key signatures) and leave the
        # absent tower None (the encode zero-fills it); unclassifiable files take
        # the free CLIP slots in (clip_l, clip_g) order.
        kinds = [_classify_text_tower(n, resolve_model_file(n, "clip", "text_encoders"))
                 for n in (clip_name1, clip_name2)]
        if kinds[0] is not None and kinds[0] == kinds[1]:
            raise ValueError(f"DualCLIPLoader type=sd3 got two {kinds[0]} files "
                             f"({clip_name1!r} and {clip_name2!r}); it needs two DIFFERENT "
                             "towers of clip_l/clip_g/t5xxl")
        for slot in ("clip-l", "open-clip-g"):
            if slot not in kinds and None in kinds:
                kinds[kinds.index(None)] = slot
        wire_of = {"clip-l": "l", "open-clip-g": "g", "t5": "t5"}
        out = {"type": "sd3-triple", "l": None, "g": None, "t5": None, "tokenizer_error": None}
        for kind, name in zip(kinds, (clip_name1, clip_name2)):
            out[wire_of[kind]] = clip_wire(name, kind)
        return (out,)


class CLIPLoader:
    """Stock single-tower loader: (clip_name, type) → CLIP. The ``type`` menu names
    the family the tower serves; the architecture follows from it (and from a
    t5/umt5 marker in the file name). ``device="cpu"`` loads the tower on the
    host."""

    DESCRIPTION = "Stock-name single text-encoder loader."
    RETURN_TYPES = ("CLIP",)
    RETURN_NAMES = ("clip",)
    FUNCTION = "load"
    CATEGORY = CATEGORY

    _TYPE_TOWER = {
        "stable_diffusion": "clip-l",
        "sdxl": "clip-l",
        "sd3": "clip-l",
        "flux": "clip-l",
        "stable_cascade": "clip-l",
        "wan": "umt5",
        "ltxv": "t5",
        "pixart": "t5",
        "cosmos": "t5",
        "lumina2": "t5",
        "hunyuan_video": "clip-l",
    }

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "clip_name": ("STRING", {"default": ""}),
                "type": (sorted(cls._TYPE_TOWER), {"default": "stable_diffusion"}),
            },
            "optional": {"device": (["default", "cpu"], {"default": "default"})},
            "hidden": {"host_device": "DEVICE"},
        }

    def load(self, clip_name: str, type: str = "stable_diffusion", device: str = "default",
             host_device=None):
        tower = self._TYPE_TOWER.get(type)
        if tower is None:
            raise ValueError(f"CLIPLoader type {type!r} is not supported — one of "
                             f"{sorted(self._TYPE_TOWER)}")
        name = os.path.basename(clip_name).lower()
        if "umt5" in name:
            tower = "umt5"
        elif "t5" in name and tower != "umt5":
            tower = "t5"
        dev = torch.device("cpu") if device == "cpu" else resolve_device(host_device)
        path = resolve_model_file(clip_name, "clip", "text_encoders")
        # Stock T5 token budgets: Wan tokenizes umt5 at 512, the other T5 families
        # at 256.
        extra = {"max_len": 512 if type == "wan" else 256} if tower in ("t5", "umt5") else {}
        return (_clip_wire(path, tower, f"CLIPLoader type={type!r}", dev, **extra),)


def _classify_text_tower(name: str, path: str | None = None) -> str | None:
    """Which tower a text-encoder file holds: ``t5`` / ``open-clip-g`` /
    ``clip-l``, by file-name markers first, then by the safetensors key signature
    (the header only: ``peek_safetensors``)."""
    from .models.loader import peek_safetensors

    n = os.path.basename(name).lower()
    if "t5" in n:
        return "t5"
    if "clip_g" in n or "clipg" in n:
        return "open-clip-g"
    if "clip_l" in n or "clipl" in n:
        return "clip-l"
    if not path or not os.path.isfile(path):
        return None
    try:
        header = peek_safetensors(path)
    except Exception:  # noqa: BLE001 - not a readable safetensors file
        return None
    if any(k.startswith("encoder.block.") for k in header) or "shared.weight" in header:
        return "t5"
    # OpenCLIP layout: a top-level token_embedding.
    if "token_embedding.weight" in header:
        return "open-clip-g"
    for k, spec in header.items():
        if k.endswith("token_embedding.weight"):
            return "open-clip-g" if spec.shape[1] >= 1024 else "clip-l"
    return None


class TripleCLIPLoader:
    """Stock SD3 loader: clip_l + clip_g + t5xxl files → ONE CLIP wire with all
    three towers (encoded into SD3's (context, y)). Files are matched to towers by
    name markers, then by key signature."""

    DESCRIPTION = "Stock-name triple text-encoder loader (SD3: L + G + T5)."
    RETURN_TYPES = ("CLIP",)
    RETURN_NAMES = ("clip",)
    FUNCTION = "load"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "clip_name1": ("STRING", {"default": ""}),
                "clip_name2": ("STRING", {"default": ""}),
                "clip_name3": ("STRING", {"default": ""}),
            },
            "hidden": DEVICE_INPUT,
        }

    def load(self, clip_name1: str, clip_name2: str, clip_name3: str, device=None):
        dev = resolve_device(device)
        towers: dict[str, str] = {}
        for name in (clip_name1, clip_name2, clip_name3):
            path = resolve_model_file(name, "clip", "text_encoders")
            kind = _classify_text_tower(name, path)
            if kind is None:
                raise ValueError(f"TripleCLIPLoader cannot tell which tower {name!r} holds "
                                 "— name it with a clip_l/clip_g/t5 marker")
            if kind in towers:
                raise ValueError(f"TripleCLIPLoader got two {kind} files ({towers[kind]!r} "
                                 f"and {name!r}); it needs one each of clip_l/clip_g/t5")
            towers[kind] = path
        missing = {"clip-l", "open-clip-g", "t5"} - set(towers)
        if missing:
            got = {k: os.path.basename(v) for k, v in towers.items()}
            raise ValueError(f"TripleCLIPLoader is missing {sorted(missing)} towers "
                             f"(classified: {got})")
        # Stock SD3 tokenizes T5 at 77 tokens, the CLIP streams' budget (the default).
        return ({"type": "sd3-triple",
                 "l": _clip_wire(towers["clip-l"], "clip-l", "TripleCLIPLoader", dev),
                 "g": _clip_wire(towers["open-clip-g"], "open-clip-g", "TripleCLIPLoader", dev),
                 "t5": _clip_wire(towers["t5"], "t5", "TripleCLIPLoader t5 tower", dev),
                 "tokenizer_error": None},)


class VAELoader:
    """Stock external-VAE loader: (vae_name) → VAE, resolved through
    ``$PA_MODELS_DIR/vae``. The file's key layout picks the family: Wan's causal 3D
    video VAE (``encoder.downsamples``/``decoder.upsamples`` flat Sequentials), else
    the AutoencoderKL image families, sniffed by ``sniff_vae_config``."""

    DESCRIPTION = "Stock-name external VAE loader (image + WAN video layouts)."
    RETURN_TYPES = ("VAE",)
    RETURN_NAMES = ("vae",)
    FUNCTION = "load"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"vae_name": ("STRING", {"default": ""})}, "hidden": DEVICE_INPUT}

    def load(self, vae_name: str, device=None):
        from .models.loader import load_vae_checkpoint, load_wan_vae_checkpoint, peek_safetensors

        path = resolve_model_file(vae_name, "vae")
        if not os.path.isfile(path):
            raise ValueError(f"VAE file not found: {vae_name!r} (searched $PA_MODELS_DIR/vae "
                             "and the name as a path)")
        if any("decoder.upsamples." in k for k in peek_safetensors(path)):
            return (load_wan_vae_checkpoint(path, device=resolve_device(device)),)
        return (load_vae_checkpoint(path, device=resolve_device(device)),)


class UNETLoader:
    """Stock diffusion-model-only loader (FLUX templates): (unet_name, weight_dtype)
    → MODEL, the family sniffed like ``CheckpointLoaderSimple``. ``weight_dtype`` is
    accepted and ignored: the load path's dtype policy (bf16 compute, fp8 upcast on
    load) covers every menu entry."""

    DESCRIPTION = "Stock-name bare diffusion-model loader (family sniffed)."
    RETURN_TYPES = ("MODEL",)
    RETURN_NAMES = ("model",)
    FUNCTION = "load_unet"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "unet_name": ("STRING", {"default": ""}),
                "weight_dtype": (["default", "fp8_e4m3fn", "fp8_e4m3fn_fast", "fp8_e5m2"],
                                 {"default": "default"}),
            },
            "hidden": DEVICE_INPUT,
        }

    def load_unet(self, unet_name: str, weight_dtype: str = "default", device=None):
        from .models.loader import peek_safetensors, sniff_model_family
        from .nodes import TPUCheckpointLoader

        path = resolve_model_file(unet_name, "diffusion_models", "unet", "checkpoints")
        family = sniff_model_family(peek_safetensors(path))
        model, _ = TPUCheckpointLoader().load(ckpt_path=path, family=family, load_vae=False,
                                              device=resolve_device(device))
        model.source = {"path": path, "family": family}
        return (model,)


class unCLIPConditioning:  # noqa: N801 - stock node name
    """Stock unCLIP node: tags the conditioning with the CLIP image embeds and the
    noise-augmentation level; the sampler builds the adm vector from the tags
    (``models/unet.unclip_adm``). Chained nodes stack tags."""

    DESCRIPTION = "Stock-name unCLIP image conditioning (SD2.x-unCLIP)."
    RETURN_TYPES = ("CONDITIONING",)
    RETURN_NAMES = ("conditioning",)
    FUNCTION = "apply_adm"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "conditioning": ("CONDITIONING", {}),
                "clip_vision_output": ("CLIP_VISION_OUTPUT", {}),
                "strength": ("FLOAT", {"default": 1.0, "min": -10.0, "max": 10.0,
                                       "step": 0.01}),
                "noise_augmentation": ("FLOAT", {"default": 0.0, "min": 0.0, "max": 1.0,
                                                 "step": 0.01}),
            }
        }

    def apply_adm(self, conditioning, clip_vision_output, strength: float,
                  noise_augmentation: float):
        tag = {"embeds": clip_vision_output["image_embeds"], "strength": float(strength),
               "noise_augmentation": float(noise_augmentation)}
        return ({**conditioning, "unclip": tuple(conditioning.get("unclip", ())) + (tag,)},)


class LoraLoader:
    """Stock LoRA node: (MODEL, CLIP, lora_name, strengths) → (MODEL, CLIP). The
    LoRA bakes into the checkpoint layout before conversion, so the shim re-loads
    the tagged source checkpoint with it. Chained LoraLoaders stack: each appends
    ``(path, strength)`` to the source tag and the whole stack re-bakes in order.
    ``strength_clip`` bakes the LoRA's text-encoder deltas (kohya ``lora_te*``
    keys) into a CLIP wire that came from the same checkpoint's bundled towers."""

    DESCRIPTION = "Stock-name LoRA loader (re-bakes from the source checkpoint)."
    RETURN_TYPES = ("MODEL", "CLIP")
    RETURN_NAMES = ("model", "clip")
    FUNCTION = "load_lora"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "model": ("MODEL", {}),
                "clip": ("CLIP", {}),
                "lora_name": ("STRING", {"default": ""}),
                "strength_model": ("FLOAT", {"default": 1.0, "min": -4.0, "max": 4.0}),
                "strength_clip": ("FLOAT", {"default": 1.0, "min": -4.0, "max": 4.0}),
            },
            "hidden": DEVICE_INPUT,
        }

    def load_lora(self, model, clip, lora_name: str, strength_model: float = 1.0,
                  strength_clip: float = 1.0, device=None):
        from .nodes import TPUCheckpointLoader

        source = getattr(model, "source", None)
        if source is not None and source.get("merged"):
            raise ValueError("LoRA-after-merge is not supported: LoRA baking re-converts from "
                             "the source checkpoint file, and a merged model has none — apply "
                             "LoraLoader to each input model BEFORE ModelMergeSimple instead")
        if source is None or not source.get("path"):
            raise ValueError("LoraLoader needs a MODEL from CheckpointLoaderSimple (the "
                             "source-checkpoint tag); for TPUCheckpointLoader models pass "
                             "lora_path on the loader itself")
        lora = resolve_model_file(lora_name, "loras")
        if not lora_name or not os.path.isfile(lora):
            raise ValueError(f"LoRA file not found: {lora_name!r} (searched "
                             "$PA_MODELS_DIR/loras and the name as a path)")
        dev = resolve_device(device)
        model_stack = list(source.get("loras", ())) + [(lora, strength_model)]
        patched, _ = TPUCheckpointLoader().load(ckpt_path=source["path"],
                                                family=source["family"],
                                                lora_path=model_stack, load_vae=False,
                                                device=dev)
        clip_stack = list(source.get("te_loras", ())) + [(lora, strength_clip)]
        patched.source = {**source, "loras": model_stack, "te_loras": clip_stack}
        patched.lora_delegate = self._lane_delegate(model, patched)
        return patched, self._maybe_rebake_clip(clip, source, clip_stack, dev)

    @staticmethod
    def _lane_delegate(model, patched):
        """The serving twin of this bake: ``{"base", "factors"}`` when the whole bake
        recovers as low-rank factors against the unpatched base
        (``models/lora.factorize_bake``, by SVD of each changed tensor, which works on
        the converted layout's renamed leaves). The scheduler then buckets LoRA
        prompts on the base model and carries the factors per lane, while inline runs
        keep the bake. None (bake only) whenever any delta is not representable: a
        partial map would serve another model than the bake. A chained link resolves
        against the base-most model, so a LoRA stack is still one delegate."""
        from .models.lora import factorize_bake

        base = (getattr(model, "lora_delegate", None) or {}).get("base", model)
        base_module = getattr(base, "module", None)
        patched_module = getattr(patched, "module", None)
        if not isinstance(base_module, torch.nn.Module) \
                or not isinstance(patched_module, torch.nn.Module):
            return None
        factors = factorize_bake(base_module, patched_module)
        return {"base": base, "factors": factors} if factors else None

    @staticmethod
    def _maybe_rebake_clip(clip, source: dict, clip_stack: list, device):
        """The CLIP wire rebuilt with the text-encoder LoRA deltas baked, when there
        is anything to bake (te keys at a nonzero strength, read from the headers)
        and the wire came from this checkpoint's bundled towers; else ``clip``."""
        from .models.loader import load_safetensors, peek_safetensors

        te_prefixes = ("lora_te_", "lora_te1_", "lora_te2_")
        active = [(p, s) for p, s in clip_stack
                  if s != 0.0 and any(k.startswith(te_prefixes) for k in peek_safetensors(p))]
        if not active:
            return clip
        if not isinstance(clip, dict) or clip.get("source_ckpt") != source["path"]:
            _log().warning(
                "LoraLoader strength_clip: the CLIP wire did not come from this checkpoint's "
                "bundled towers (DualCLIPLoader/TPUCLIPLoader) — text-encoder LoRA deltas "
                "are NOT baked; bake them into the encoder files offline if needed")
            return clip
        loaded = [(load_safetensors(p), s) for p, s in active]
        rebuilt = CheckpointLoaderSimple()._bundled_clip(source["path"], source["family"],
                                                         te_loras=loaded, device=device)
        # Wire state added upstream (CLIPSetLastLayer's tag, source_ckpt) survives.
        extra = {k: v for k, v in clip.items()
                 if k not in rebuilt and k not in ("encoder", "tokenizer")}
        return {**rebuilt, **extra}


class LoraLoaderModelOnly:
    """Stock model-only LoRA link: ``LoraLoader`` at ``strength_clip`` 0, no CLIP."""

    DESCRIPTION = "Stock-name model-only LoRA loader."
    RETURN_TYPES = ("MODEL",)
    RETURN_NAMES = ("model",)
    FUNCTION = "load_lora_model_only"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "model": ("MODEL", {}),
                "lora_name": ("STRING", {"default": ""}),
                "strength_model": ("FLOAT", {"default": 1.0, "min": -4.0, "max": 4.0}),
            },
            "hidden": DEVICE_INPUT,
        }

    def load_lora_model_only(self, model, lora_name: str, strength_model: float = 1.0,
                             device=None):
        patched, _ = LoraLoader().load_lora(model, None, lora_name, strength_model,
                                            strength_clip=0.0, device=device)
        return (patched,)


class CLIPSetLastLayer:
    """Stock clip-skip node: tags the CLIP wire; the text encode honours the tag
    (-1 = final layer, -2 = penultimate)."""

    DESCRIPTION = "Stock-name clip-skip (tags the CLIP wire)."
    RETURN_TYPES = ("CLIP",)
    RETURN_NAMES = ("clip",)
    FUNCTION = "set_last_layer"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"clip": ("CLIP", {}),
                             "stop_at_clip_layer": ("INT", {"default": -1, "min": -24,
                                                            "max": -1})}}

    def set_last_layer(self, clip, stop_at_clip_layer: int):
        if stop_at_clip_layer not in (-1, -2):
            raise ValueError("only stop_at_clip_layer -1 (final) or -2 (penultimate) is "
                             f"supported, got {stop_at_clip_layer}")
        return ({**clip, "clip_skip": -stop_at_clip_layer},)


def _renamed(tpu_cls, rename: dict[str, str], *, name: str):
    """Adapter class factory: stock input keys → the ``TPU*`` node's keys."""

    class Shim:
        DESCRIPTION = f"Stock-name alias of {tpu_cls.__name__}."
        RETURN_TYPES = tpu_cls.RETURN_TYPES
        RETURN_NAMES = getattr(tpu_cls, "RETURN_NAMES", None)
        FUNCTION = "run"
        CATEGORY = CATEGORY

        @classmethod
        def INPUT_TYPES(cls):
            back = {v: k for k, v in rename.items()}
            return {section: {back.get(k, k): v for k, v in entries.items()}
                    for section, entries in tpu_cls.INPUT_TYPES().items()}

        def run(self, **kwargs):
            mapped = {rename.get(k, k): v for k, v in kwargs.items()}
            return getattr(tpu_cls(), tpu_cls.FUNCTION)(**mapped)

    Shim.__name__ = Shim.__qualname__ = name
    return Shim


class LoadImage:
    """Stock image loader: names resolve against ``$PA_INPUT_DIR``."""

    DESCRIPTION = "Stock-name alias of TPULoadImage (input-dir resolution)."
    RETURN_TYPES = ("IMAGE", "MASK")
    RETURN_NAMES = ("image", "mask")
    FUNCTION = "run"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"image": ("STRING", {"default": ""})}, "hidden": DEVICE_INPUT}

    def run(self, image: str, device=None):
        from .nodes import TPULoadImage

        cand = os.path.join(os.environ.get("PA_INPUT_DIR", "input"), image)
        return TPULoadImage().load(cand if os.path.exists(cand) else image, device=device)


class LatentUpscale:
    """Stock latent upscale to absolute pixel dims: the ``TPULatentUpscale`` scale
    factors follow from the wired latent, height and width independently. ``crop``
    is accepted and ignored (as in the JAX shim). "bicubic" and "bislerp" resize by
    ``ops.resize``'s cubic, which the native node's menu lacks (the JAX shim passes
    them on to it, which rejects them)."""

    DESCRIPTION = "Stock-name latent upscale (absolute dims → scale factor)."
    RETURN_TYPES = ("LATENT",)
    RETURN_NAMES = ("latent",)
    FUNCTION = "upscale"
    CATEGORY = CATEGORY

    _METHODS = {
        "nearest-exact": "nearest", "nearest": "nearest",
        "bilinear": "bilinear", "area": "bilinear",
        "bicubic": "cubic", "bislerp": "cubic",
    }

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "samples": ("LATENT", {}),
                "upscale_method": (list(cls._METHODS), {"default": "bilinear"}),
                "width": ("INT", {"default": 1024, "min": 16, "max": 16384}),
                "height": ("INT", {"default": 1024, "min": 16, "max": 16384}),
            },
            "optional": {"crop": ("STRING", {"default": "disabled"})},
        }

    def upscale(self, samples, upscale_method: str, width: int, height: int,
                crop: str = "disabled"):
        from .nodes import resize_latent

        h, w = samples["samples"].shape[-3], samples["samples"].shape[-2]
        # Stock dims are pixels; latents are 8× smaller.
        scale_h = max(height // 8, 2) / h
        scale_w = max(width // 8, 2) / w
        method = self._METHODS.get(upscale_method, "bilinear")
        return (resize_latent(samples, scale_h, scale_w, method),)


class _EmptyLatent16ch:
    """Stock EmptySD3LatentImage: 16-channel latents (SD3/FLUX)."""

    DESCRIPTION = "Stock-name 16-channel empty latent (SD3/FLUX)."
    RETURN_TYPES = ("LATENT",)
    RETURN_NAMES = ("latent",)
    FUNCTION = "generate"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "width": ("INT", {"default": 1024, "min": 16, "max": 16384}),
                "height": ("INT", {"default": 1024, "min": 16, "max": 16384}),
                "batch_size": ("INT", {"default": 1, "min": 1, "max": 4096}),
            },
            "hidden": DEVICE_INPUT,
        }

    def generate(self, width: int, height: int, batch_size: int = 1, device=None):
        from .nodes import TPUEmptyLatent

        return TPUEmptyLatent().generate(width=width, height=height, batch_size=batch_size,
                                         channels=16, device=device)


class UpscaleModelLoader:
    """Stock loader: model_name resolves via ``$PA_MODELS_DIR/upscale_models``."""

    DESCRIPTION = "Stock-name upscale-model loader (folder-layout resolution)."
    RETURN_TYPES = ("UPSCALE_MODEL",)
    RETURN_NAMES = ("upscale_model",)
    FUNCTION = "load_model"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"model_name": ("STRING", {"default": ""})}, "hidden": DEVICE_INPUT}

    def load_model(self, model_name: str, device=None):
        from .nodes import TPUUpscaleModelLoader

        path = resolve_model_file(model_name, "upscale_models")
        if not model_name or not os.path.isfile(path):
            raise ValueError(f"upscale model not found: {model_name!r} (searched "
                             "$PA_MODELS_DIR/upscale_models and the name as a path)")
        return TPUUpscaleModelLoader().load(ckpt_path=path, device=device)


class CLIPVisionLoader:
    """Stock loader: clip_name resolves via ``$PA_MODELS_DIR/clip_vision``; the tower
    (ViT-L/H/bigG) is sniffed off the checkpoint (``models/vision.py``)."""

    DESCRIPTION = "Stock-name CLIP vision loader (tower sniffed)."
    RETURN_TYPES = ("CLIP_VISION",)
    RETURN_NAMES = ("clip_vision",)
    FUNCTION = "load_clip"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"clip_name": ("STRING", {"default": ""})}, "hidden": DEVICE_INPUT}

    def load_clip(self, clip_name: str, device=None):
        from .models.vision import load_clip_vision_checkpoint

        path = resolve_model_file(clip_name, "clip_vision")
        if not clip_name or not os.path.isfile(path):
            raise ValueError(f"CLIP vision model not found: {clip_name!r} (searched "
                             "$PA_MODELS_DIR/clip_vision and the name as a path)")
        return ({"model": load_clip_vision_checkpoint(path, device=resolve_device(device))},)


class CLIPVisionEncode:
    """Stock encode: IMAGE → CLIP_VISION_OUTPUT (projected ``image_embeds``, the raw
    last and penultimate hidden states). Preprocessing is ``clip_preprocess``
    (bicubic short-side resize, centre crop, CLIP normalisation); ``crop="none"``
    squashes to the square instead."""

    DESCRIPTION = "Stock-name CLIP vision encode."
    RETURN_TYPES = ("CLIP_VISION_OUTPUT",)
    RETURN_NAMES = ("clip_vision_output",)
    FUNCTION = "encode"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {"clip_vision": ("CLIP_VISION", {}), "image": ("IMAGE", {})},
            "optional": {"crop": (["center", "none"], {"default": "center"})},
        }

    def encode(self, clip_vision, image, crop: str = "center"):
        from .models.vision import clip_preprocess

        model = clip_vision["model"]
        px = clip_preprocess(torch.as_tensor(image).to(model.device),
                             size=model.cfg.image_size, crop=(crop != "none"))
        embeds, last, penultimate = model(px)
        return ({"image_embeds": embeds, "last_hidden": last, "penultimate": penultimate},)


class WanImageToVideo:
    """Stock Wan i2v entry node: allocates the empty video latent and tags both
    conditionings with the i2v conditioning the sampler composes into the model
    (``nodes._model_with_control`` → ``models.wan.apply_i2v_conditioning``): a
    4-channel latent frame mask ‖ the VAE-encoded start frames (channel-concat, the
    Wan2.2 contract) and, when ``clip_vision_output`` is wired, the CLIP-vision
    penultimate states for the Wan2.1-style checkpoints' img_emb branch. The stock
    node's concat_latent_image / concat_mask / clip_vision_output keys collapse into
    the one ``i2v`` tag. The latent lies on the VAE's device."""

    DESCRIPTION = "Stock-name WAN image→video conditioning + empty latent."
    RETURN_TYPES = ("CONDITIONING", "CONDITIONING", "LATENT")
    RETURN_NAMES = ("positive", "negative", "latent")
    FUNCTION = "encode"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "positive": ("CONDITIONING", {}),
                "negative": ("CONDITIONING", {}),
                "vae": ("VAE", {}),
                "width": ("INT", {"default": 832, "min": 16, "max": 8192, "step": 16}),
                "height": ("INT", {"default": 480, "min": 16, "max": 8192, "step": 16}),
                "length": ("INT", {"default": 81, "min": 1, "max": 1024, "step": 4}),
                "batch_size": ("INT", {"default": 1, "min": 1, "max": 16}),
            },
            "optional": {
                "clip_vision_output": ("CLIP_VISION_OUTPUT", {}),
                "start_image": ("IMAGE", {}),
            },
        }

    def encode(self, positive, negative, vae, width: int, height: int, length: int,
               batch_size: int, start_image=None, clip_vision_output=None):
        from .models.vae import images_to_vae_input
        from .ops.resize import resize

        t_lat = vae.cfg.latent_frames(length)  # validates the 4k+1 schedule
        f = vae.spatial_factor
        zc = vae.cfg.z_channels
        dev = vae.device
        latent = {"samples": torch.zeros((batch_size, t_lat, height // f, width // f, zc),
                                         device=dev)}
        tag: dict = {}
        if start_image is not None:
            img = torch.as_tensor(start_image, device=dev).float()
            if img.ndim == 3:
                img = img[None]
            n = min(img.shape[0], length)
            img = img[:n]
            if tuple(img.shape[1:3]) != (height, width):
                img = resize(img, (n, height, width, img.shape[-1]), method="bilinear")
            clip = torch.cat([images_to_vae_input(img)[None],  # the frames of one clip
                              img.new_zeros((1, length - n, height, width, img.shape[-1]))],
                             dim=1)
            cond_latent = vae.encode(clip)
            h, w = cond_latent.shape[2], cond_latent.shape[3]
            # Frame mask: channel c of latent frame j marks the pixel frame it folds.
            # Frame 0 fills all 4 channels of latent frame 0 (the causal VAE's lone
            # first frame); latent frame j ≥ 1, channel c folds pixel 4(j-1)+1+c.
            mask = torch.zeros((1, t_lat, h, w, 4), device=dev)
            for j in range(t_lat):
                for c in range(4):
                    if (0 if j == 0 else 4 * (j - 1) + 1 + c) < n:
                        mask[:, j, :, :, c] = 1.0
            tag["cond"] = torch.cat([mask, cond_latent.float()], dim=-1)
        if clip_vision_output is not None:
            tag["clip_fea"] = clip_vision_output["penultimate"]
        if tag:
            positive = {**positive, "i2v": tag}
            negative = {**negative, "i2v": tag}
        return positive, negative, latent


class ControlNetLoader:
    """Stock loader: control_net_name resolves via ``$PA_MODELS_DIR/controlnet``."""

    DESCRIPTION = "Stock-name ControlNet loader (folder-layout resolution)."
    RETURN_TYPES = ("CONTROL_NET",)
    RETURN_NAMES = ("control_net",)
    FUNCTION = "load_controlnet"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"control_net_name": ("STRING", {"default": ""})},
                "hidden": DEVICE_INPUT}

    def load_controlnet(self, control_net_name: str, device=None):
        from .nodes import TPUControlNetLoader

        path = resolve_model_file(control_net_name, "controlnet")
        if not control_net_name or not os.path.isfile(path):
            raise ValueError(f"ControlNet file not found: {control_net_name!r} (searched "
                             "$PA_MODELS_DIR/controlnet and the name as a path)")
        return TPUControlNetLoader().load(ckpt_path=path, device=device)


class ControlNetApply:
    """Stock apply: (conditioning, control_net, image, strength); the control trunk
    composes into the MODEL at sampling, conditioning cond and uncond calls."""

    DESCRIPTION = "Stock-name ControlNet apply."
    RETURN_TYPES = ("CONDITIONING",)
    RETURN_NAMES = ("conditioning",)
    FUNCTION = "apply_controlnet"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "conditioning": ("CONDITIONING", {}),
                "control_net": ("CONTROL_NET", {}),
                "image": ("IMAGE", {}),
                "strength": ("FLOAT", {"default": 1.0, "min": 0.0, "max": 10.0, "step": 0.01}),
            }
        }

    def apply_controlnet(self, conditioning, control_net, image, strength: float = 1.0):
        from .nodes import TPUControlNetApply

        return TPUControlNetApply().apply(conditioning, control_net, image, strength)


class ControlNetApplyAdvanced:
    """Stock advanced apply → (positive, negative): the control tag rides the
    positive; the sampler composes it into the MODEL, so the negative's calls are
    conditioned identically."""

    DESCRIPTION = "Stock-name ControlNet apply (strength window)."
    RETURN_TYPES = ("CONDITIONING", "CONDITIONING")
    RETURN_NAMES = ("positive", "negative")
    FUNCTION = "apply_controlnet"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "positive": ("CONDITIONING", {}),
                "negative": ("CONDITIONING", {}),
                "control_net": ("CONTROL_NET", {}),
                "image": ("IMAGE", {}),
                "strength": ("FLOAT", {"default": 1.0, "min": 0.0, "max": 10.0, "step": 0.01}),
                "start_percent": ("FLOAT", {"default": 0.0, "min": 0.0, "max": 1.0,
                                            "step": 0.001}),
                "end_percent": ("FLOAT", {"default": 1.0, "min": 0.0, "max": 1.0,
                                          "step": 0.001}),
            }
        }

    def apply_controlnet(self, positive, negative, control_net, image, strength: float = 1.0,
                         start_percent: float = 0.0, end_percent: float = 1.0):
        from .nodes import TPUControlNetApply

        (tagged,) = TPUControlNetApply().apply(positive, control_net, image, strength,
                                               start_percent=start_percent,
                                               end_percent=end_percent)
        return tagged, negative


def _tag_all_entries(conditioning: dict, tag: dict) -> dict:
    """``tag`` on the primary cond and every combined extra (stock
    conditioning_set_values maps over every entry)."""
    out = {**conditioning, **tag}
    if conditioning.get("extras"):
        out["extras"] = tuple({**e, **tag} for e in conditioning["extras"])
    return out


def _repeat_to_batch(a: torch.Tensor, batch: int) -> torch.Tensor:
    """Stock repeat_to_batch_size: cycle (tile) then truncate."""
    if a.shape[0] == batch:
        return a
    reps = -(-batch // a.shape[0])
    return a.repeat(reps, *([1] * (a.ndim - 1)))[:batch]


# ---------------------------------------------------------------------------
# Image, mask and latent operations
# ---------------------------------------------------------------------------


class ImageCompositeMasked:
    """Stock masked paste: source over destination at (x, y), through an optional
    mask (1 = take the source): the inpaint post-step that pastes the regenerated
    region back into the original."""

    DESCRIPTION = "Stock-name masked image composite."
    RETURN_TYPES = ("IMAGE",)
    RETURN_NAMES = ("image",)
    FUNCTION = "composite"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "destination": ("IMAGE", {}),
                "source": ("IMAGE", {}),
                "x": ("INT", {"default": 0, "min": 0, "max": 16384}),
                "y": ("INT", {"default": 0, "min": 0, "max": 16384}),
                "resize_source": ("BOOLEAN", {"default": False}),
            },
            "optional": {"mask": ("MASK", {})},
        }

    def composite(self, destination, source, x: int, y: int, resize_source: bool = False,
                  mask=None):
        from .models.vae import normalize_mask
        from .ops.resize import resize

        dst = _batched(destination)
        src = _batched(source).to(dst.device)
        B, H, W, C = dst.shape
        if resize_source:
            src = resize(src, (src.shape[0], H, W, C), method="bilinear")
        src = _repeat_to_batch(src, B)
        # The mask is brought to the whole source's size first, then cropped with
        # the paste window (stock's order).
        if mask is None:
            m_full = torch.ones((1, *src.shape[1:3], 1), device=dst.device)
        else:
            m_full = _repeat_to_batch(
                normalize_mask(torch.as_tensor(mask).to(dst.device), tuple(src.shape[1:3])), B)
        h, w = min(src.shape[1], H - y), min(src.shape[2], W - x)
        if h <= 0 or w <= 0:
            return (dst,)
        src, m = src[:, :h, :w, :], m_full[:, :h, :w, :]
        region = dst[:, y:y + h, x:x + w, :]
        out = dst.clone()
        out[:, y:y + h, x:x + w, :] = src * m + region * (1.0 - m)
        return (out,)


class LatentComposite:
    """Stock latent paste: samples_from over samples_to at (x, y) pixels (// 8 to
    latent cells); ``feather`` ramps only the pasted edges inside the canvas."""

    DESCRIPTION = "Stock-name latent composite."
    RETURN_TYPES = ("LATENT",)
    RETURN_NAMES = ("latent",)
    FUNCTION = "composite"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "samples_to": ("LATENT", {}),
                "samples_from": ("LATENT", {}),
                "x": ("INT", {"default": 0, "min": 0, "max": 16384, "step": 8}),
                "y": ("INT", {"default": 0, "min": 0, "max": 16384, "step": 8}),
                "feather": ("INT", {"default": 0, "min": 0, "max": 16384, "step": 8}),
            }
        }

    def composite(self, samples_to, samples_from, x: int, y: int, feather: int = 0):
        dst = torch.as_tensor(samples_to["samples"])
        src = torch.as_tensor(samples_from["samples"]).to(dst.device)
        xl, yl, fl = x // 8, y // 8, feather // 8
        B, H, W, C = dst.shape
        h, w = min(src.shape[1], H - yl), min(src.shape[2], W - xl)
        if h <= 0 or w <= 0:
            return ({**samples_to},)
        src = _repeat_to_batch(src[:, :h, :w, :], B)
        m = torch.ones((h, w), device=dst.device)
        if fl > 0:
            def ramp(n):
                return torch.clamp(torch.arange(1, n + 1, dtype=torch.float32,
                                                device=dst.device) / fl, max=1.0)

            ones_h, ramp_h = torch.ones(h, device=dst.device), ramp(h)
            top = ramp_h if yl > 0 else ones_h
            bottom = ramp_h.flip(0) if yl + h < H else ones_h
            m = m * torch.minimum(top, bottom)[:, None]
            ones_w, ramp_w = torch.ones(w, device=dst.device), ramp(w)
            left = ramp_w if xl > 0 else ones_w
            right = ramp_w.flip(0) if xl + w < W else ones_w
            m = m * torch.minimum(left, right)[None, :]
        m = m[None, :, :, None]
        region = dst[:, yl:yl + h, xl:xl + w, :]
        out = dst.clone()
        out[:, yl:yl + h, xl:xl + w, :] = src * m + region * (1.0 - m)
        return ({**samples_to, "samples": out},)


class SaveAnimatedWEBP:
    """Stock video save: a (B|F, H, W, 3) image sequence → one animated WEBP under
    the output root (``TPUSaveImage``'s path rules)."""

    DESCRIPTION = "Stock-name animated WEBP save."
    RETURN_TYPES = ("STRING",)
    RETURN_NAMES = ("paths",)
    FUNCTION = "save_images"
    CATEGORY = CATEGORY
    OUTPUT_NODE = True

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "images": ("IMAGE", {}),
                "filename_prefix": ("STRING", {"default": "ComfyUI"}),
                "fps": ("FLOAT", {"default": 6.0, "min": 0.01, "max": 1000.0}),
                "lossless": ("BOOLEAN", {"default": True}),
                "quality": ("INT", {"default": 80, "min": 0, "max": 100}),
            }
        }

    def save_images(self, images, filename_prefix: str = "ComfyUI", fps: float = 6.0,
                    lossless: bool = True, quality: int = 80):
        import numpy as np
        from PIL import Image

        from .nodes import _host_array, resolve_save_target

        arr = _host_array(images)
        if arr.ndim == 3:
            arr = arr[None]
        if arr.ndim == 5:  # (B, F, H, W, 3): every clip's frames in order
            arr = arr.reshape((-1,) + arr.shape[2:])
        frames = [Image.fromarray((np.clip(f, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8))
                  for f in arr]
        target_dir, name, start = resolve_save_target(filename_prefix or "ComfyUI",
                                                      suffix="webp")
        path = os.path.join(target_dir, f"{name}_{start:05d}.webp")
        frames[0].save(path, save_all=True, append_images=frames[1:],
                       duration=max(1, int(round(1000.0 / fps))), loop=0, lossless=lossless,
                       quality=quality)
        return ((path,),)


class VAEEncodeForInpaint:
    """Stock soft-inpaint encode for 4-channel checkpoints: the masked pixels are
    blanked before encoding, the mask grows by ``grow_mask_by`` pixels (a k×k max
    window) and rides the latent as its ``noise_mask``."""

    DESCRIPTION = "Stock-name inpaint encode (masked latent + noise_mask)."
    RETURN_TYPES = ("LATENT",)
    RETURN_NAMES = ("latent",)
    FUNCTION = "encode"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "vae": ("VAE", {}),
                "pixels": ("IMAGE", {}),
                "mask": ("MASK", {}),
                "grow_mask_by": ("INT", {"default": 6, "min": 0, "max": 64}),
            }
        }

    def encode(self, vae, pixels, mask, grow_mask_by: int = 6):
        from .models.vae import images_to_vae_input, normalize_mask
        from .ops.resize import resize

        px = images_to_vae_input(torch.as_tensor(pixels))
        m = torch.round(torch.clamp(
            normalize_mask(torch.as_tensor(mask).to(px.device), tuple(px.shape[1:3])), 0.0, 1.0))
        # Blank with the rounded mask (0 is 0.5 gray in the VAE's [-1, 1] input);
        # the grown mask is only the noise_mask.
        latent = vae.encode(px * (1.0 - m), None)
        grown = m
        if grow_mask_by > 1:
            # A k×k max window at "SAME" padding: (k-1)//2 before, the rest after.
            k = int(grow_mask_by)
            lo = (k - 1) // 2
            g = F.pad(m.permute(0, 3, 1, 2), (lo, k - 1 - lo, lo, k - 1 - lo),
                      value=-math.inf)
            grown = F.max_pool2d(g, k, stride=1).permute(0, 2, 3, 1)
        lat_mask = resize(grown, (grown.shape[0], *latent.shape[1:3], 1), method="nearest")
        return ({"samples": latent, "noise_mask": lat_mask.to(latent.device)},)


class ImagePadForOutpaint:
    """Stock outpaint prep: the image padded by left/top/right/bottom pixels (edges
    replicated, a colour hint for the sampler) and the matching regenerate mask,
    feathered ``feathering`` pixels into the original along a quadratic ramp; no
    feather at all when it would cover most of the image."""

    DESCRIPTION = "Stock-name outpaint padding (padded image + feathered mask)."
    RETURN_TYPES = ("IMAGE", "MASK")
    RETURN_NAMES = ("image", "mask")
    FUNCTION = "expand_image"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "image": ("IMAGE", {}),
                "left": ("INT", {"default": 0, "min": 0, "max": 16384, "step": 8}),
                "top": ("INT", {"default": 0, "min": 0, "max": 16384, "step": 8}),
                "right": ("INT", {"default": 0, "min": 0, "max": 16384, "step": 8}),
                "bottom": ("INT", {"default": 0, "min": 0, "max": 16384, "step": 8}),
                "feathering": ("INT", {"default": 40, "min": 0, "max": 16384, "step": 1}),
            }
        }

    def expand_image(self, image, left: int, top: int, right: int, bottom: int,
                     feathering: int = 40):
        img = _batched(image)
        B, H, W, C = img.shape
        padded = F.pad(img.permute(0, 3, 1, 2), (left, right, top, bottom),
                       mode="replicate").permute(0, 2, 3, 1).contiguous()
        rows = torch.arange(H, dtype=torch.float32, device=img.device)
        cols = torch.arange(W, dtype=torch.float32, device=img.device)
        # Distance to the nearest padded edge of the original; unpadded sides do
        # not feather (infinite distance).
        d = torch.full((H, W), math.inf, device=img.device)
        if top:
            d = torch.minimum(d, rows[:, None])
        if bottom:
            d = torch.minimum(d, (H - 1 - rows)[:, None])
        if left:
            d = torch.minimum(d, cols[None, :])
        if right:
            d = torch.minimum(d, (W - 1 - cols)[None, :])
        if feathering > 0 and feathering * 2 < H and feathering * 2 < W:
            v = torch.clamp(1.0 - d / float(feathering), 0.0, 1.0)
            inner = v * v
        else:
            inner = torch.zeros((H, W), device=img.device)
        mask = F.pad(inner, (left, right, top, bottom), value=1.0)
        return padded, mask[None].expand(B, *mask.shape)


class ConditioningSetTimestepRange:
    """Stock timestep-range gate: a conditioning scoped to a sampling-progress
    window (0 = first step); effective on conds riding a Combine's ``extras``."""

    DESCRIPTION = "Stock-name conditioning timestep window."
    RETURN_TYPES = ("CONDITIONING",)
    RETURN_NAMES = ("conditioning",)
    FUNCTION = "set_range"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "conditioning": ("CONDITIONING", {}),
                "start": ("FLOAT", {"default": 0.0, "min": 0.0, "max": 1.0, "step": 0.001}),
                "end": ("FLOAT", {"default": 1.0, "min": 0.0, "max": 1.0, "step": 0.001}),
            }
        }

    def set_range(self, conditioning, start: float, end: float):
        return (_tag_all_entries(conditioning,
                                 {"timestep_range": (float(start), float(end))}),)


class ConditioningZeroOut:
    """Stock zero-out: the FLUX-workflow negative, every embedding zero."""

    DESCRIPTION = "Stock-name conditioning zero-out (FLUX negative)."
    RETURN_TYPES = ("CONDITIONING",)
    RETURN_NAMES = ("conditioning",)
    FUNCTION = "zero_out"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"conditioning": ("CONDITIONING", {})}}

    def zero_out(self, conditioning):
        out = dict(conditioning)
        for k in ("context", "penultimate", "pooled"):
            if out.get(k) is not None:
                out[k] = torch.zeros_like(out[k])
        if out.get("extras"):
            out["extras"] = tuple(
                {**e, **{k: torch.zeros_like(e[k]) for k in ("context", "pooled")
                         if e.get(k) is not None}}
                for e in out["extras"])
        return (out,)


class CLIPTextEncodeSDXL:
    """Stock SDXL encode: both prompts (text_g/text_l) through the dual towers with
    the full size/crop/target conditioning vector."""

    DESCRIPTION = "Stock-name SDXL dual-prompt text encode."
    RETURN_TYPES = ("CONDITIONING",)
    RETURN_NAMES = ("conditioning",)
    FUNCTION = "encode"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "clip": ("CLIP", {}),
                "width": ("INT", {"default": 1024, "min": 0, "max": 16384}),
                "height": ("INT", {"default": 1024, "min": 0, "max": 16384}),
                "crop_w": ("INT", {"default": 0, "min": 0, "max": 16384}),
                "crop_h": ("INT", {"default": 0, "min": 0, "max": 16384}),
                "target_width": ("INT", {"default": 1024, "min": 0, "max": 16384}),
                "target_height": ("INT", {"default": 1024, "min": 0, "max": 16384}),
                "text_g": ("STRING", {"default": "", "multiline": True}),
                "text_l": ("STRING", {"default": "", "multiline": True}),
            }
        }

    def encode(self, clip, width: int, height: int, crop_w: int, crop_h: int,
               target_width: int, target_height: int, text_g: str, text_l: str):
        from .models.text_encoders import sdxl_text_conditioning
        from .nodes import TPUTextEncode

        if clip.get("type") != "sdxl-dual":
            raise ValueError("CLIPTextEncodeSDXL needs the dual L+G CLIP wire "
                             "(CheckpointLoaderSimple on an SDXL checkpoint, or "
                             "DualCLIPLoader type=sdxl)")
        enc = TPUTextEncode()
        # A CLIPSetLastLayer tag as TPUTextEncode's sdxl-dual branch reads it: 0 is
        # the penultimate (SDXL's convention), a skip the skip-resolved streams.
        clip_skip = int(clip.get("clip_skip", 0))
        (cl,) = enc.encode(clip["l"], text_l, clip_skip)
        (cg,) = enc.encode(clip["g"], text_g, clip_skip)
        str_l = cl["penultimate"] if clip_skip == 0 else cl["context"]
        str_g = cg["penultimate"] if clip_skip == 0 else cg["context"]
        context, y = sdxl_text_conditioning(str_l, str_g, cg["pooled"], width=width,
                                            height=height, crop_x=crop_w, crop_y=crop_h,
                                            target_width=target_width,
                                            target_height=target_height)
        return ({"context": context, "penultimate": None, "pooled": y},)


class ConditioningCombine:
    """Stock combine: both conditionings apply. The second (and its extras) rides
    the first's ``extras``; the sampler blends the per-cond predictions
    area-weight-normalised."""

    DESCRIPTION = "Stock-name conditioning combine (both prompts apply)."
    RETURN_TYPES = ("CONDITIONING",)
    RETURN_NAMES = ("conditioning",)
    FUNCTION = "combine"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"conditioning_1": ("CONDITIONING", {}),
                             "conditioning_2": ("CONDITIONING", {})}}

    def combine(self, conditioning_1, conditioning_2):
        second = {k: v for k, v in conditioning_2.items() if k != "extras"}
        extras = (tuple(conditioning_1.get("extras", ())) + (second,)
                  + tuple(conditioning_2.get("extras", ())))
        return ({**conditioning_1, "extras": extras},)


class ConditioningSetArea:
    """Stock area conditioning: a prompt scoped to a box; widgets in pixels, the
    wire in latent units (// 8)."""

    DESCRIPTION = "Stock-name area conditioning (regional prompting)."
    RETURN_TYPES = ("CONDITIONING",)
    RETURN_NAMES = ("conditioning",)
    FUNCTION = "append"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "conditioning": ("CONDITIONING", {}),
                "width": ("INT", {"default": 64, "min": 8, "max": 16384, "step": 8}),
                "height": ("INT", {"default": 64, "min": 8, "max": 16384, "step": 8}),
                "x": ("INT", {"default": 0, "min": 0, "max": 16384, "step": 8}),
                "y": ("INT", {"default": 0, "min": 0, "max": 16384, "step": 8}),
                "strength": ("FLOAT", {"default": 1.0, "min": 0.0, "max": 10.0}),
            }
        }

    def append(self, conditioning, width: int, height: int, x: int, y: int,
               strength: float = 1.0):
        # Clears a fractional box: stock keeps one "area" key, the later node wins.
        return (_tag_all_entries(conditioning, {
            "area": (height // 8, width // 8, y // 8, x // 8), "area_pct": None,
            "strength": float(strength)}),)


class ConditioningAverage:
    """Stock average: ``to`` · s + ``from`` · (1 − s), token-wise over the overlap;
    ``to``'s trailing tokens survive and a shorter ``from`` is zero-padded."""

    DESCRIPTION = "Stock-name conditioning average (prompt blending)."
    RETURN_TYPES = ("CONDITIONING",)
    RETURN_NAMES = ("conditioning",)
    FUNCTION = "addWeighted"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "conditioning_to": ("CONDITIONING", {}),
                "conditioning_from": ("CONDITIONING", {}),
                "conditioning_to_strength": ("FLOAT", {"default": 1.0, "min": 0.0,
                                                       "max": 1.0}),
            }
        }

    def addWeighted(self, conditioning_to, conditioning_from,  # noqa: N802 - stock name
                    conditioning_to_strength: float):
        s = float(conditioning_to_strength)
        from_ctx = torch.as_tensor(conditioning_from["context"])
        p_from = conditioning_from.get("pooled")

        def blend_one(cond: dict) -> dict:
            to_ctx = torch.as_tensor(cond["context"])
            n = to_ctx.shape[1]
            f = from_ctx.to(to_ctx.device)
            if f.shape[1] < n:
                f = F.pad(f, (0, 0) * (f.ndim - 2) + (0, n - f.shape[1]))
            out = {**cond, "context": to_ctx * s + f[:, :n] * (1.0 - s)}
            p_to = cond.get("pooled")
            if p_to is not None and p_from is not None:
                out["pooled"] = p_to * s + torch.as_tensor(p_from).to(p_to.device) * (1.0 - s)
            return out

        out = blend_one(conditioning_to)
        if conditioning_to.get("extras"):
            out["extras"] = tuple(blend_one(e) for e in conditioning_to["extras"])
        return (out,)


# Stock upscale_method menu → ``ops.resize`` method. "area" has no counterpart;
# bilinear is the closest downscale (as in the JAX shim).
_STOCK_RESIZE = {
    "nearest-exact": "nearest",
    "bilinear": "bilinear",
    "area": "bilinear",
    "bicubic": "cubic",
    "lanczos": "lanczos3",
}


def _stock_resize(image, width: int, height: int, upscale_method: str,
                  crop: str = "disabled") -> torch.Tensor:
    """The stock ImageScale core: an optional centre crop to the target aspect, then
    the resize, clipped to [0, 1]."""
    from .ops.resize import resize

    method = _STOCK_RESIZE.get(upscale_method)
    if method is None:
        raise ValueError(f"upscale_method must be one of {sorted(_STOCK_RESIZE)}, "
                         f"got {upscale_method!r}")
    img = _batched(image)
    if crop == "center":
        b, h, w, c = img.shape
        aspect = width / height
        if w / h > aspect:  # too wide: crop columns
            new_w = max(1, round(h * aspect))
            x0 = (w - new_w) // 2
            img = img[:, :, x0:x0 + new_w, :]
        elif w / h < aspect:  # too tall: crop rows
            new_h = max(1, round(w / aspect))
            y0 = (h - new_h) // 2
            img = img[:, y0:y0 + new_h, :, :]
    elif crop != "disabled":
        raise ValueError(f"crop must be 'disabled' or 'center', got {crop!r}")
    out = resize(img, (img.shape[0], height, width, img.shape[-1]), method=method)
    return torch.clamp(out, 0.0, 1.0)


class ImageScale:
    """Stock image resize: exact width/height, the stock method menu and centre
    crop; a 0 dimension follows from the other at the source's aspect."""

    DESCRIPTION = "Stock-name image resize (method menu + center crop)."
    RETURN_TYPES = ("IMAGE",)
    RETURN_NAMES = ("image",)
    FUNCTION = "upscale"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "image": ("IMAGE", {}),
                "upscale_method": (sorted(_STOCK_RESIZE), {"default": "bilinear"}),
                "width": ("INT", {"default": 512, "min": 0, "max": 16384}),
                "height": ("INT", {"default": 512, "min": 0, "max": 16384}),
                "crop": (["disabled", "center"], {"default": "disabled"}),
            }
        }

    def upscale(self, image, upscale_method: str, width: int, height: int,
                crop: str = "disabled"):
        if width == 0 and height == 0:
            raise ValueError("ImageScale: width and height cannot both be 0")
        if width == 0 or height == 0:
            src_h, src_w = _batched(image).shape[1:3]
            if width == 0:
                width = max(1, round(height * src_w / src_h))
            else:
                height = max(1, round(width * src_h / src_w))
        return (_stock_resize(image, width, height, upscale_method, crop),)


class ImageScaleBy:
    """Stock relative image resize: a scale_by factor, no crop."""

    DESCRIPTION = "Stock-name relative image resize."
    RETURN_TYPES = ("IMAGE",)
    RETURN_NAMES = ("image",)
    FUNCTION = "upscale"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "image": ("IMAGE", {}),
                "upscale_method": (sorted(_STOCK_RESIZE), {"default": "bilinear"}),
                "scale_by": ("FLOAT", {"default": 1.0, "min": 0.01, "max": 8.0, "step": 0.01}),
            }
        }

    def upscale(self, image, upscale_method: str, scale_by: float):
        img = _batched(image)
        h = max(1, round(img.shape[1] * scale_by))
        w = max(1, round(img.shape[2] * scale_by))
        return (_stock_resize(img, w, h, upscale_method),)


class PreviewImage:
    """Stock preview: saved under ``<output_dir>/temp`` through ``TPUSaveImage``."""

    DESCRIPTION = "Stock-name image preview (saves to the temp subfolder)."
    RETURN_TYPES = ("STRING",)
    RETURN_NAMES = ("paths",)
    FUNCTION = "preview"
    CATEGORY = CATEGORY
    OUTPUT_NODE = True

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"images": ("IMAGE", {})}}

    def preview(self, images):
        from .nodes import TPUSaveImage

        return TPUSaveImage().save(images, filename_prefix="temp/preview")


class CLIPTextEncodeSDXLRefiner:
    """Stock refiner encode: one prompt through the OpenCLIP-G tower with the
    refiner's (size, crop, aesthetic score) vector; takes the sdxl-dual wire (its G
    tower) or a single G-tower wire."""

    DESCRIPTION = "Stock-name SDXL-refiner text encode (aesthetic score adm)."
    RETURN_TYPES = ("CONDITIONING",)
    RETURN_NAMES = ("conditioning",)
    FUNCTION = "encode"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "clip": ("CLIP", {}),
                "ascore": ("FLOAT", {"default": 6.0, "min": 0.0, "max": 1000.0}),
                "width": ("INT", {"default": 1024, "min": 0, "max": 16384}),
                "height": ("INT", {"default": 1024, "min": 0, "max": 16384}),
                "text": ("STRING", {"default": "", "multiline": True}),
            }
        }

    def encode(self, clip, ascore: float, width: int, height: int, text: str):
        from .models.text_encoders import sdxl_refiner_text_conditioning
        from .nodes import TPUTextEncode

        g_wire = clip["g"] if clip.get("type") == "sdxl-dual" else clip
        if g_wire.get("encoder") is None:
            raise ValueError("CLIPTextEncodeSDXLRefiner needs a G-tower CLIP wire (the "
                             "sdxl-dual wire from an SDXL checkpoint, or TPUCLIPLoader "
                             "type=open-clip-g)")
        clip_skip = int(clip.get("clip_skip", g_wire.get("clip_skip", 0)))
        (cg,) = TPUTextEncode().encode(g_wire, text, clip_skip)
        stream = cg["penultimate"] if clip_skip == 0 else cg["context"]
        context, y = sdxl_refiner_text_conditioning(stream, cg["pooled"], width=width,
                                                    height=height, ascore=float(ascore))
        return ({"context": context, "penultimate": None, "pooled": y},)


class ConditioningConcat:
    """Stock concat: ``conditioning_from``'s tokens appended to
    ``conditioning_to``'s (one longer prompt); ``to``'s other fields win."""

    DESCRIPTION = "Stock-name conditioning token concat."
    RETURN_TYPES = ("CONDITIONING",)
    RETURN_NAMES = ("conditioning",)
    FUNCTION = "concat"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"conditioning_to": ("CONDITIONING", {}),
                             "conditioning_from": ("CONDITIONING", {})}}

    def concat(self, conditioning_to, conditioning_from):
        to_ctx = conditioning_to.get("context")
        from_ctx = conditioning_from.get("context")
        if to_ctx is None or from_ctx is None:
            raise ValueError("ConditioningConcat needs text conditionings with a context "
                             "stream on both inputs")
        if to_ctx.shape[-1] != from_ctx.shape[-1]:
            raise ValueError(f"cannot concat conditionings of different widths "
                             f"({to_ctx.shape[-1]} vs {from_ctx.shape[-1]} — e.g. an SDXL "
                             "dual-tower cond with a plain CLIP-L one)")
        from_ctx = torch.as_tensor(from_ctx).to(to_ctx.device)
        if from_ctx.shape[0] != to_ctx.shape[0]:
            from_ctx = _repeat_to_batch(from_ctx, to_ctx.shape[0])
        return ({**conditioning_to, "context": torch.cat([to_ctx, from_ctx], dim=1)},)


class ImageInvert:
    DESCRIPTION = "Stock-name image invert (1 - pixels)."
    RETURN_TYPES = ("IMAGE",)
    RETURN_NAMES = ("image",)
    FUNCTION = "invert"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"image": ("IMAGE", {})}}

    def invert(self, image):
        return (1.0 - torch.as_tensor(image),)


class ImageBatch:
    """Stock batch join: the second image resized (bilinear) to the first's size
    when they differ, then both concatenated along the batch."""

    DESCRIPTION = "Stock-name image batch concat."
    RETURN_TYPES = ("IMAGE",)
    RETURN_NAMES = ("image",)
    FUNCTION = "batch"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"image1": ("IMAGE", {}), "image2": ("IMAGE", {})}}

    def batch(self, image1, image2):
        from .ops.resize import resize

        a = _batched(image1)
        b = _batched(image2).to(a.device)
        if b.shape[1:3] != a.shape[1:3]:
            b = resize(b, (b.shape[0], *a.shape[1:3], b.shape[-1]), method="bilinear")
        return (torch.cat([a, b], dim=0),)


class RepeatLatentBatch:
    DESCRIPTION = "Stock-name latent batch repeat."
    RETURN_TYPES = ("LATENT",)
    RETURN_NAMES = ("latent",)
    FUNCTION = "repeat"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"samples": ("LATENT", {}),
                             "amount": ("INT", {"default": 1, "min": 1, "max": 64})}}

    def repeat(self, samples, amount: int):
        lat = torch.as_tensor(samples["samples"])
        out = dict(samples)
        out["samples"] = lat.repeat(int(amount), *([1] * (lat.ndim - 1)))
        if samples.get("noise_mask") is not None:
            # The mask cycles up to the samples' batch first, then tiles with them.
            m = _repeat_to_batch(torch.as_tensor(samples["noise_mask"]), lat.shape[0])
            out["noise_mask"] = m.repeat(int(amount), *([1] * (m.ndim - 1)))
        return (out,)


class LatentFromBatch:
    DESCRIPTION = "Stock-name latent batch slice."
    RETURN_TYPES = ("LATENT",)
    RETURN_NAMES = ("latent",)
    FUNCTION = "frombatch"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"samples": ("LATENT", {}),
                             "batch_index": ("INT", {"default": 0, "min": 0, "max": 4095}),
                             "length": ("INT", {"default": 1, "min": 1, "max": 4096})}}

    def frombatch(self, samples, batch_index: int, length: int):
        lat = torch.as_tensor(samples["samples"])
        i = min(int(batch_index), lat.shape[0] - 1)
        n = min(int(length), lat.shape[0] - i)
        out = dict(samples)
        out["samples"] = lat[i:i + n]
        if samples.get("noise_mask") is not None:
            m = torch.as_tensor(samples["noise_mask"])
            if m.shape[0] > 1:
                # Cycled up to the samples' batch before the slice (stock's rule).
                out["noise_mask"] = _repeat_to_batch(m, lat.shape[0])[i:i + n]
        return (out,)


def _latent_spatial_map(samples_dict: dict, fn) -> dict:
    """``fn`` (a transform of the (..., H, W, C) spatial axes) applied to the latent
    samples and to its noise_mask, which shares their rank and layout."""
    out = dict(samples_dict)
    out["samples"] = fn(torch.as_tensor(samples_dict["samples"]))
    if samples_dict.get("noise_mask") is not None:
        out["noise_mask"] = fn(torch.as_tensor(samples_dict["noise_mask"]))
    return out


class LatentFlip:
    """Stock latent flip: "x-axis: vertically" mirrors rows (H), "y-axis:
    horizontally" columns (W); the noise_mask flips with the samples."""

    DESCRIPTION = "Stock-name latent flip (vertical/horizontal)."
    RETURN_TYPES = ("LATENT",)
    RETURN_NAMES = ("latent",)
    FUNCTION = "flip"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "samples": ("LATENT", {}),
            "flip_method": (["x-axis: vertically", "y-axis: horizontally"],
                            {"default": "x-axis: vertically"}),
        }}

    def flip(self, samples, flip_method: str):
        axis = -3 if flip_method.startswith("x") else -2
        return (_latent_spatial_map(samples, lambda a: torch.flip(a, dims=(axis,))),)


class LatentRotate:
    """Stock latent rotate: clockwise quarter-turns of the spatial plane; the
    noise_mask rotates with the samples."""

    DESCRIPTION = "Stock-name latent rotation (90° steps, clockwise)."
    RETURN_TYPES = ("LATENT",)
    RETURN_NAMES = ("latent",)
    FUNCTION = "rotate"
    CATEGORY = CATEGORY

    _TURNS = {"none": 0, "90 degrees": 1, "180 degrees": 2, "270 degrees": 3}

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"samples": ("LATENT", {}),
                             "rotation": (list(cls._TURNS), {"default": "none"})}}

    def rotate(self, samples, rotation: str):
        k = self._TURNS.get(rotation)
        if k is None:
            raise ValueError(f"rotation {rotation!r} is not one of {list(self._TURNS)}")
        if k == 0:
            return (samples,)
        return (_latent_spatial_map(samples, lambda a: torch.rot90(a, k=-k, dims=(-3, -2))),)


class LatentCrop:
    """Stock latent crop: a pixel-space window on the 8× latent grid; the origin
    clamps to (dim − 8) latent units and the slice truncates at the edge, so an
    oversized window yields a smaller latent (stock's rule)."""

    DESCRIPTION = "Stock-name latent crop (pixel coords, /8 latent grid)."
    RETURN_TYPES = ("LATENT",)
    RETURN_NAMES = ("latent",)
    FUNCTION = "crop"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "samples": ("LATENT", {}),
            "width": ("INT", {"default": 512, "min": 64, "max": 16384, "step": 8}),
            "height": ("INT", {"default": 512, "min": 64, "max": 16384, "step": 8}),
            "x": ("INT", {"default": 0, "min": 0, "max": 16384, "step": 8}),
            "y": ("INT", {"default": 0, "min": 0, "max": 16384, "step": 8}),
        }}

    def crop(self, samples, width: int, height: int, x: int, y: int):
        H, W = samples["samples"].shape[-3], samples["samples"].shape[-2]
        y0 = min(int(y) // 8, max(H - 8, 0))
        x0 = min(int(x) // 8, max(W - 8, 0))
        h, w = max(1, int(height) // 8), max(1, int(width) // 8)
        return (_latent_spatial_map(samples, lambda a: a[..., y0:y0 + h, x0:x0 + w, :]),)


class SaveLatent:
    """Stock latent save: a safetensors file (``models.loader.save_safetensors``)
    holding ``latent_tensor`` and the ``latent_format_version_0`` marker. The file
    keeps the stock channels-first layout (NCHW, NCTHW for video), so dumps
    interchange with a stock host: the port's channels-last axes move at the file
    boundary. Saved under ``$PA_OUTPUT_DIR`` by ``SaveImage``'s counter rules."""

    DESCRIPTION = "Stock-name latent save (safetensors)."
    RETURN_TYPES = ()
    FUNCTION = "save"
    CATEGORY = CATEGORY
    OUTPUT_NODE = True

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"samples": ("LATENT", {}),
                             "filename_prefix": ("STRING", {"default": "latents/ComfyUI"})}}

    def save(self, samples, filename_prefix: str = "latents/ComfyUI"):
        from .models.loader import save_safetensors
        from .nodes import resolve_save_target

        target_dir, name, idx = resolve_save_target(filename_prefix, suffix="latent")
        path = os.path.join(target_dir, f"{name}_{idx:05}.latent")
        arr = torch.movedim(torch.as_tensor(samples["samples"]).float().cpu(), -1, 1)
        save_safetensors(path, {"latent_tensor": arr,
                                "latent_format_version_0": torch.zeros((0,))})
        return {"ui": {"latents": [os.path.basename(path)]}}


class LoadLatent:
    """Stock latent load: a ``SaveLatent`` file from ``$PA_INPUT_DIR``, channels-first
    in the file, channels-last on the run's device. A file without the
    ``latent_format_version_0`` marker is a legacy dump stored pre-scaled: it is
    multiplied by 1/0.18215."""

    DESCRIPTION = "Stock-name latent load (safetensors)."
    RETURN_TYPES = ("LATENT",)
    RETURN_NAMES = ("latent",)
    FUNCTION = "load"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"latent": ("STRING", {"default": ""})}, "hidden": DEVICE_INPUT}

    def load(self, latent: str, device=None):
        from .models.loader import load_safetensors

        path = latent
        if not os.path.isabs(path):
            path = os.path.join(os.environ.get("PA_INPUT_DIR", "."), path)
        if not os.path.isfile(path):
            raise ValueError(f"latent file not found: {path}")
        sd = load_safetensors(path)
        if "latent_tensor" not in sd:
            raise ValueError(f"{path} is not a saved latent (no latent_tensor key)")
        arr = torch.movedim(sd["latent_tensor"].float(), 1, -1)
        if "latent_format_version_0" not in sd:
            arr = arr * (1.0 / 0.18215)
        return ({"samples": arr.contiguous().to(resolve_device(device))},)


class SolidMask:
    DESCRIPTION = "Stock-name constant mask."
    RETURN_TYPES = ("MASK",)
    RETURN_NAMES = ("mask",)
    FUNCTION = "solid"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "value": ("FLOAT", {"default": 1.0, "min": 0.0, "max": 1.0}),
            "width": ("INT", {"default": 512, "min": 1, "max": 16384}),
            "height": ("INT", {"default": 512, "min": 1, "max": 16384}),
        }, "hidden": DEVICE_INPUT}

    def solid(self, value: float, width: int, height: int, device=None):
        return (torch.full((1, int(height), int(width)), float(value),
                           device=resolve_device(device)),)


class InvertMask:
    DESCRIPTION = "Stock-name mask invert."
    RETURN_TYPES = ("MASK",)
    RETURN_NAMES = ("mask",)
    FUNCTION = "invert"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"mask": ("MASK", {})}}

    def invert(self, mask):
        return (1.0 - torch.as_tensor(mask, dtype=torch.float32),)


class ImageToMask:
    DESCRIPTION = "Stock-name channel extract (image → mask)."
    RETURN_TYPES = ("MASK",)
    RETURN_NAMES = ("mask",)
    FUNCTION = "image_to_mask"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"image": ("IMAGE", {}),
                             "channel": (["red", "green", "blue", "alpha"],
                                         {"default": "red"})}}

    def image_to_mask(self, image, channel: str = "red"):
        img = _batched(image)
        idx = {"red": 0, "green": 1, "blue": 2, "alpha": 3}[channel]
        if idx >= img.shape[-1]:
            # A 3-channel image has no alpha: fully opaque.
            return (torch.ones(img.shape[:3], device=img.device),)
        return (img[..., idx].float(),)


class MaskToImage:
    DESCRIPTION = "Stock-name mask → grayscale image."
    RETURN_TYPES = ("IMAGE",)
    RETURN_NAMES = ("image",)
    FUNCTION = "mask_to_image"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"mask": ("MASK", {})}}

    def mask_to_image(self, mask):
        m = _mask3(mask)
        if m.ndim == 4:
            m = m[..., 0]
        return (m[..., None].repeat(1, 1, 1, 3),)


class GrowMask:
    """Stock grow/shrink: |expand| steps of a 3×3 max (grow) or min (shrink) window;
    ``tapered_corners`` leaves out the diagonal neighbours."""

    DESCRIPTION = "Stock-name mask dilate/erode."
    RETURN_TYPES = ("MASK",)
    RETURN_NAMES = ("mask",)
    FUNCTION = "expand_mask"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "mask": ("MASK", {}),
            "expand": ("INT", {"default": 0, "min": -16384, "max": 16384}),
            "tapered_corners": ("BOOLEAN", {"default": True}),
        }}

    def expand_mask(self, mask, expand: int, tapered_corners: bool = True):
        m = _mask3(mask)
        grow = expand > 0
        H, W = m.shape[1], m.shape[2]
        offs = [(-1, 0), (1, 0), (0, -1), (0, 1)]
        if not tapered_corners:
            offs += [(-1, -1), (-1, 1), (1, -1), (1, 1)]
        for _ in range(min(abs(int(expand)), max(H, W))):
            padded = F.pad(m, (1, 1, 1, 1), value=0.0 if grow else 1.0)
            shifts = torch.stack([m] + [padded[:, 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
                                        for dy, dx in offs])
            m = shifts.amax(dim=0) if grow else shifts.amin(dim=0)
        return (m,)


class FeatherMask:
    """Stock feather: a linear ramp to 0 over the given depth from each edge."""

    DESCRIPTION = "Stock-name mask edge feather."
    RETURN_TYPES = ("MASK",)
    RETURN_NAMES = ("mask",)
    FUNCTION = "feather"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "mask": ("MASK", {}),
            "left": ("INT", {"default": 0, "min": 0, "max": 16384}),
            "top": ("INT", {"default": 0, "min": 0, "max": 16384}),
            "right": ("INT", {"default": 0, "min": 0, "max": 16384}),
            "bottom": ("INT", {"default": 0, "min": 0, "max": 16384}),
        }}

    def feather(self, mask, left: int, top: int, right: int, bottom: int):
        m = _mask3(mask)
        _, H, W = m.shape
        rows = torch.arange(H, dtype=torch.float32, device=m.device)[:, None]
        cols = torch.arange(W, dtype=torch.float32, device=m.device)[None, :]
        scale = torch.ones((H, W), device=m.device)
        if top:
            scale = scale * torch.clamp((rows + 1) / top, 0, 1)
        if bottom:
            scale = scale * torch.clamp((H - rows) / bottom, 0, 1)
        if left:
            scale = scale * torch.clamp((cols + 1) / left, 0, 1)
        if right:
            scale = scale * torch.clamp((W - cols) / right, 0, 1)
        return (m * scale[None],)


class MaskComposite:
    """Stock mask composite: ``source`` onto ``destination`` at (x, y) under the
    chosen operation (multiply/add/subtract/and/or/xor), clipped to [0, 1]."""

    DESCRIPTION = "Stock-name mask composite."
    RETURN_TYPES = ("MASK",)
    RETURN_NAMES = ("mask",)
    FUNCTION = "combine"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "destination": ("MASK", {}),
            "source": ("MASK", {}),
            "x": ("INT", {"default": 0, "min": 0, "max": 16384}),
            "y": ("INT", {"default": 0, "min": 0, "max": 16384}),
            "operation": (["multiply", "add", "subtract", "and", "or", "xor"],
                          {"default": "multiply"}),
        }}

    def combine(self, destination, source, x: int, y: int, operation: str = "multiply"):
        dst = _mask3(destination)
        src = _mask3(source).to(dst.device)
        _, H, W = dst.shape
        h = min(src.shape[1], H - min(int(y), H))
        w = min(src.shape[2], W - min(int(x), W))
        if h <= 0 or w <= 0:
            return (dst,)
        src = _repeat_to_batch(src, dst.shape[0])[:, :h, :w]
        win = dst[:, y:y + h, x:x + w]
        ops = {
            "multiply": lambda: win * src,
            "add": lambda: win + src,
            "subtract": lambda: win - src,
            "and": lambda: torch.round(win) * torch.round(src),
            "or": lambda: torch.clamp(torch.round(win) + torch.round(src), 0, 1),
            "xor": lambda: torch.abs(torch.round(win) - torch.round(src)),
        }
        out = dst.clone()
        out[:, y:y + h, x:x + w] = torch.clamp(ops[operation](), 0.0, 1.0)
        return (out,)


class LoadImageMask:
    """Stock mask load: one channel of an input-directory image as a MASK (alpha
    inverted: stock's 1 − alpha regenerate convention)."""

    DESCRIPTION = "Stock-name image-channel mask loader."
    RETURN_TYPES = ("MASK",)
    RETURN_NAMES = ("mask",)
    FUNCTION = "load_image"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"image": ("STRING", {"default": ""}),
                             "channel": (["alpha", "red", "green", "blue"],
                                         {"default": "alpha"})},
                "hidden": DEVICE_INPUT}

    def load_image(self, image: str, channel: str = "alpha", device=None):
        px, alpha = LoadImage().run(image, device=device)
        if channel == "alpha":
            return (alpha,)  # LoadImage's MASK is already 1 − alpha
        return (px[..., {"red": 0, "green": 1, "blue": 2}[channel]].float(),)


class CLIPTextEncodeFlux:
    """Stock FLUX encode: separate prompts per tower (clip_l → pooled, t5xxl →
    context) and the distilled-guidance tag."""

    DESCRIPTION = "Stock-name FLUX dual-prompt encode with guidance tag."
    RETURN_TYPES = ("CONDITIONING",)
    RETURN_NAMES = ("conditioning",)
    FUNCTION = "encode"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "clip": ("CLIP", {}),
            "clip_l": ("STRING", {"default": "", "multiline": True}),
            "t5xxl": ("STRING", {"default": "", "multiline": True}),
            "guidance": ("FLOAT", {"default": 3.5, "min": 0.0, "max": 100.0}),
        }}

    def encode(self, clip, clip_l: str, t5xxl: str, guidance: float = 3.5):
        from .nodes import TPUFluxGuidance, TPUTextEncode

        if clip.get("type") != "flux-dual":
            raise ValueError("CLIPTextEncodeFlux needs the dual T5+CLIP-L wire "
                             "(DualCLIPLoader type=flux)")
        clip_skip = int(clip.get("clip_skip", 0))
        enc = TPUTextEncode()
        (ct5,) = enc.encode(clip["t5"], t5xxl, clip_skip)
        (cl,) = enc.encode(clip["l"], clip_l, clip_skip)
        cond = {"context": ct5["context"], "penultimate": None, "pooled": cl["pooled"]}
        return TPUFluxGuidance().append(cond, float(guidance))


class ConditioningSetAreaPercentage:
    """Stock fractional SetArea: the box as fractions of the latent frame."""

    DESCRIPTION = "Stock-name fractional area conditioning."
    RETURN_TYPES = ("CONDITIONING",)
    RETURN_NAMES = ("conditioning",)
    FUNCTION = "append"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "conditioning": ("CONDITIONING", {}),
            "width": ("FLOAT", {"default": 1.0, "min": 0.0, "max": 1.0, "step": 0.01}),
            "height": ("FLOAT", {"default": 1.0, "min": 0.0, "max": 1.0, "step": 0.01}),
            "x": ("FLOAT", {"default": 0.0, "min": 0.0, "max": 1.0, "step": 0.01}),
            "y": ("FLOAT", {"default": 0.0, "min": 0.0, "max": 1.0, "step": 0.01}),
            "strength": ("FLOAT", {"default": 1.0, "min": 0.0, "max": 10.0}),
        }}

    def append(self, conditioning, width: float, height: float, x: float, y: float,
               strength: float = 1.0):
        # Stock keeps both forms under one key (the later node wins): clear the other.
        return (_tag_all_entries(conditioning, {
            "area_pct": (float(height), float(width), float(y), float(x)), "area": None,
            "strength": float(strength)}),)


class ImageScaleToTotalPixels:
    """Stock megapixel normalise: resize to ``megapixels`` total, aspect kept."""

    DESCRIPTION = "Stock-name scale-to-megapixels."
    RETURN_TYPES = ("IMAGE",)
    RETURN_NAMES = ("image",)
    FUNCTION = "upscale"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "image": ("IMAGE", {}),
            "upscale_method": (list(_STOCK_RESIZE), {"default": "bilinear"}),
            "megapixels": ("FLOAT", {"default": 1.0, "min": 0.01, "max": 16.0, "step": 0.01}),
        }}

    def upscale(self, image, upscale_method: str, megapixels: float):
        img = _batched(image)
        _, H, W, _ = img.shape
        scale = (float(megapixels) * 1024 * 1024 / (H * W)) ** 0.5
        nh, nw = max(1, round(H * scale)), max(1, round(W * scale))
        return (_stock_resize(img, nw, nh, upscale_method),)


def _rebuilt(model, cfg, state: dict, **fields):
    """A new ``DiffusionModel`` of ``model``'s module class, built for ``cfg`` on the
    meta device and given ``state``'s tensors as its parameters (no copies), with
    ``fields`` replaced."""
    with torch.device("meta"):
        module = type(model.module)(cfg)
    module.load_state_dict(state, assign=True)
    return dc.replace(model, module=module.eval(), **fields)


class ModelMergeSimple:
    """Stock weighted merge: ``ratio`` · model1 + (1 − ratio) · model2, tensor by
    tensor; both models must share the family and widths. The merged model has no
    source file, so its ``source`` tag says so (``LoraLoader`` names the cause)."""

    DESCRIPTION = "Stock-name weighted model merge."
    RETURN_TYPES = ("MODEL",)
    RETURN_NAMES = ("model",)
    FUNCTION = "merge"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "model1": ("MODEL", {}),
            "model2": ("MODEL", {}),
            "ratio": ("FLOAT", {"default": 1.0, "min": 0.0, "max": 1.0, "step": 0.01}),
        }}

    def merge(self, model1, model2, ratio: float):
        from .models.api import DiffusionModel

        if not (isinstance(model1, DiffusionModel) and isinstance(model2, DiffusionModel)):
            raise ValueError("ModelMergeSimple needs unwrapped MODELs; apply it before "
                             "ParallelAnything")
        a, b = model1.module.state_dict(), model2.module.state_dict()
        if type(model1.module) is not type(model2.module) or set(a) != set(b):
            raise ValueError("models cannot merge — different families/topologies")
        r = float(ratio)
        merged = {}
        for k, va in a.items():
            vb = b[k]
            if va.shape != vb.shape:
                raise ValueError(f"models cannot merge — different families/topologies "
                                 f"(leaf shapes differ: {tuple(va.shape)} vs {tuple(vb.shape)})")
            merged[k] = va * r + vb.to(va.device) * (1.0 - r)
        return (_rebuilt(model1, model1.module.cfg, merged, source={"merged": True},
                         name=f"{model1.name}+merge"),)


class ImageCrop:
    DESCRIPTION = "Stock-name image crop."
    RETURN_TYPES = ("IMAGE",)
    RETURN_NAMES = ("image",)
    FUNCTION = "crop"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "image": ("IMAGE", {}),
            "width": ("INT", {"default": 512, "min": 1, "max": 16384}),
            "height": ("INT", {"default": 512, "min": 1, "max": 16384}),
            "x": ("INT", {"default": 0, "min": 0, "max": 16384}),
            "y": ("INT", {"default": 0, "min": 0, "max": 16384}),
        }}

    def crop(self, image, width: int, height: int, x: int, y: int):
        img = _batched(image)
        B, H, W, C = img.shape
        x, y = min(int(x), W - 1), min(int(y), H - 1)
        return (img[:, y:min(y + int(height), H), x:min(x + int(width), W)],)


def _gaussian_kernel1d(radius: int, sigma: float, device=None) -> torch.Tensor:
    xs = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-(xs ** 2) / (2.0 * float(sigma) ** 2))
    return k / k.sum()


def _separable_blur(img: torch.Tensor, radius: int, sigma: float) -> torch.Tensor:
    """Reflect-padded separable Gaussian over (B, H, W, C): two depthwise 1-D
    convolutions (stock's Blur/Sharpen pad reflectively)."""
    C = img.shape[-1]
    k = _gaussian_kernel1d(radius, sigma, img.device)
    pad = int(radius)
    x = F.pad(img.float().permute(0, 3, 1, 2), (pad, pad, pad, pad), mode="reflect")
    x = F.conv2d(x, k.reshape(1, 1, -1, 1).expand(C, 1, 2 * pad + 1, 1), groups=C)
    x = F.conv2d(x, k.reshape(1, 1, 1, -1).expand(C, 1, 1, 2 * pad + 1), groups=C)
    return x.permute(0, 2, 3, 1)


class ImageBlur:
    DESCRIPTION = "Stock-name Gaussian image blur."
    RETURN_TYPES = ("IMAGE",)
    RETURN_NAMES = ("image",)
    FUNCTION = "blur"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "image": ("IMAGE", {}),
            "blur_radius": ("INT", {"default": 1, "min": 1, "max": 31}),
            "sigma": ("FLOAT", {"default": 1.0, "min": 0.1, "max": 10.0, "step": 0.1}),
        }}

    def blur(self, image, blur_radius: int, sigma: float):
        return (_separable_blur(_batched(image), int(blur_radius), float(sigma)),)


class ImageSharpen:
    """Stock unsharp mask: img + alpha · (img − gaussian(img)), clipped."""

    DESCRIPTION = "Stock-name image sharpen (unsharp mask)."
    RETURN_TYPES = ("IMAGE",)
    RETURN_NAMES = ("image",)
    FUNCTION = "sharpen"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "image": ("IMAGE", {}),
            "sharpen_radius": ("INT", {"default": 1, "min": 1, "max": 31}),
            "sigma": ("FLOAT", {"default": 1.0, "min": 0.1, "max": 10.0, "step": 0.1}),
            "alpha": ("FLOAT", {"default": 1.0, "min": 0.0, "max": 5.0, "step": 0.1}),
        }}

    def sharpen(self, image, sharpen_radius: int, sigma: float, alpha: float):
        img = _batched(image)
        blurred = _separable_blur(img, int(sharpen_radius), float(sigma))
        return (torch.clamp(img + float(alpha) * (img - blurred), 0.0, 1.0),)


def _reshape_latent_to(a: torch.Tensor, b) -> torch.Tensor:
    """Stock reshape_latent_to: ``b``'s spatial grid resized (bilinear) to ``a``'s
    and its batch cycled up; the channel counts must already agree."""
    from .ops.resize import resize

    b = torch.as_tensor(b).to(a.device)
    if a.shape[-1] != b.shape[-1]:
        raise ValueError(f"latent channel counts differ ({a.shape[-1]} vs {b.shape[-1]} — "
                         "e.g. an SD1.5 latent mixed with an SD3/FLUX one); latent math "
                         "needs same-family latents")
    if a.shape[1:-1] != b.shape[1:-1]:
        b = resize(b, (b.shape[0], *a.shape[1:-1], b.shape[-1]), method="bilinear")
    return _repeat_to_batch(b, a.shape[0])


class LatentBlend:
    DESCRIPTION = "Stock-name latent lerp."
    RETURN_TYPES = ("LATENT",)
    RETURN_NAMES = ("latent",)
    FUNCTION = "blend"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "samples1": ("LATENT", {}),
            "samples2": ("LATENT", {}),
            "blend_factor": ("FLOAT", {"default": 0.5, "min": 0.0, "max": 1.0, "step": 0.01}),
        }}

    def blend(self, samples1, samples2, blend_factor: float):
        a = torch.as_tensor(samples1["samples"])
        b = _reshape_latent_to(a, samples2["samples"])
        f = float(blend_factor)
        return ({**samples1, "samples": a * f + b * (1.0 - f)},)


def _latent_binop(stock_name: str, fn):
    class _Op:
        DESCRIPTION = f"Stock-name latent op {stock_name}."
        RETURN_TYPES = ("LATENT",)
        RETURN_NAMES = ("latent",)
        FUNCTION = "op"
        CATEGORY = CATEGORY

        @classmethod
        def INPUT_TYPES(cls):
            return {"required": {"samples1": ("LATENT", {}), "samples2": ("LATENT", {})}}

        def op(self, samples1, samples2):
            a = torch.as_tensor(samples1["samples"])
            return ({**samples1, "samples": fn(a, _reshape_latent_to(a, samples2["samples"]))},)

    _Op.__name__ = _Op.__qualname__ = stock_name
    return _Op


class LatentInterpolate:
    """Stock norm-preserving interpolation: directions (per-pixel channel norm)
    lerp, magnitudes lerp separately, then recombine."""

    DESCRIPTION = "Stock-name norm-preserving latent interpolate."
    RETURN_TYPES = ("LATENT",)
    RETURN_NAMES = ("latent",)
    FUNCTION = "op"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "samples1": ("LATENT", {}),
            "samples2": ("LATENT", {}),
            "ratio": ("FLOAT", {"default": 1.0, "min": 0.0, "max": 1.0, "step": 0.01}),
        }}

    def op(self, samples1, samples2, ratio: float):
        a = torch.as_tensor(samples1["samples"])
        b = _reshape_latent_to(a, samples2["samples"])
        r = float(ratio)

        def norm(t):
            return torch.linalg.vector_norm(t, dim=-1, keepdim=True)

        def direction(t, n):
            return torch.where(n > 0, t / torch.clamp(n, min=1e-12), 0.0)

        na, nb = norm(a), norm(b)
        t = direction(a, na) * r + direction(b, nb) * (1.0 - r)
        return ({**samples1, "samples": direction(t, norm(t)) * (na * r + nb * (1.0 - r))},)


class LatentMultiply:
    """Stock scalar latent multiply (a FLOAT, not a second latent)."""

    DESCRIPTION = "Stock-name latent scalar multiply."
    RETURN_TYPES = ("LATENT",)
    RETURN_NAMES = ("latent",)
    FUNCTION = "op"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "samples": ("LATENT", {}),
            "multiplier": ("FLOAT", {"default": 1.0, "min": -10.0, "max": 10.0, "step": 0.01}),
        }}

    def op(self, samples, multiplier: float):
        return ({**samples, "samples": torch.as_tensor(samples["samples"]) * float(multiplier)},)


class LatentBatch:
    """Stock latent batch join (the second resized to the first's grid)."""

    DESCRIPTION = "Stock-name latent batch concat."
    RETURN_TYPES = ("LATENT",)
    RETURN_NAMES = ("latent",)
    FUNCTION = "batch"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"samples1": ("LATENT", {}), "samples2": ("LATENT", {})}}

    def batch(self, samples1, samples2):
        from .ops.resize import resize

        a = torch.as_tensor(samples1["samples"])
        b = torch.as_tensor(samples2["samples"]).to(a.device)
        if a.shape[1:-1] != b.shape[1:-1]:
            b = resize(b, (b.shape[0], *a.shape[1:-1], b.shape[-1]), method="bilinear")
        return ({**samples1, "samples": torch.cat([a, b], dim=0)},)


# ---------------------------------------------------------------------------
# Schedules and samplers
# ---------------------------------------------------------------------------


class KarrasScheduler:
    """Stock Karras sigma schedule → SIGMAS (``k_samplers.karras_sigmas``)."""

    DESCRIPTION = "Stock-name Karras sigma schedule."
    RETURN_TYPES = ("SIGMAS",)
    RETURN_NAMES = ("sigmas",)
    FUNCTION = "get_sigmas"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "steps": ("INT", {"default": 20, "min": 1, "max": 10000}),
            "sigma_max": ("FLOAT", {"default": 14.614642, "min": 0.0, "max": 5000.0,
                                    "step": 0.01}),
            "sigma_min": ("FLOAT", {"default": 0.0291675, "min": 0.0, "max": 5000.0,
                                    "step": 0.01}),
            "rho": ("FLOAT", {"default": 7.0, "min": 0.0, "max": 100.0, "step": 0.01}),
        }}

    def get_sigmas(self, steps: int, sigma_max: float, sigma_min: float, rho: float):
        from .sampling.k_samplers import karras_sigmas

        return (karras_sigmas(int(steps), sigma_min=float(sigma_min),
                              sigma_max=float(sigma_max), rho=float(rho)),)


class ExponentialScheduler:
    DESCRIPTION = "Stock-name exponential (log-uniform) sigma schedule."
    RETURN_TYPES = ("SIGMAS",)
    RETURN_NAMES = ("sigmas",)
    FUNCTION = "get_sigmas"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "steps": ("INT", {"default": 20, "min": 1, "max": 10000}),
            "sigma_max": ("FLOAT", {"default": 14.614642, "min": 0.0, "max": 5000.0,
                                    "step": 0.01}),
            "sigma_min": ("FLOAT", {"default": 0.0291675, "min": 0.0, "max": 5000.0,
                                    "step": 0.01}),
        }}

    def get_sigmas(self, steps: int, sigma_max: float, sigma_min: float):
        from .sampling.k_samplers import exponential_sigmas

        return (exponential_sigmas(int(steps), sigma_min=float(sigma_min),
                                   sigma_max=float(sigma_max)),)


class SDTurboScheduler:
    """Stock SD-Turbo schedule: the model's top ``steps`` trained sigmas offset by
    denoise (a fixed 10-rung ladder of timesteps 999, 899, …, 99, sliced from
    10 − int(10 · denoise) and truncated at its end)."""

    DESCRIPTION = "Stock-name SD-Turbo sigma schedule."
    RETURN_TYPES = ("SIGMAS",)
    RETURN_NAMES = ("sigmas",)
    FUNCTION = "get_sigmas"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "model": ("MODEL", {}),
            "steps": ("INT", {"default": 1, "min": 1, "max": 10}),
            "denoise": ("FLOAT", {"default": 1.0, "min": 0.0, "max": 1.0, "step": 0.01}),
        }}

    def get_sigmas(self, model, steps: int, denoise: float = 1.0):
        from .parallel.orchestrator import model_config_of
        from .sampling.k_samplers import model_sigmas
        from .sampling.schedules import scaled_linear_schedule

        if getattr(model_config_of(model), "prediction", "eps") == "flow":
            raise ValueError("SDTurboScheduler reads the SD eps/v trained-sigma ladder — "
                             "flow-family models schedule with BasicScheduler instead")
        table = model_sigmas(scaled_linear_schedule())
        ladder = [i * 100 - 1 for i in range(10, 0, -1)]
        start = 10 - int(10 * float(denoise))
        idx = ladder[start:start + int(steps)]
        if not idx:
            raise ValueError(f"denoise {denoise} leaves no turbo steps (start rung {start} "
                             "of 10)")
        sig = table[torch.tensor(idx)]
        return (torch.cat([sig, torch.zeros((1,), dtype=sig.dtype)]),)


def _named_sampler(stock_name: str, sampler_name: str):
    """A stock named-sampler node (SamplerEulerAncestral, …) → SAMPLER wire; the
    samplers run their k-diffusion defaults, so the wire is the name only."""

    class _Named:
        DESCRIPTION = f"Stock-name SAMPLER wire for {sampler_name}."
        RETURN_TYPES = ("SAMPLER",)
        RETURN_NAMES = ("sampler",)
        FUNCTION = "get_sampler"
        CATEGORY = CATEGORY

        @classmethod
        def INPUT_TYPES(cls):
            return {"required": {}}

        def get_sampler(self, **_ignored):
            return ({"sampler": sampler_name},)

    _Named.__name__ = _Named.__qualname__ = stock_name
    return _Named


class SamplerCustom:
    """Stock SamplerCustom, the one-box form of custom sampling: composes the NOISE
    and GUIDER wires and runs ``TPUSamplerCustomAdvanced``."""

    DESCRIPTION = "Stock-name custom sampling (pre-Advanced one-box form)."
    RETURN_TYPES = ("LATENT", "LATENT")
    RETURN_NAMES = ("output", "denoised_output")
    FUNCTION = "sample"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "model": ("MODEL", {}),
            "add_noise": ("BOOLEAN", {"default": True}),
            "noise_seed": ("INT", {"default": 0, "min": 0, "max": SEED_MAX}),
            "cfg": ("FLOAT", {"default": 8.0, "min": 0.0, "max": 100.0}),
            "positive": ("CONDITIONING", {}),
            "negative": ("CONDITIONING", {}),
            "sampler": ("SAMPLER", {}),
            "sigmas": ("SIGMAS", {}),
            "latent_image": ("LATENT", {}),
        }}

    def sample(self, model, add_noise, noise_seed: int, cfg: float, positive, negative,
               sampler, sigmas, latent_image):
        from .nodes import TPUSamplerCustomAdvanced

        noise = {"seed": int(noise_seed) if add_noise else None}
        guider = {"model": model, "positive": positive, "negative": negative,
                  "cfg": float(cfg)}
        return TPUSamplerCustomAdvanced().sample(noise, guider, sampler, sigmas, latent_image)


class unCLIPCheckpointLoader:  # noqa: N801 - stock node name
    """Stock unCLIP loader: the sd21-unclip single file also bundles its ViT-H image
    encoder (OpenCLIP layout under ``embedder.model.visual.*``), which feeds
    CLIPVisionEncode → unCLIPConditioning. MODEL, CLIP and VAE load as
    ``CheckpointLoaderSimple`` loads them."""

    DESCRIPTION = "Stock-name unCLIP checkpoint loader (incl. vision tower)."
    RETURN_TYPES = ("MODEL", "CLIP", "VAE", "CLIP_VISION")
    RETURN_NAMES = ("model", "clip", "vae", "clip_vision")
    FUNCTION = "load"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"ckpt_name": ("STRING", {"default": ""})}, "hidden": DEVICE_INPUT}

    def load(self, ckpt_name: str, device=None):
        from .models.loader import load_safetensors_subset, peek_safetensors
        from .models.vision import build_clip_vision, convert_clip_vision_checkpoint

        pfx = "embedder.model.visual."
        # The header first: a plain checkpoint fails before anything is converted.
        path = resolve_model_file(ckpt_name, "checkpoints")
        if not any(k.startswith(pfx) for k in peek_safetensors(path)):
            raise ValueError(f"checkpoint has no bundled image encoder ({pfx}*) — not an "
                             "unCLIP checkpoint; use CheckpointLoaderSimple + "
                             "CLIPVisionLoader instead")
        dev = resolve_device(device)
        model, clip, vae = CheckpointLoaderSimple().load(ckpt_name, device=dev)
        tower = load_safetensors_subset(path, pfx)
        state, vcfg = convert_clip_vision_checkpoint(
            {k[len(pfx):]: v for k, v in tower.items()})
        vision = build_clip_vision(vcfg, device=dev, state_dict=state, name="unclip-vision")
        return model, clip, vae, {"model": vision}


class ModelSamplingDiscrete:
    """Stock prediction-type override (eps / v_prediction): a new MODEL whose
    ``config.prediction`` the samplers read. ``zsnr`` is accepted and not applied
    (logged, as in the JAX shim)."""

    DESCRIPTION = "Stock-name prediction-type (eps/v) model patch."
    RETURN_TYPES = ("MODEL",)
    RETURN_NAMES = ("model",)
    FUNCTION = "patch"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "model": ("MODEL", {}),
            "sampling": (["eps", "v_prediction", "lcm", "x0"], {"default": "eps"}),
            "zsnr": ("BOOLEAN", {"default": False}),
        }}

    def patch(self, model, sampling: str = "eps", zsnr: bool = False):
        pred = {"eps": "eps", "v_prediction": "v"}.get(sampling)
        if pred is None:
            raise ValueError(f"ModelSamplingDiscrete sampling={sampling!r} is not supported "
                             "(eps / v_prediction are)")
        if zsnr:
            _log().warning("ModelSamplingDiscrete zsnr=True: zero-terminal-SNR sigma rescale "
                           "is not applied (documented divergence) — sampling proceeds with "
                           "the standard schedule")
        cfg = getattr(model, "config", None)
        if not dc.is_dataclass(model) or not dc.is_dataclass(cfg) or not hasattr(cfg, "prediction"):
            raise ValueError("ModelSamplingDiscrete needs an unwrapped MODEL whose config "
                             f"carries a prediction field (got {type(model).__name__}); apply "
                             "it before ParallelAnything")
        return (dc.replace(model, config=dc.replace(cfg, prediction=pred)),)


class EmptyHunyuanLatentVideo:
    """Stock empty video latent (the t2v entry of Wan/Hunyuan template exports):
    16 channels, 8× spatial and 4× temporal compression, (B, (length-1)//4 + 1,
    H/8, W/8, 16) in the NTHWC convention, through ``TPUEmptyVideoLatent``."""

    DESCRIPTION = "Stock-name empty video latent (WAN/Hunyuan t2v)."
    RETURN_TYPES = ("LATENT",)
    RETURN_NAMES = ("latent",)
    FUNCTION = "generate"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "width": ("INT", {"default": 848, "min": 16, "max": 8192, "step": 16}),
            "height": ("INT", {"default": 480, "min": 16, "max": 8192, "step": 16}),
            "length": ("INT", {"default": 25, "min": 1, "max": 1024, "step": 4}),
            "batch_size": ("INT", {"default": 1, "min": 1, "max": 16}),
        }, "hidden": DEVICE_INPUT}

    def generate(self, width: int, height: int, length: int, batch_size: int = 1,
                 device=None):
        from .nodes import TPUEmptyVideoLatent

        # Stock floors off-schedule lengths (((length-1)//4)+1 latent frames); API
        # submissions bypass widget steps, so any length is accepted.
        frames = max(1, (int(length) - 1) // 4 * 4 + 1)
        return TPUEmptyVideoLatent().generate(width=width, height=height, frames=frames,
                                              batch_size=batch_size, device=device)


class _FreeUBase:
    """FreeU: a new UNet module built for the config with ``freeu`` set, whose
    parameters are the loader's own tensors (nothing is copied: the device holds
    one UNet). The loader's MODEL is left as it was. SD-family UNet models, before
    ParallelAnything (stock's order)."""

    RETURN_TYPES = ("MODEL",)
    RETURN_NAMES = ("model",)
    FUNCTION = "patch"
    CATEGORY = CATEGORY
    _VERSION = 2

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "model": ("MODEL", {}),
            "b1": ("FLOAT", {"default": 1.3 if cls._VERSION >= 2 else 1.1, "min": 0.0,
                             "max": 10.0, "step": 0.01}),
            "b2": ("FLOAT", {"default": 1.4 if cls._VERSION >= 2 else 1.2, "min": 0.0,
                             "max": 10.0, "step": 0.01}),
            "s1": ("FLOAT", {"default": 0.9, "min": 0.0, "max": 10.0, "step": 0.01}),
            "s2": ("FLOAT", {"default": 0.2, "min": 0.0, "max": 10.0, "step": 0.01}),
        }}

    def patch(self, model, b1: float, b2: float, s1: float, s2: float):
        from .models.unet import UNet2D, UNetConfig, _unet_pipeline_spec

        cfg = getattr(model, "config", None)
        if not isinstance(cfg, UNetConfig) or not isinstance(getattr(model, "module", None),
                                                              UNet2D):
            raise ValueError(f"FreeU patches SD-family UNET models (config "
                             f"{type(cfg).__name__}); apply it between the checkpoint loader "
                             "and ParallelAnything/KSampler")
        cfg = dc.replace(cfg, freeu=(float(b1), float(b2), float(s1), float(s2),
                                     self._VERSION))
        return (_rebuilt(model, cfg, model.module.state_dict(), config=cfg,
                         name=f"{model.name}+freeu", pipeline_spec=_unet_pipeline_spec(cfg)),)


class FreeU(_FreeUBase):
    DESCRIPTION = "Stock-name FreeU model patch (v1: constant backbone scale)."
    _VERSION = 1


class FreeU_V2(_FreeUBase):  # noqa: N801 - stock node name
    DESCRIPTION = "Stock-name FreeU_V2 model patch (hidden-mean-modulated)."
    _VERSION = 2


def _patch_sampler_prefs(model, **updates):
    """``model`` with ``updates`` merged into its sampler_prefs: a new
    ``DiffusionModel``, or a shallow copy of a ``ParallelModel`` (placements shared,
    the original keeps ownership)."""
    prefs = {**(getattr(model, "sampler_prefs", None) or {}), **updates}
    if dc.is_dataclass(model) and not isinstance(model, type):
        return dc.replace(model, sampler_prefs=prefs)
    m = copy.copy(model)
    m.sampler_prefs = prefs
    return m


class RescaleCFG:
    """Stock RescaleCFG: tags the MODEL with a cfg_rescale default the samplers
    honour; a sampler's own non-zero cfg_rescale wins."""

    DESCRIPTION = "Stock-name CFG-rescale model patch."
    RETURN_TYPES = ("MODEL",)
    RETURN_NAMES = ("model",)
    FUNCTION = "patch"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "model": ("MODEL", {}),
            "multiplier": ("FLOAT", {"default": 0.7, "min": 0.0, "max": 1.0, "step": 0.01}),
        }}

    def patch(self, model, multiplier: float):
        return (_patch_sampler_prefs(model, cfg_rescale=float(multiplier)),)


class ModelSamplingSD3:
    """Stock SD3 schedule patch: the rectified-flow shift as the samplers' and
    BasicScheduler's default (a non-default shift widget wins)."""

    DESCRIPTION = "Stock-name SD3 flow-shift model patch."
    RETURN_TYPES = ("MODEL",)
    RETURN_NAMES = ("model",)
    FUNCTION = "patch"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "model": ("MODEL", {}),
            "shift": ("FLOAT", {"default": 3.0, "min": 0.0, "max": 100.0, "step": 0.01}),
        }}

    def patch(self, model, shift: float = 3.0):
        return (_patch_sampler_prefs(model, shift=float(shift)),)


class ModelSamplingFlux:
    """Stock FLUX schedule patch: the log-shift mu interpolated linearly over the
    latent token count (base_shift at 256 tokens, max_shift at 4096); exp(mu)
    becomes the samplers' shift default."""

    DESCRIPTION = "Stock-name FLUX resolution-shift model patch."
    RETURN_TYPES = ("MODEL",)
    RETURN_NAMES = ("model",)
    FUNCTION = "patch"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "model": ("MODEL", {}),
            "max_shift": ("FLOAT", {"default": 1.15, "min": 0.0, "max": 100.0, "step": 0.01}),
            "base_shift": ("FLOAT", {"default": 0.5, "min": 0.0, "max": 100.0, "step": 0.01}),
            "width": ("INT", {"default": 1024, "min": 16, "max": 16384}),
            "height": ("INT", {"default": 1024, "min": 16, "max": 16384}),
        }}

    def patch(self, model, max_shift: float = 1.15, base_shift: float = 0.5,
              width: int = 1024, height: int = 1024):
        # Latent tokens: the 8× VAE, then 2×2 patches → (w/16)·(h/16).
        tokens = (width / 16.0) * (height / 16.0)
        m = (max_shift - base_shift) / (4096.0 - 256.0)
        mu = tokens * m + (base_shift - m * 256.0)
        return (_patch_sampler_prefs(model, shift=float(math.exp(mu))),)


class ConditioningSetMask:
    """Stock mask-scoped conditioning: the cond applies with per-pixel weight from a
    MASK (resized to the latent at sampling). ``set_cond_area`` is accepted: "mask
    bounds" is stock's compute-crop and gives the same weights."""

    DESCRIPTION = "Stock-name mask-scoped conditioning."
    RETURN_TYPES = ("CONDITIONING",)
    RETURN_NAMES = ("conditioning",)
    FUNCTION = "append"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "conditioning": ("CONDITIONING", {}),
            "mask": ("MASK", {}),
            "strength": ("FLOAT", {"default": 1.0, "min": 0.0, "max": 10.0, "step": 0.01}),
            "set_cond_area": (["default", "mask bounds"], {"default": "default"}),
        }}

    def append(self, conditioning, mask, strength: float = 1.0,
               set_cond_area: str = "default"):
        # Its own key: stock multiplies area strength and mask strength.
        return (_tag_all_entries(conditioning, {
            "mask": torch.as_tensor(mask, dtype=torch.float32),
            "mask_strength": float(strength)}),)


class VAEDecodeTiled:
    """Stock tiled decode: ``tile_size`` in pixels (÷ the VAE's factor into latent
    cells); the tiling is ``models/vae.decode_maybe_tiled``'s. Stock's newer
    overlap and temporal widgets are accepted and not used."""

    DESCRIPTION = "Stock-name tiled VAE decode."
    RETURN_TYPES = ("IMAGE",)
    RETURN_NAMES = ("image",)
    FUNCTION = "decode"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "samples": ("LATENT", {}),
                "vae": ("VAE", {}),
                "tile_size": ("INT", {"default": 512, "min": 64, "max": 4096, "step": 32}),
            },
            "optional": {
                "overlap": ("INT", {"default": 64, "min": 0, "max": 4096}),
                "temporal_size": ("INT", {"default": 64, "min": 8, "max": 4096}),
                "temporal_overlap": ("INT", {"default": 8, "min": 4, "max": 4096}),
            },
        }

    def decode(self, samples, vae, tile_size: int = 512, overlap: int = 64,
               temporal_size: int = 64, temporal_overlap: int = 8):
        from .models.vae import decode_maybe_tiled, vae_output_to_images

        tile = max(8, int(tile_size) // getattr(vae, "spatial_factor", 8))
        return (vae_output_to_images(decode_maybe_tiled(vae, samples["samples"], tile)),)


class VAEEncodeTiled:
    """Stock tiled encode: ``models/vae.encode_maybe_tiled`` at a pixel tile."""

    DESCRIPTION = "Stock-name tiled VAE encode."
    RETURN_TYPES = ("LATENT",)
    RETURN_NAMES = ("latent",)
    FUNCTION = "encode"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "pixels": ("IMAGE", {}),
                "vae": ("VAE", {}),
                "tile_size": ("INT", {"default": 512, "min": 64, "max": 4096, "step": 64}),
            },
            "optional": {
                "overlap": ("INT", {"default": 64, "min": 0, "max": 4096}),
                "temporal_size": ("INT", {"default": 64, "min": 8, "max": 4096}),
                "temporal_overlap": ("INT", {"default": 8, "min": 4, "max": 4096}),
            },
        }

    def encode(self, pixels, vae, tile_size: int = 512, overlap: int = 64,
               temporal_size: int = 64, temporal_overlap: int = 8):
        from .models.vae import encode_maybe_tiled, images_to_vae_input

        return ({"samples": encode_maybe_tiled(vae, images_to_vae_input(_batched(pixels)),
                                               int(tile_size))},)


# ---------------------------------------------------------------------------
# Registration
# ---------------------------------------------------------------------------


def stock_node_mappings() -> dict[str, type]:
    """Every stock-name shim by its stock class name."""
    from . import nodes as n

    return {
        "CheckpointLoaderSimple": CheckpointLoaderSimple,
        "DualCLIPLoader": DualCLIPLoader,
        "CLIPLoader": CLIPLoader,
        "TripleCLIPLoader": TripleCLIPLoader,
        "VAELoader": VAELoader,
        "UNETLoader": UNETLoader,
        "unCLIPConditioning": unCLIPConditioning,
        "LoraLoader": LoraLoader,
        "LoraLoaderModelOnly": LoraLoaderModelOnly,
        "CLIPSetLastLayer": CLIPSetLastLayer,
        "LoadImage": LoadImage,
        "LatentUpscale": LatentUpscale,
        # Pure renames.
        "CLIPTextEncode": _renamed(n.TPUTextEncode, {}, name="CLIPTextEncode"),
        "EmptyLatentImage": _renamed(n.TPUEmptyLatent, {}, name="EmptyLatentImage"),
        "EmptySD3LatentImage": _EmptyLatent16ch,
        "KSampler": _renamed(n.TPUKSampler, {"latent_image": "latent"}, name="KSampler"),
        "KSamplerAdvanced": _renamed(n.TPUKSamplerAdvanced, {}, name="KSamplerAdvanced"),
        "VAEDecode": _renamed(n.TPUVAEDecode, {"samples": "latent"}, name="VAEDecode"),
        "VAEEncode": _renamed(n.TPUVAEEncode, {"pixels": "image"}, name="VAEEncode"),
        "SaveImage": _renamed(n.TPUSaveImage, {}, name="SaveImage"),
        "ImageScale": ImageScale,
        "ImageScaleBy": ImageScaleBy,
        "PreviewImage": PreviewImage,
        "ConditioningCombine": ConditioningCombine,
        "ConditioningSetArea": ConditioningSetArea,
        "ConditioningSetMask": ConditioningSetMask,
        "ConditioningSetAreaPercentage": ConditioningSetAreaPercentage,
        "CLIPTextEncodeFlux": CLIPTextEncodeFlux,
        "FreeU": FreeU,
        "FreeU_V2": FreeU_V2,
        "RescaleCFG": RescaleCFG,
        "ModelSamplingDiscrete": ModelSamplingDiscrete,
        "ModelSamplingSD3": ModelSamplingSD3,
        "ModelSamplingFlux": ModelSamplingFlux,
        "unCLIPCheckpointLoader": unCLIPCheckpointLoader,
        "SamplerCustom": SamplerCustom,
        "ImageCrop": ImageCrop,
        "ImageScaleToTotalPixels": ImageScaleToTotalPixels,
        "ModelMergeSimple": ModelMergeSimple,
        "ImageBlur": ImageBlur,
        "ImageSharpen": ImageSharpen,
        "LatentBlend": LatentBlend,
        "LatentBatch": LatentBatch,
        "LatentAdd": _latent_binop("LatentAdd", lambda a, b: a + b),
        "LatentSubtract": _latent_binop("LatentSubtract", lambda a, b: a - b),
        "LatentInterpolate": LatentInterpolate,
        "LatentMultiply": LatentMultiply,
        "KarrasScheduler": KarrasScheduler,
        "ExponentialScheduler": ExponentialScheduler,
        "SDTurboScheduler": SDTurboScheduler,
        "SamplerEulerAncestral": _named_sampler("SamplerEulerAncestral", "euler_ancestral"),
        "SamplerDPMPP_2M_SDE": _named_sampler("SamplerDPMPP_2M_SDE", "dpmpp_2m_sde"),
        "SamplerDPMPP_SDE": _named_sampler("SamplerDPMPP_SDE", "dpmpp_sde"),
        "SamplerDPMPP_3M_SDE": _named_sampler("SamplerDPMPP_3M_SDE", "dpmpp_3m_sde"),
        "SamplerLMS": _named_sampler("SamplerLMS", "lms"),
        "EmptyHunyuanLatentVideo": EmptyHunyuanLatentVideo,
        "ConditioningAverage": ConditioningAverage,
        "ConditioningZeroOut": ConditioningZeroOut,
        "ConditioningSetTimestepRange": ConditioningSetTimestepRange,
        "ConditioningConcat": ConditioningConcat,
        "CLIPTextEncodeSDXL": CLIPTextEncodeSDXL,
        "CLIPTextEncodeSDXLRefiner": CLIPTextEncodeSDXLRefiner,
        "ImageInvert": ImageInvert,
        "ImageBatch": ImageBatch,
        "RepeatLatentBatch": RepeatLatentBatch,
        "LatentFromBatch": LatentFromBatch,
        "LatentFlip": LatentFlip,
        "LatentRotate": LatentRotate,
        "LatentCrop": LatentCrop,
        "SaveLatent": SaveLatent,
        "LoadLatent": LoadLatent,
        "SolidMask": SolidMask,
        "InvertMask": InvertMask,
        "ImageToMask": ImageToMask,
        "MaskToImage": MaskToImage,
        "GrowMask": GrowMask,
        "FeatherMask": FeatherMask,
        "MaskComposite": MaskComposite,
        "LoadImageMask": LoadImageMask,
        "VAEEncodeForInpaint": VAEEncodeForInpaint,
        "VAEDecodeTiled": VAEDecodeTiled,
        "VAEEncodeTiled": VAEEncodeTiled,
        "ImagePadForOutpaint": ImagePadForOutpaint,
        "ImageCompositeMasked": ImageCompositeMasked,
        "LatentComposite": LatentComposite,
        "SaveAnimatedWEBP": SaveAnimatedWEBP,
        "ControlNetLoader": ControlNetLoader,
        "ControlNetApply": ControlNetApply,
        "ControlNetApplyAdvanced": ControlNetApplyAdvanced,
        "CLIPVisionLoader": CLIPVisionLoader,
        "CLIPVisionEncode": CLIPVisionEncode,
        "WanImageToVideo": WanImageToVideo,
        "UpscaleModelLoader": UpscaleModelLoader,
        "ImageUpscaleWithModel": _renamed(n.TPUImageUpscaleWithModel, {},
                                          name="ImageUpscaleWithModel"),
        # Stock-shaped from the start (the same widget names).
        "InpaintModelConditioning": _renamed(n.TPUInpaintModelConditioning, {},
                                             name="InpaintModelConditioning"),
        "LatentUpscaleBy": _renamed(n.TPULatentUpscale, {"samples": "latent",
                                                         "scale_by": "scale",
                                                         "upscale_method": "method"},
                                    name="LatentUpscaleBy"),
        "SetLatentNoiseMask": _renamed(n.TPUSetLatentNoiseMask, {"samples": "latent"},
                                       name="SetLatentNoiseMask"),
        # The custom-sampling family, stock-shaped from the start.
        "RandomNoise": _renamed(n.TPURandomNoise, {}, name="RandomNoise"),
        "DisableNoise": _renamed(n.TPUDisableNoise, {}, name="DisableNoise"),
        "KSamplerSelect": _renamed(n.TPUKSamplerSelect, {}, name="KSamplerSelect"),
        "BasicScheduler": _renamed(n.TPUBasicScheduler, {}, name="BasicScheduler"),
        "BasicGuider": _renamed(n.TPUBasicGuider, {}, name="BasicGuider"),
        "CFGGuider": _renamed(n.TPUCFGGuider, {}, name="CFGGuider"),
        "FluxGuidance": _renamed(n.TPUFluxGuidance, {}, name="FluxGuidance"),
        "SamplerCustomAdvanced": _renamed(n.TPUSamplerCustomAdvanced, {},
                                          name="SamplerCustomAdvanced"),
        "SplitSigmas": _renamed(n.TPUSplitSigmas, {}, name="SplitSigmas"),
        "FlipSigmas": _renamed(n.TPUFlipSigmas, {}, name="FlipSigmas"),
    }


def register(node_class_mappings: dict[str, type],
             display_name_mappings: dict[str, str] | None = None) -> None:
    """Merge the shims into a registry without overriding native names."""
    for name, cls in stock_node_mappings().items():
        node_class_mappings.setdefault(name, cls)
        if display_name_mappings is not None:
            display_name_mappings.setdefault(name, f"{name} (stock compat)")
