"""The node layer: ComfyUI-style declarative nodes over the port (counterpart of
``comfyui_parallelanything_tpu/nodes.py``).

The same node protocol (``INPUT_TYPES`` / ``RETURN_TYPES`` / ``RETURN_NAMES`` /
``FUNCTION`` / ``CATEGORY`` / ``DESCRIPTION``) and the same ``class_type`` names,
which are the wire format of the ``examples/*.json`` graphs:

- the reference's own nodes: ``ParallelDevice``, ``ParallelDeviceList``,
  ``ParallelAnything`` and ``ParallelAnythingAdvanced`` (the DEVICE_CHAIN wire is
  the reference's list of ``{"device", "percentage", "weight"}`` dicts; ``weight``
  is written and never read);
- the ``TPU*`` host nodes around them: loaders, text encode, latents, the
  samplers (KSampler, KSamplerAdvanced and the custom-sampling set), VAE encode /
  decode (images, and 5-D video latents through the Wan video VAE), images,
  ControlNet, inpaint conditioning, Wan image-to-video conditioning and the
  ESRGAN upscaler.

Where the work runs: the loader nodes, ``TPUEmptyLatent``, ``TPUEmptyVideoLatent``
and ``TPULoadImage`` take a hidden ``device`` input that the graph host fills in
(``host.run_workflow(device=...)``, default ``cuda:0``); called directly they use
``devices.discovery.default_device()``, which raises without a GPU. Everything
downstream runs where its inputs live. A seed's noise is drawn from a seeded CPU
``torch.Generator`` and moved to the latent's device, so one seed gives the same
noise on every device (the JAX package's ``jax.random`` is device-independent in
the same way); it cannot match the JAX bits.

The stock-ComfyUI class names (``CheckpointLoaderSimple``, ``KSampler``, …) come
from ``nodes_compat.py``, merged into ``NODE_CLASS_MAPPINGS`` at the end of this
module (native names win), so exported stock graphs run unchanged.

Left out, with its ROADMAP Queue 1 item: the serving decode queue that the JAX
``TPUVAEDecode`` asks first (9): decodes run inline.
"""

from __future__ import annotations

import os
from typing import Any

import torch

from .devices.discovery import VIRTUAL_CPU_DEVICES, available_devices, default_device, get_device
from .parallel.chain import DeviceChain
from .parallel.orchestrator import ParallelConfig, ParallelModel, model_config_of, parallelize

CATEGORY = "parallel/tpu"

# Stock ComfyUI seed widgets are 64-bit ([0, 2**64)); generators take a signed
# 64-bit seed, so a seed folds into [0, 2**63).
SEED_MAX = 2**64 - 1

# The hidden input the graph host fills with the device a run places its work on.
DEVICE_INPUT = {"device": "DEVICE"}


def resolve_device(device=None) -> torch.device:
    """The device a node places its work on: the host's ``device`` string, else
    ``default_device()`` (``cuda:0``; raises without a GPU)."""
    if device is None:
        return default_device()
    return device if isinstance(device, torch.device) else get_device(str(device))


def seed_generator(seed: int, device="cpu") -> torch.Generator:
    """A ``torch.Generator`` on ``device`` for any ComfyUI seed, folding the stock
    64-bit range into the signed 64-bit domain (the JAX ``seed_key``)."""
    return torch.Generator(device=device).manual_seed(int(seed) % 2**63)


def initial_noise(seed: int, shape, device) -> torch.Tensor:
    """The sampler's N(0, 1) starting noise (f32): drawn from a CPU generator seeded
    with ``seed``, then moved to ``device``, so a seed gives the same noise on
    every device."""
    return torch.randn(tuple(shape), generator=seed_generator(seed),
                       dtype=torch.float32).to(device)


def chain_from_wire(entries: list[dict[str, Any]] | None) -> DeviceChain:
    """DEVICE_CHAIN wire → ``DeviceChain`` (links at percentage <= 0 dropped)."""
    if not entries:
        return DeviceChain()
    return DeviceChain.from_pairs(
        (e["device"], float(e.get("percentage", 0.0))) for e in entries)


def chain_to_wire(chain: DeviceChain) -> list[dict[str, Any]]:
    """``DeviceChain`` → the reference's wire format, with its unread ``weight``."""
    return [{"device": l.device, "percentage": l.percentage, "weight": l.percentage / 100.0}
            for l in chain.links]


def _checked_device(device_id: str) -> str:
    """``device_id`` when it names a device of this machine, else ``ValueError``. The
    JAX node passes any string on and ``parallelize`` drops what does not resolve;
    the port's nodes refuse it, so a graph naming a device the machine lacks (the
    shipped examples' ``tpu:0``) fails instead of running unparallelized."""
    try:
        get_device(device_id)
    except ValueError as e:
        raise ValueError(f"{e}; this machine offers {_device_menu()}") from None
    return device_id


def _device_menu() -> list[str]:
    """The device dropdown: ``cuda:i`` and ``cpu``, then ``cpu:i`` (i < 8), the CPU
    stand-ins the tests chain."""
    return available_devices() + [f"cpu:{i}" for i in range(VIRTUAL_CPU_DEVICES)]


def _log():
    from .utils.logging import get_logger

    return get_logger()


class ParallelDevice:
    """One link in the device chain: a device and its workload percentage,
    chainable through ``previous_devices``."""

    DESCRIPTION = ("Add a device to the parallel chain with a workload percentage. "
                   "Chain multiple nodes to build an N-device setup.")
    RETURN_TYPES = ("DEVICE_CHAIN",)
    RETURN_NAMES = ("device_chain",)
    FUNCTION = "add_device"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        devices = _device_menu()
        return {
            "required": {
                "device_id": (devices, {"default": devices[0],
                                        "tooltip": "Device to add to the chain"}),
                "percentage": ("FLOAT", {"default": 50.0, "min": 1.0, "max": 100.0,
                                         "step": 1.0,
                                         "tooltip": "Share of the workload for this device"}),
            },
            "optional": {
                "previous_devices": ("DEVICE_CHAIN", {
                    "tooltip": "Chain from an upstream Parallel Device node"}),
            },
        }

    def add_device(self, device_id: str, percentage: float, previous_devices=None):
        # Copy, then append: an upstream list is never mutated.
        chain = list(previous_devices) if previous_devices else []
        chain.append({"device": _checked_device(device_id), "percentage": float(percentage),
                      "weight": float(percentage) / 100.0})
        return (chain,)


class ParallelDeviceList:
    """One node, four device + percentage slots; a slot at <= 0 % is dropped."""

    DESCRIPTION = "Configure up to 4 devices in one node; 0% disables a slot."
    RETURN_TYPES = ("DEVICE_CHAIN",)
    RETURN_NAMES = ("device_chain",)
    FUNCTION = "create_list"
    CATEGORY = CATEGORY
    N_SLOTS = 4

    @classmethod
    def INPUT_TYPES(cls):
        devices = _device_menu()
        required = {}
        for i in range(1, cls.N_SLOTS + 1):
            required[f"device_{i}"] = (devices, {"default": devices[0],
                                                 "tooltip": f"Device for slot {i}"})
            required[f"percentage_{i}"] = ("FLOAT", {
                "default": 50.0 if i <= 2 else 0.0, "min": 0.0, "max": 100.0, "step": 1.0,
                "tooltip": f"Workload share for slot {i}; 0 disables"})
        return {"required": required}

    def create_list(self, **kwargs):
        chain = []
        for i in range(1, self.N_SLOTS + 1):
            pct = float(kwargs.get(f"percentage_{i}", 0.0))
            if pct <= 0:
                continue
            chain.append({"device": _checked_device(kwargs[f"device_{i}"]), "percentage": pct,
                          "weight": pct / 100.0})
        return (chain,)


class ParallelAnything:
    """MODEL + DEVICE_CHAIN → the MODEL wrapped by ``parallelize``: every sampler
    step runs over the chain."""

    DESCRIPTION = ("True multi-device parallelism: splits each denoise step across the "
                   "device chain (data parallel for batches, pipeline block placement "
                   "for batch=1).")
    RETURN_TYPES = ("MODEL",)
    RETURN_NAMES = ("model",)
    FUNCTION = "setup_parallel"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "model": ("MODEL", {"tooltip": "Diffusion model to parallelize"}),
                "parallel_devices": ("DEVICE_CHAIN", {
                    "tooltip": "Device chain from Parallel Device node(s)"}),
                "workload_split": ("BOOLEAN", {"default": True,
                                               "tooltip": "Split batches across devices"}),
                "auto_vram_balance": ("BOOLEAN", {
                    "default": True, "tooltip": "Blend workload split with free device memory"}),
                "purge_cache": ("BOOLEAN", {"default": True,
                                            "tooltip": "Release caches at teardown"}),
                "purge_models": ("BOOLEAN", {"default": False,
                                             "tooltip": "Also drop compiled programs"}),
            },
        }

    def setup_parallel(self, model, parallel_devices, workload_split: bool = True,
                       auto_vram_balance: bool = True, purge_cache: bool = True,
                       purge_models: bool = False, **config_extra):
        # ``purge_models`` selects nothing here: the port's teardown always drops
        # the captured sampler loops, its only compiled programs.
        chain = chain_from_wire(parallel_devices)
        if not config_extra.get("reactivate_after"):
            # Widget convention: 0 = off; ParallelConfig's off is None.
            config_extra.pop("reactivate_after", None)
        config = ParallelConfig(workload_split=workload_split,
                                auto_memory_balance=auto_vram_balance,
                                purge_cache=purge_cache, **config_extra)
        # An unusable chain returns the model unchanged (the reference's abort paths).
        return (parallelize(model, chain, config),)


class ParallelAnythingAdvanced(ParallelAnything):
    """The orchestrator node with the beyond-reference knobs: weight sharding,
    tensor parallelism, pipeline microbatches and auto-reactivation, passed through
    to ``ParallelConfig`` (``fsdp`` shards each large weight over the chain,
    ``tensor_parallel > 1`` splits the Linear/Conv2d layers over a model axis)."""

    DESCRIPTION = (ParallelAnything.DESCRIPTION + " Advanced: FSDP weight sharding and "
                   "tensor parallelism for models larger than a single device.")
    FUNCTION = "setup_parallel"

    @classmethod
    def INPUT_TYPES(cls):
        base = ParallelAnything.INPUT_TYPES()
        base["required"]["weight_sharding"] = (["replicate", "fsdp"], {
            "default": "replicate",
            "tooltip": "fsdp shards each weight across the chain (model > 1 device)"})
        base["required"]["tensor_parallel"] = ("INT", {
            "default": 1, "min": 1, "max": 64,
            "tooltip": "model-axis size; >1 partitions the matmuls"})
        base["optional"] = dict(base.get("optional") or {})
        base["optional"]["pipeline_microbatches"] = ("INT", {
            "default": 0, "min": 0, "max": 64,
            "tooltip": "stream a batch through the stage chain as this many "
                       "microbatches (0 or 1 = off)"})
        base["optional"]["reactivate_after"] = ("INT", {
            "default": 0, "min": 0, "max": 10000,
            "tooltip": "resume the parallel path this many single-device steps after a "
                       "step-OOM demotion (0 = stay demoted until reactivated)"})
        return base


# ---------------------------------------------------------------------------
# Host-layer nodes (beyond the reference's own): the graph around the MODEL.
# ---------------------------------------------------------------------------

_MODEL_FAMILIES = (
    "sd15", "sd15-inpaint", "sd21", "sd21-v", "sd21-inpaint", "sd21-unclip",
    "sdxl", "sdxl-inpaint", "sdxl-refiner",
    "sd3-medium", "sd35-medium", "sd35-large",
    "flux-dev", "flux-schnell", "zimage-turbo", "wan-1.3b", "wan-14b",
)


class TPUCheckpointLoader:
    """Checkpoint file → (MODEL, VAE): the diffusion subtree and, when the file has
    one, its ``first_stage_model`` VAE. ``quantize="int8"`` loads and quantizes on
    the host (``models/quantize.py``) and moves only the int8 payload and its
    scales to the device."""

    DESCRIPTION = "Load a diffusion checkpoint (and its bundled VAE) for a family."
    RETURN_TYPES = ("MODEL", "VAE")
    RETURN_NAMES = ("model", "vae")
    FUNCTION = "load"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "ckpt_path": ("STRING", {"default": "", "tooltip": "safetensors path"}),
                "family": (list(_MODEL_FAMILIES), {"default": "sd15",
                                                   "tooltip": "model family / config preset"}),
            },
            "optional": {
                "vae_path": ("STRING", {"default": "",
                                        "tooltip": "separate VAE file (flux ae, fixed vae)"}),
                "lora_path": ("STRING", {"default": ""}),
                "lora_strength": ("FLOAT", {"default": 1.0, "min": -4.0, "max": 4.0}),
                "quantize": (["none", "int8"], {
                    "default": "none",
                    "tooltip": "int8 halves the weights' device memory (per-channel "
                               "symmetric)"}),
            },
            "hidden": DEVICE_INPUT,
        }

    def load(self, ckpt_path: str, family: str, vae_path: str = "", lora_path: str = "",
             lora_strength: float = 1.0, quantize: str = "none", load_vae: bool = True,
             device=None):
        # load_vae=False returns (MODEL, None): re-load paths that need only the model.
        from . import models as M

        dev = resolve_device(device)
        # The int8 path builds the full-precision model on the host, quantizes it
        # there and moves only the int8 payload to the device.
        load_dev = torch.device("cpu") if quantize == "int8" else dev
        lora = lora_path or None
        sd = M.load_safetensors(ckpt_path)
        if family.startswith("wan"):
            return self._load_wan(sd, family, vae_path, lora, lora_strength, quantize,
                                  load_vae, load_dev, dev)
        if family in ("sd15", "sd15-inpaint"):
            # Kwargs only for the inpaint variant: tests monkeypatch the preset
            # factories with zero-argument tiny versions.
            ucfg = M.sd15_config(**({"in_channels": 9} if family == "sd15-inpaint" else {}))
            model = M.load_sd_unet_checkpoint(sd, ucfg, lora, lora_strength, device=load_dev)
            vae_cfg = M.sd_vae_config()
        elif family in ("sd3-medium", "sd35-medium", "sd35-large"):
            mcfg = {"sd35-large": M.sd35_large_config, "sd35-medium": M.sd35_medium_config,
                    "sd3-medium": M.sd3_medium_config}[family]()
            model = M.load_mmdit_checkpoint(sd, mcfg, lora, lora_strength, device=load_dev)
            vae_cfg = M.sd3_vae_config()
        elif family in ("sd21", "sd21-v", "sd21-inpaint", "sd21-unclip"):
            ucfg = M.sd21_config(prediction="v" if family == "sd21-v" else "eps",
                                 **({"in_channels": 9} if family == "sd21-inpaint" else {}))
            if family == "sd21-unclip":
                # unCLIP derives from the 768-v model and adds an adm head whose
                # width the checkpoint's label_emb records.
                import dataclasses

                le = sd.get("label_emb.0.0.weight")
                if le is None:
                    le = sd.get("model.diffusion_model.label_emb.0.0.weight")
                if le is None:
                    raise ValueError("sd21-unclip checkpoint has no label_emb — not an "
                                     "unCLIP variant")
                ucfg = dataclasses.replace(ucfg, prediction="v",
                                           adm_in_channels=int(le.shape[1]))
            model = M.load_sd_unet_checkpoint(sd, ucfg, lora, lora_strength, device=load_dev)
            vae_cfg = M.sd_vae_config()
        elif family in ("sdxl", "sdxl-inpaint", "sdxl-refiner"):
            if family == "sdxl-refiner":
                xcfg = M.sdxl_refiner_config()
            else:
                xcfg = M.sdxl_config(**({"in_channels": 9} if family == "sdxl-inpaint" else {}))
            model = M.load_sd_unet_checkpoint(sd, xcfg, lora, lora_strength, device=load_dev)
            vae_cfg = M.sdxl_vae_config()
        else:
            cfg = {"flux-dev": M.flux_dev_config, "flux-schnell": M.flux_schnell_config,
                   "zimage-turbo": M.z_image_turbo_config}[family]()
            model = M.load_flux_checkpoint(sd, cfg, lora, lora_strength, device=load_dev)
            vae_cfg = M.flux_vae_config()
        if quantize == "int8":
            model = M.quantize_model(model)
            model.module.to(dev)
        if not load_vae:
            return model, None
        vae_sd = M.load_safetensors(vae_path) if vae_path else sd
        if not any(k.startswith("decoder.") for k in M.strip_vae_prefix(vae_sd)):
            raise ValueError(
                f"no VAE weights in {'vae_path' if vae_path else 'the checkpoint'} — "
                "flux/bare-UNet checkpoints don't bundle one; set vae_path to the "
                "autoencoder file (e.g. ae.safetensors)")
        return model, M.load_vae_checkpoint(vae_sd, cfg=vae_cfg, device=dev)

    @staticmethod
    def _load_wan(sd, family, vae_path, lora, lora_strength, quantize, load_vae, load_dev,
                  dev):
        """The Wan family: the video DiT, and the causal video VAE from its own file
        (Wan releases do not bundle it). i2v checkpoints are told by their
        ``patch_embedding`` input width (36 = latent + frame mask + cond latent),
        the Wan2.1-style ones by the ``img_emb`` branch (its proj.1 input width is
        the CLIP hidden size)."""
        import dataclasses

        from . import models as M

        wcfg = (M.wan_14b_config if family == "wan-14b" else M.wan_1_3b_config)()
        pe = sd.get("patch_embedding.weight")
        img_w = sd.get("img_emb.proj.1.weight")
        wcfg = dataclasses.replace(
            wcfg, in_channels=int(pe.shape[1]) if pe is not None else wcfg.in_channels,
            img_dim=int(img_w.shape[1]) if img_w is not None else None)
        model = M.load_wan_checkpoint(sd, wcfg, lora, lora_strength, device=load_dev)
        if quantize == "int8":
            model = M.quantize_model(model)
            model.module.to(dev)
        if not load_vae:
            return model, None
        if not vae_path:
            raise ValueError("wan checkpoints don't bundle a VAE — set vae_path to the Wan "
                             "VAE safetensors file")
        return model, M.load_wan_vae_checkpoint(vae_path, device=dev)


class TPUCLIPLoader:
    """Encoder and tokenizer files → the CLIP wire (encoder, tokenizer, type and the
    embed cache's model key). CLIP towers take ``tokenizer_json`` or
    ``vocab_path`` + ``merges_path``; T5/UMT5 take ``tokenizer_json``."""

    DESCRIPTION = "Load a CLIP/T5 text encoder and its tokenizer tables."
    RETURN_TYPES = ("CLIP",)
    RETURN_NAMES = ("clip",)
    FUNCTION = "load"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "encoder_path": ("STRING", {"default": ""}),
                "encoder_type": (["clip-l", "open-clip-g", "open-clip-h", "t5", "umt5"],
                                 {"default": "clip-l"}),
            },
            "optional": {
                "vocab_path": ("STRING", {"default": "", "tooltip": "CLIP vocab.json"}),
                "merges_path": ("STRING", {"default": "", "tooltip": "CLIP merges.txt"}),
                "tokenizer_json": ("STRING", {"default": "", "tooltip": "tokenizer.json"}),
                "max_len": ("INT", {"default": 77, "min": 8, "max": 4096}),
            },
            "hidden": DEVICE_INPUT,
        }

    def load(self, encoder_path: str, encoder_type: str, vocab_path: str = "",
             merges_path: str = "", tokenizer_json: str = "", max_len: int = 77, device=None):
        import hashlib

        from . import models as M
        from .models.embed_cache import file_stamp
        from .utils.tokenizer import CLIPBPETokenizer, load_tokenizer_json

        dev = resolve_device(device)
        if encoder_type in ("t5", "umt5"):
            if not tokenizer_json:
                raise ValueError(
                    f"encoder_type={encoder_type!r} requires tokenizer_json (no "
                    "vocab.json/merges.txt form exists for these tokenizers)")
            cfg = M.umt5_xxl_config() if encoder_type == "umt5" else None
            enc = M.load_t5_checkpoint(encoder_path, cfg, device=dev)
            tok = load_tokenizer_json(tokenizer_json, max_len=max_len, eos_id=1)
        else:
            cfg = M.open_clip_h_config() if encoder_type == "open-clip-h" else None
            enc = M.load_clip_text_checkpoint(
                encoder_path, cfg=cfg, open_clip=encoder_type in ("open-clip-g", "open-clip-h"),
                device=dev)
            if tokenizer_json:
                tok = load_tokenizer_json(tokenizer_json, max_len=max_len)
            elif vocab_path and merges_path:
                tok = CLIPBPETokenizer.from_files(
                    vocab_path, merges_path, max_len=max_len,
                    pad_id=0 if encoder_type in ("open-clip-g", "open-clip-h") else None)
            else:
                raise ValueError("CLIP loading needs tokenizer_json OR both vocab_path and "
                                 "merges_path")
        # The embed cache's model key: the file's identity (path, size, mtime) and
        # the tower's settings, so two loads of one file share cache entries.
        model_key = hashlib.md5(repr(
            [file_stamp(encoder_path), encoder_type, max_len, vocab_path, merges_path,
             tokenizer_json]).encode()).hexdigest()
        return ({"encoder": enc, "tokenizer": tok, "type": encoder_type,
                 "model_key": model_key},)


class TPUTextEncode:
    """(CLIP, text) → CONDITIONING ``{"context", "penultimate", "pooled"}``, through
    the embed cache (``models/embed_cache.cached_encode``)."""

    DESCRIPTION = "Encode a prompt with a loaded text encoder."
    RETURN_TYPES = ("CONDITIONING",)
    RETURN_NAMES = ("conditioning",)
    FUNCTION = "encode"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "clip": ("CLIP", {}),
                "text": ("STRING", {"default": "", "multiline": True}),
            },
            "optional": {
                "clip_skip": ("INT", {
                    "default": 0, "min": 0, "max": 2,
                    "tooltip": "host CLIPSetLastLayer semantics: 0 = model default (SD2 "
                               "towers auto-use penultimate), 1 = final layer, 2 = "
                               "penultimate"}),
            },
        }

    def encode(self, clip, text: str, clip_skip: int = 0):
        if clip_skip == 0:
            # A CLIPSetLastLayer tag on the wire; an explicit widget value wins.
            clip_skip = int(clip.get("clip_skip", 0))
        if clip_skip in (-1, -2):
            clip_skip = -clip_skip
        if clip_skip not in (0, 1, 2):
            raise ValueError(f"clip_skip must be 0 (model default), 1/-1 (final layer) or "
                             f"2/-2 (penultimate); got {clip_skip}")
        ctype = clip.get("type")
        if ctype == "sdxl-dual":
            from .models.text_encoders import sdxl_text_conditioning

            (cl,) = self.encode(clip["l"], text, clip_skip)
            (cg,) = self.encode(clip["g"], text, clip_skip)
            str_l = cl["penultimate"] if clip_skip == 0 else cl["context"]
            str_g = cg["penultimate"] if clip_skip == 0 else cg["context"]
            context, y = sdxl_text_conditioning(str_l, str_g, cg["pooled"], width=1024,
                                                height=1024)
            return ({"context": context, "penultimate": None, "pooled": y},)
        if ctype == "sd3-triple":
            return (self._sd3(clip, text, clip_skip),)
        if ctype == "flux-dual":
            (ct5,) = self.encode(clip["t5"], text, clip_skip)
            (cl,) = self.encode(clip["l"], text, clip_skip)
            return ({"context": ct5["context"], "penultimate": None, "pooled": cl["pooled"]},)
        enc, tok = clip["encoder"], clip["tokenizer"]
        if enc is None or tok is None:
            raise ValueError(clip.get("tokenizer_error") or "CLIP wire has no encoder/tokenizer")
        # Content-addressed reuse: a hit skips the encoder and returns the same
        # tensors, so cached and fresh conditioning are bitwise equal.
        from .models import embed_cache

        ids, mask = tok([text])
        if clip["type"] in ("t5", "umt5"):
            context = embed_cache.cached_encode(
                enc, clip.get("model_key"), clip["type"], ids, mask,
                lambda: enc(ids, mask=mask))
            return ({"context": context, "pooled": None},)
        last, penultimate, pooled = embed_cache.cached_encode(
            enc, clip.get("model_key"), clip["type"], ids, None, lambda: enc(ids))
        if clip_skip == 1:
            context = last
        elif clip_skip == 2:
            context = penultimate
        else:
            # Model default: SD2 towers (penultimate_ln) train on the penultimate layer.
            context = penultimate if getattr(enc.cfg, "penultimate_ln", False) else last
        return ({"context": context, "penultimate": penultimate, "pooled": pooled},)

    def _sd3(self, clip, text: str, clip_skip: int) -> dict:
        """SD3's (context, y) from every tower present: a missing CLIP-L keeps its
        slot as zeros (L at joint[0:768], G at joint[768:2048]); a missing G is a
        width-0 stream; missing pooled halves zero-fill at 768 / 1280."""
        from .models.text_encoders import sd3_text_conditioning

        cl = self.encode(clip["l"], text, clip_skip)[0] if clip.get("l") is not None else None
        cg = self.encode(clip["g"], text, clip_skip)[0] if clip.get("g") is not None else None
        if cl is None and cg is None:
            raise ValueError("sd3 conditioning needs at least one CLIP tower (clip_l or "
                             "clip_g); got T5 only")
        t5_ctx = None
        if clip.get("t5") is not None:
            t5_ctx = self.encode(clip["t5"], text, clip_skip)[0]["context"]
        context_dim = t5_ctx.shape[-1] if t5_ctx is not None else 4096
        present = cl if cl is not None else cg
        batch, seq = present["penultimate"].shape[:2]
        dev = present["penultimate"].device
        if cl is not None:
            l_pen, l_pooled = cl["penultimate"], cl["pooled"]
        else:
            g_width = cg["penultimate"].shape[-1]
            l_pen = torch.zeros((batch, seq, min(768, max(0, context_dim - g_width))),
                                device=dev)
            l_pooled = torch.zeros((batch, 768), device=dev)
        if cg is not None:
            g_pen, g_pooled = cg["penultimate"], cg["pooled"]
        else:
            g_pen = torch.zeros((batch, seq, 0), device=dev)
            g_pooled = torch.zeros((batch, 1280), device=dev)
        context, y = sd3_text_conditioning(l_pen, g_pen, l_pooled, g_pooled, t5_ctx,
                                           context_dim=context_dim)
        return {"context": context, "penultimate": None, "pooled": y}


class TPUConditioningCombine:
    """Assemble multi-tower conditioning: ``sdxl`` (CLIP-L + OpenCLIP-G → 2048-d
    context and 2816-d pooled/size vector), ``flux`` (T5 context + CLIP-L pooled)
    and ``sd3`` (L ⊕ G padded into the T5 context, 2048-d pooled)."""

    DESCRIPTION = "Combine text-encoder outputs for SDXL (L+G), FLUX (T5+CLIP), or SD3 (L+G+T5)."
    RETURN_TYPES = ("CONDITIONING",)
    RETURN_NAMES = ("conditioning",)
    FUNCTION = "combine"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "conditioning_a": ("CONDITIONING", {"tooltip": "CLIP-L (sdxl) / T5 (flux)"}),
                "conditioning_b": ("CONDITIONING", {
                    "tooltip": "OpenCLIP-G (sdxl) / CLIP-L (flux)"}),
                "mode": (["sdxl", "flux", "sd3"], {"default": "sdxl"}),
            },
            "optional": {
                "width": ("INT", {"default": 1024, "min": 16, "max": 8192}),
                "height": ("INT", {"default": 1024, "min": 16, "max": 8192}),
                "conditioning_c": ("CONDITIONING", {
                    "tooltip": "T5 (sd3; optional but recommended)"}),
            },
        }

    def combine(self, conditioning_a, conditioning_b, mode: str, width: int = 1024,
                height: int = 1024, conditioning_c=None):
        if mode == "sd3":
            from .models.text_encoders import sd3_text_conditioning

            pen_l, pooled_l = conditioning_a.get("penultimate"), conditioning_a.get("pooled")
            pen_g, pooled_g = conditioning_b.get("penultimate"), conditioning_b.get("pooled")
            if pen_l is None or pen_g is None or pooled_l is None or pooled_g is None:
                raise ValueError("sd3 mode needs CLIP-L as a and OpenCLIP-G as b, both from "
                                 "TPUTextEncode (penultimate + pooled)")
            t5_ctx = conditioning_c["context"] if conditioning_c else None
            context, y = sd3_text_conditioning(pen_l, pen_g, pooled_l, pooled_g, t5_ctx)
            return ({"context": context, "pooled": y},)
        if mode == "flux":
            if conditioning_b.get("pooled") is None:
                raise ValueError("flux mode needs a CLIP conditioning (pooled) as b")
            return ({"context": conditioning_a["context"], "pooled": conditioning_b["pooled"]},)
        from .models.text_encoders import sdxl_text_conditioning

        pen_l = conditioning_a.get("penultimate")
        pen_g, pooled_g = conditioning_b.get("penultimate"), conditioning_b.get("pooled")
        if pen_l is None or pen_g is None or pooled_g is None:
            raise ValueError("sdxl mode needs CLIP-L as a and OpenCLIP-G (with "
                             "text_projection) as b, both from TPUTextEncode")
        context, y = sdxl_text_conditioning(pen_l, pen_g, pooled_g, width=width, height=height)
        return ({"context": context, "pooled": y},)


class TPUEmptyLatent:
    """(width, height, batch) → LATENT of zeros (NHWC, f32) on the run's device."""

    DESCRIPTION = "Allocate an empty latent batch for sampling."
    RETURN_TYPES = ("LATENT",)
    RETURN_NAMES = ("latent",)
    FUNCTION = "generate"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "width": ("INT", {"default": 512, "min": 16, "max": 8192, "step": 8}),
                "height": ("INT", {"default": 512, "min": 16, "max": 8192, "step": 8}),
                "batch_size": ("INT", {"default": 1, "min": 1, "max": 64}),
                "channels": ("INT", {"default": 4, "min": 1, "max": 64}),
            },
            "hidden": DEVICE_INPUT,
        }

    def generate(self, width: int, height: int, batch_size: int, channels: int = 4,
                 device=None):
        return ({"samples": torch.zeros((batch_size, height // 8, width // 8, channels),
                                        device=resolve_device(device))},)


class TPUEmptyVideoLatent:
    """(width, height, frames, batch) → 5-D video LATENT of zeros (NTHWC, f32) on
    the run's device, for the Wan family; the frame count follows the causal 4k+1
    schedule (81 by convention)."""

    DESCRIPTION = "Allocate an empty video latent batch (Wan-class, 5-D)."
    RETURN_TYPES = ("LATENT",)
    RETURN_NAMES = ("latent",)
    FUNCTION = "generate"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "width": ("INT", {"default": 832, "min": 16, "max": 8192, "step": 16}),
                "height": ("INT", {"default": 480, "min": 16, "max": 8192, "step": 16}),
                "frames": ("INT", {"default": 81, "min": 1, "max": 1024, "step": 4,
                                   "tooltip": "pixel frames; must be 1 mod 4 "
                                              "(causal VAE schedule)"}),
                "batch_size": ("INT", {"default": 1, "min": 1, "max": 16}),
                "channels": ("INT", {"default": 16, "min": 1, "max": 64}),
            },
            "hidden": DEVICE_INPUT,
        }

    def generate(self, width: int, height: int, frames: int, batch_size: int,
                 channels: int | None = None, device=None):
        from .models.video_vae import wan_vae_config

        cfg = wan_vae_config()
        t_lat = cfg.latent_frames(frames)  # raises on off-schedule counts
        f = cfg.spatial_factor
        if channels is None:
            channels = cfg.z_channels
        return ({"samples": torch.zeros((batch_size, t_lat, height // f, width // f, channels),
                                        device=resolve_device(device))},)


class TPUVAEEncode:
    """(VAE, IMAGE in [0, 1]) → LATENT: the img2img entry. ``seed`` >= 0 samples the
    posterior from a generator seeded with it; -1 takes the posterior mean."""

    DESCRIPTION = "Encode images to latents for img2img / inpaint workflows."
    RETURN_TYPES = ("LATENT",)
    RETURN_NAMES = ("latent",)
    FUNCTION = "encode"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {"vae": ("VAE", {}), "image": ("IMAGE", {})},
            "optional": {
                "seed": ("INT", {"default": -1, "min": -1, "max": 2**31 - 1,
                                 "tooltip": "-1 = deterministic posterior mean; >=0 samples "
                                            "the posterior"}),
                "tile_size": ("INT", {"default": 0, "min": 0, "max": 4096, "step": 32,
                                      "tooltip": "0 = no tiling (pixels, multiple of the VAE "
                                                 "factor; bounds encoder memory)"}),
            },
        }

    def encode(self, vae, image, seed: int = -1, tile_size: int = 0):
        from .models.vae import encode_maybe_tiled, images_to_vae_input

        x = images_to_vae_input(torch.as_tensor(image))
        if tile_size:
            if seed >= 0:
                raise ValueError("tiled encode is deterministic (posterior mean) — seeded "
                                 "sampling and tile_size are exclusive")
            return ({"samples": encode_maybe_tiled(vae, x, tile_size)},)
        rng = seed_generator(seed, vae.device) if seed >= 0 else None
        return ({"samples": vae.encode(x, rng)},)


# Resize methods of the two hi-res-fix siblings (latent and image space).
RESIZE_METHODS = ("nearest", "bilinear", "lanczos3")


class TPULatentUpscale:
    """(LATENT, scale) → LATENT resized in latent space: the hi-res-fix step between
    a low-resolution sample and a denoise < 1 KSampler pass."""

    DESCRIPTION = "Resize latents (hi-res fix); follow with a denoise<1 KSampler."
    RETURN_TYPES = ("LATENT",)
    RETURN_NAMES = ("latent",)
    FUNCTION = "upscale"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "latent": ("LATENT", {}),
                "scale": ("FLOAT", {"default": 2.0, "min": 0.25, "max": 8.0, "step": 0.25}),
                "method": (list(RESIZE_METHODS), {"default": "bilinear"}),
            }
        }

    def upscale(self, latent, scale: float, method: str = "bilinear",
                scale_w: float | None = None):
        """``scale_w`` (default ``scale``) resizes the width by its own factor."""
        if method not in RESIZE_METHODS:
            raise ValueError(f"method must be one of {RESIZE_METHODS}, got {method!r}")
        return (resize_latent(latent, scale, scale if scale_w is None else scale_w, method),)


def resize_latent(latent, scale_h: float, scale_w: float, method: str):
    """``latent`` resized by ``scale_h`` × ``scale_w`` to even sizes, by any
    ``ops.resize`` method; its noise mask follows bilinearly."""
    from .ops.resize import resize

    z = latent["samples"]
    h, w = z.shape[-3], z.shape[-2]

    def snap(v: float) -> int:
        # Even sizes: odd latents break the UNet's stride-2 skips and patchify.
        s = round(v)
        return s + (s % 2)

    th, tw = snap(h * scale_h), snap(w * scale_w)
    if th < 2 or tw < 2:
        raise ValueError(f"scale {scale_h} shrinks the {h}x{w} latent to {th}x{tw}")
    target = (*z.shape[:-3], th, tw, z.shape[-1])
    out = {**latent, "samples": resize(z, target, method=method)}
    if "noise_mask" in latent:
        m = latent["noise_mask"]
        out["noise_mask"] = resize(m, (*m.shape[:-3], th, tw, 1), method="bilinear")
    return out


class TPUSetLatentNoiseMask:
    """(LATENT, MASK) → LATENT with a noise mask: the sampler denoises where the mask
    is 1 and re-pins mask-0 regions to the input latent after every step."""

    DESCRIPTION = "Attach an inpainting mask to a latent (1 = regenerate)."
    RETURN_TYPES = ("LATENT",)
    RETURN_NAMES = ("latent",)
    FUNCTION = "set_mask"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"latent": ("LATENT", {}), "mask": ("MASK", {})}}

    def set_mask(self, latent, mask):
        from .ops.resize import resize

        samples = latent["samples"]
        m = torch.as_tensor(mask, dtype=torch.float32).to(samples.device)
        rank = m.ndim
        video = samples.ndim == 5
        if video and m.ndim == 3:
            m = m[:, None]  # a (B, H, W) mask on a video latent: every frame
        if m.ndim == samples.ndim - 1:
            m = m[..., None]
        if m.ndim != samples.ndim:
            raise ValueError(f"mask rank {rank} does not fit latent rank {samples.ndim} "
                             f"(expected a (B, H, W){' or (B, T, H, W)' if video else ''} mask)")
        spatial = tuple(samples.shape[1:-1])
        if tuple(m.shape[1:-1]) != spatial:
            target = (m.shape[0], *spatial, 1)
            if video and m.shape[1] == 1:
                target = (m.shape[0], 1, *spatial[1:], 1)
            m = resize(m, target, method="bilinear")
        return ({**latent, "noise_mask": m},)


def _scheduler_menu() -> list[str]:
    """The KSampler scheduler dropdown, from the sampling layer's registry."""
    from .sampling.k_samplers import SCHEDULER_NAMES

    return list(SCHEDULER_NAMES)


_SHIFT_WIDGET_DEFAULT = 1.15


def _shift_from_prefs(model, shift: float) -> float:
    """The flow shift the sampler runs with: a model's ``sampler_prefs["shift"]``
    (set by ModelSamplingSD3/Flux) when the widget is at its default (1.15), else
    the widget's value."""
    prefs = getattr(model, "sampler_prefs", None) or {}
    if shift == _SHIFT_WIDGET_DEFAULT and "shift" in prefs:
        return float(prefs["shift"])
    return shift


def _collect_control(positive) -> tuple:
    """Every ControlNet spec on the positive conditioning: its ``control`` tuple and
    the tags riding combined ``extras`` entries."""
    def tags(cond):
        c = cond.get("control") or ()
        return tuple(c) if isinstance(c, (list, tuple)) else (c,)

    specs = tags(positive)
    for e in positive.get("extras", ()):
        specs += tags(e)
    return specs


def _split_lora_delegate(model, positive):
    """(model, lora factors) for the sampler call: a baked-LoRA model that carries a
    ``lora_delegate`` samples through its unpatched base and per-request factors,
    unless the request also carries inpaint, i2v or several ControlNets."""
    delegate = getattr(model, "lora_delegate", None)
    if (delegate is None or not delegate.get("factors")
            or positive.get("inpaint") is not None or positive.get("i2v") is not None
            or len(_collect_control(positive)) > 1):
        return model, None
    return delegate["base"], delegate["factors"]


def _model_with_control(model, specs, inpaint=None, i2v=None):
    """Compose ControlNet residual injection, inpaint and Wan i2v conditioning into
    the MODEL (``apply_i2v_conditioning`` innermost, then
    ``apply_inpaint_conditioning``, then each ControlNet; stacked
    ControlNets sum). A ``ParallelModel`` is re-parallelized over its own chain and
    config. Control conditions every model call, cond and uncond alike (the host's
    ControlNetApplyAdvanced). The composition is cached on the model, keyed by the
    specs' identities, so a repeat run reuses it; a new setup replaces the entry
    and cleans up the old composition."""
    if not specs and not inpaint and not i2v:
        return model
    from .models.api import DiffusionModel
    from .models.controlnet import apply_control
    from .models.unet import apply_inpaint_conditioning
    from .models.wan import apply_i2v_conditioning

    key = tuple(
        (id(s["model"]), id(s["hint"]), float(s.get("strength", 1.0)),
         float(s.get("start_percent", 0.0)), float(s.get("end_percent", 1.0)))
        for s in specs
    ) + ((id(inpaint["mask"]), id(inpaint["masked_latent"])) if inpaint else ()) + (
        (id(i2v.get("cond")), id(i2v.get("clip_fea"))) if i2v else ())
    cached = getattr(model, "_control_composed", None)
    if cached is not None and cached[0] == key:
        return cached[1]

    def compose(base):
        if i2v:
            # Innermost: the Wan i2v channel-concat (and CLIP branch) wraps the raw
            # model; control residuals apply to the wrapped step.
            base = apply_i2v_conditioning(base, i2v.get("cond"), i2v.get("clip_fea"))
        if inpaint:
            base = apply_inpaint_conditioning(base, inpaint["mask"], inpaint["masked_latent"])
        for spec in specs:
            base = apply_control(base, spec["model"], spec["hint"],
                                 strength=float(spec.get("strength", 1.0)),
                                 start_percent=float(spec.get("start_percent", 0.0)),
                                 end_percent=float(spec.get("end_percent", 1.0)))
        return base

    if isinstance(model, ParallelModel):
        if model._pipeline_spec is not None:
            _log().info("ControlNet composition: batch==1 pipeline placement is unavailable "
                        "for the composed model — data-parallel/single-device routing only")
        base = DiffusionModel(module=model._module, config=model.model_config)
        composed = parallelize(compose(base), model.chain, config=model.config)
    else:
        if not isinstance(getattr(model, "module", None), torch.nn.Module):
            raise ValueError("ControlNet needs a MODEL holding a module — wire the loader "
                             "output (optionally through ParallelAnything) into the sampler")
        composed = compose(model)
    if cached is not None and hasattr(cached[1], "cleanup"):
        cached[1].cleanup()
    # The specs stay in the entry: the id()-based key holds only while they live.
    try:
        object.__setattr__(model, "_control_composed", (key, composed, specs, inpaint, i2v))
    except (AttributeError, TypeError):
        pass
    return composed


def _prepare_sampling_inputs(model, positive, negative, latent, rng=None):
    """The sampler nodes' shared boundary: conditioning broadcast to the latent batch,
    patch-size checks, the adm vector (unCLIP tags, or zeros), uncond kwargs and the
    multi-cond kwargs. Returns ``(model_cfg, context, pooled, uncond_context,
    uncond_kwargs, cond_extra)``."""
    from .sampling.k_samplers import broadcast_cond_batch

    shape = latent["samples"].shape
    batch = shape[0]
    dev = latent["samples"].device

    def bcast(arr):
        return broadcast_cond_batch(arr, batch)

    context = bcast(positive["context"])
    pooled = bcast(positive.get("pooled"))
    model_cfg = model_config_of(model)
    patch = getattr(model_cfg, "patch_size", None)
    if isinstance(patch, int):
        if [d for d in shape[1:3] if d % patch]:
            raise ValueError(f"latent spatial dims {tuple(shape[1:3])} must be multiples of "
                             f"the model patch size {patch}")
    if pooled is None and hasattr(model_cfg, "vec_in_dim"):
        _log().warning("FLUX-family model sampled without a pooled vector (y falls back to "
                       "zeros) — route T5 + CLIP conditioning through "
                       "TPUConditioningCombine(mode='flux')")
    uncond_context = bcast(negative["context"]) if negative else None
    uncond_kwargs = ({"y": bcast(negative["pooled"])}
                     if negative and negative.get("pooled") is not None else None)
    adm = getattr(model_cfg, "adm_in_channels", None)
    if positive.get("unclip") and adm:
        from .models.unet import unclip_adm

        pooled = bcast(unclip_adm(positive["unclip"], adm, generator=rng, device=dev))
        uncond_kwargs = {"y": (bcast(unclip_adm(negative["unclip"], adm, generator=rng,
                                                device=dev))
                               if negative and negative.get("unclip")
                               else torch.zeros_like(pooled))}
    elif adm:
        # No adm-shaped pooled: zeros, as the host does; a wrong-width pooled raises,
        # except SD2.x-unCLIP's 1024-wide text pooled, which is dropped.
        def adm_or_none(vec, what):
            if vec is not None and vec.shape[-1] != adm:
                if getattr(model_cfg, "context_dim", None) == 1024:
                    return None
                raise ValueError(
                    f"{what} pooled vector is {vec.shape[-1]}-wide but this model's adm "
                    f"head expects {adm} — route the prompt through CLIPTextEncodeSDXL / "
                    "TPUConditioningCombine(mode='sdxl')")
            return vec

        pooled = adm_or_none(pooled, "positive")
        if pooled is None:
            pooled = torch.zeros((batch, adm), device=dev)
        uncond_y = adm_or_none(uncond_kwargs.get("y") if uncond_kwargs else None, "negative")
        if negative:
            uncond_kwargs = {"y": uncond_y if uncond_y is not None
                             else torch.zeros((batch, adm), device=dev)}
    extras = [{**e, "context": bcast(e["context"]), "pooled": bcast(e.get("pooled"))}
              for e in positive.get("extras", ())]
    if negative and (negative.get("extras") or negative.get("area") is not None
                     or negative.get("area_pct") is not None
                     or negative.get("mask") is not None):
        _log().warning("combined/area NEGATIVE conditioning is not supported — sampling with "
                       "the primary negative prompt, full-frame")
    if positive.get("timestep_range") is not None:
        _log().warning("ConditioningSetTimestepRange on the PRIMARY positive cond is ignored — "
                       "route ranged prompts through ConditioningCombine so they ride the "
                       "extras, where the window gates them")
    if negative and negative.get("timestep_range") is not None:
        _log().warning("ConditioningSetTimestepRange on the NEGATIVE conditioning is not "
                       "supported — the negative prompt applies across the whole run")
    if negative and negative.get("control"):
        _log().warning("a ControlNet tag on the NEGATIVE conditioning is ignored — control "
                       "composes into the MODEL from the positive tag and conditions cond "
                       "AND uncond calls alike")
    cond_extra = {
        "extra_conds": extras,
        "cond_area": positive.get("area"),
        "cond_area_pct": positive.get("area_pct"),
        "cond_mask": positive.get("mask"),
        "cond_strength": float(positive.get("strength", 1.0)),
        "cond_mask_strength": float(positive.get("mask_strength", 1.0)),
    }
    return model_cfg, context, pooled, uncond_context, uncond_kwargs, cond_extra


def _sampler_names() -> list[str]:
    from .sampling.runner import SAMPLER_NAMES

    return list(SAMPLER_NAMES)


class TPUKSampler:
    """(MODEL, positive, negative, LATENT) → LATENT: the per-step driver, whose
    forwards run over the chain when the MODEL came from ParallelAnything.
    ``compile_loop`` captures the whole loop as one CUDA graph
    (``run_sampler(compile_loop=True)``)."""

    DESCRIPTION = "Sample latents with the loaded (optionally parallelized) model."
    RETURN_TYPES = ("LATENT",)
    RETURN_NAMES = ("latent",)
    FUNCTION = "sample"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "model": ("MODEL", {}),
                "positive": ("CONDITIONING", {}),
                "latent": ("LATENT", {}),
                "seed": ("INT", {"default": 0, "min": 0, "max": SEED_MAX}),
                "steps": ("INT", {"default": 20, "min": 1, "max": 200}),
                "cfg": ("FLOAT", {"default": 7.5, "min": 1.0, "max": 30.0}),
                "sampler_name": (_sampler_names(), {"default": "dpmpp_2m"}),
            },
            "optional": {
                "negative": ("CONDITIONING", {}),
                "guidance": ("FLOAT", {"default": 3.5, "min": 0.0, "max": 30.0,
                                       "tooltip": "flux-dev distilled guidance embed; 0 "
                                                  "disables (schnell)"}),
                "shift": ("FLOAT", {"default": 1.15, "min": 0.25, "max": 8.0,
                                    "tooltip": "rectified-flow timestep shift"}),
                "denoise": ("FLOAT", {"default": 1.0, "min": 0.01, "max": 1.0, "step": 0.01,
                                      "tooltip": "img2img strength: < 1 starts from the "
                                                 "input LATENT instead of noise"}),
                "scheduler": (_scheduler_menu(), {"default": "karras",
                                                  "tooltip": "sigma spacing for the "
                                                             "k-samplers"}),
                "cfg_rescale": ("FLOAT", {"default": 0.0, "min": 0.0, "max": 1.0, "step": 0.05,
                                          "tooltip": "CFG rescale phi: tames high-cfg "
                                                     "over-saturation"}),
                "compile_loop": ("BOOLEAN", {"default": False,
                                             "tooltip": "capture the whole denoise loop as "
                                                        "one CUDA graph (single-platform "
                                                        "chains; others run eager)"}),
            },
        }

    def sample(self, model, positive, latent, seed: int, steps: int, cfg: float,
               sampler_name: str, negative=None, guidance: float = 3.5, shift: float = 1.15,
               denoise: float = 1.0, scheduler: str = "karras", cfg_rescale: float = 0.0,
               compile_loop: bool = False):
        from .sampling.runner import run_sampler

        samples = latent["samples"]
        noise = initial_noise(seed, samples.shape, samples.device)
        rng = seed_generator(seed, samples.device)
        shift = _shift_from_prefs(model, shift)
        model_cfg, context, pooled, uncond_context, uncond_kwargs, cond_extra = (
            _prepare_sampling_inputs(model, positive, negative, latent, rng=rng))
        model, lora = _split_lora_delegate(model, positive)
        model = _model_with_control(model, _collect_control(positive),
                                    inpaint=positive.get("inpaint"), i2v=positive.get("i2v"))
        kwargs = {} if pooled is None else {"y": pooled}
        out = run_sampler(
            model, noise, context, sampler=sampler_name, steps=steps, cfg_scale=cfg,
            uncond_context=uncond_context, uncond_kwargs=uncond_kwargs, rng=rng, shift=shift,
            **cond_extra, guidance=guidance if guidance > 0 else None, scheduler=scheduler,
            cfg_rescale=cfg_rescale, compile_loop=compile_loop,
            prediction=getattr(model_cfg, "prediction", "eps"),
            init_latent=samples if (denoise < 1.0 or "noise_mask" in latent) else None,
            denoise=denoise, latent_mask=latent.get("noise_mask"), lora=lora, **kwargs)
        return ({"samples": out},)


class TPUKSamplerAdvanced:
    """The host's KSamplerAdvanced: a run over the step window
    [start_at_step, end_at_step) of the full ``steps`` schedule. ``add_noise =
    "disable"`` drives it with zero noise (the latent arrives noised);
    ``return_with_leftover_noise = "enable"`` stops at sigma[end_at_step], and with
    it disabled a window that ends early forces the last sigma to 0."""

    DESCRIPTION = "Sample a step window of the schedule (base→refiner driver)."
    RETURN_TYPES = ("LATENT",)
    RETURN_NAMES = ("latent",)
    FUNCTION = "sample"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "model": ("MODEL", {}),
                "add_noise": (["enable", "disable"], {"default": "enable"}),
                "noise_seed": ("INT", {"default": 0, "min": 0, "max": SEED_MAX}),
                "steps": ("INT", {"default": 20, "min": 1, "max": 200}),
                "cfg": ("FLOAT", {"default": 8.0, "min": 1.0, "max": 30.0}),
                "sampler_name": (_sampler_names(), {"default": "euler"}),
                "scheduler": (_scheduler_menu(), {"default": "normal"}),
                "positive": ("CONDITIONING", {}),
                "negative": ("CONDITIONING", {}),
                "latent_image": ("LATENT", {}),
                "start_at_step": ("INT", {"default": 0, "min": 0, "max": 10000}),
                "end_at_step": ("INT", {"default": 10000, "min": 0, "max": 10000}),
                "return_with_leftover_noise": (["enable", "disable"], {"default": "disable"}),
            },
            "optional": {
                "shift": ("FLOAT", {"default": 1.15, "min": 0.25, "max": 8.0}),
                "compile_loop": ("BOOLEAN", {"default": False}),
            },
        }

    def sample(self, model, add_noise: str, noise_seed: int, steps: int, cfg: float,
               sampler_name: str, scheduler: str, positive, negative, latent_image,
               start_at_step: int, end_at_step: int, return_with_leftover_noise: str,
               shift: float = 1.15, compile_loop: bool = False):
        from .sampling.runner import run_sampler

        latent = latent_image
        shift = _shift_from_prefs(model, shift)
        (sigmas,) = TPUBasicScheduler().get_sigmas(model, scheduler, steps, denoise=1.0,
                                                   shift=shift)
        realized = len(sigmas) - 1  # deduplicating schedulers may realise fewer
        start, end = min(start_at_step, realized), min(end_at_step, realized)
        if end <= start:
            return (dict(latent),)  # an empty window returns the latent
        sigmas = sigmas[start:end + 1].clone()
        if return_with_leftover_noise != "enable" and end < realized:
            sigmas[-1] = 0.0
        samples = latent["samples"]
        rng = seed_generator(noise_seed, samples.device)
        noise = (initial_noise(noise_seed, samples.shape, samples.device)
                 if add_noise == "enable" else torch.zeros_like(samples, dtype=torch.float32))
        model_cfg, context, pooled, uncond_context, uncond_kwargs, cond_extra = (
            _prepare_sampling_inputs(model, positive, negative, latent, rng=rng))
        model, lora = _split_lora_delegate(model, positive)
        model = _model_with_control(model, _collect_control(positive),
                                    inpaint=positive.get("inpaint"), i2v=positive.get("i2v"))
        kwargs = {} if pooled is None else {"y": pooled}
        out = run_sampler(
            model, noise, context, sampler=sampler_name, steps=max(1, len(sigmas) - 1),
            sigmas=sigmas, cfg_scale=cfg, uncond_context=uncond_context,
            uncond_kwargs=uncond_kwargs, rng=rng, shift=shift, **cond_extra,
            guidance=positive.get("guidance"), prediction=getattr(model_cfg, "prediction", "eps"),
            init_latent=samples, latent_mask=latent.get("noise_mask"),
            compile_loop=compile_loop, lora=lora, **kwargs)
        return ({"samples": out},)


class TPUVAEDecode:
    """(VAE, LATENT) → IMAGE floats in [0, 1]; tiled when ``tile_size`` > 0. With a
    decode queue installed (``serving/decode.py``; the server installs one beside
    its scheduler) an eligible latent batches into a shared decode with other
    prompts'; ineligible work (tiled, video) decodes inline."""

    DESCRIPTION = "Decode latents to images (auto-tiled for large resolutions)."
    RETURN_TYPES = ("IMAGE",)
    RETURN_NAMES = ("image",)
    FUNCTION = "decode"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {"vae": ("VAE", {}), "latent": ("LATENT", {})},
            "optional": {"tile_size": ("INT", {"default": 0, "min": 0, "max": 512,
                                               "tooltip": "0 = no tiling"})},
        }

    def decode(self, vae, latent, tile_size: int = 0):
        from .models.vae import decode_maybe_tiled, vae_output_to_images
        from .serving.decode import get_decode_queue

        q = get_decode_queue()
        if q is not None:
            ticket = q.submit(vae, latent["samples"], tile_size)
            if ticket is not None:
                return (vae_output_to_images(ticket.result()),)
        return (vae_output_to_images(decode_maybe_tiled(vae, latent["samples"], tile_size)),)


def resolve_save_target(filename_prefix: str, output_dir: str = "",
                        suffix: str = "png") -> tuple:
    """The save nodes' path rules: an empty ``output_dir`` is ``$PA_OUTPUT_DIR`` (else
    ``output``); the prefix may carry a subfolder; a prefix that escapes the output
    directory is rejected; numbering continues past the highest existing
    ``{name}_{N}.{suffix}``. Returns ``(target_dir, name, start_index)``."""
    import re

    output_dir = output_dir or os.environ.get("PA_OUTPUT_DIR", "output")
    subdir, name = os.path.split(filename_prefix)
    target_dir = os.path.join(output_dir, subdir) if subdir else output_dir
    root = os.path.realpath(output_dir)
    if os.path.commonpath([root, os.path.realpath(target_dir)]) != root:
        raise ValueError(f"filename_prefix {filename_prefix!r} resolves outside output_dir "
                         f"{output_dir!r}")
    os.makedirs(target_dir, exist_ok=True)
    pat = re.compile(re.escape(name) + r"_(\d+)\." + re.escape(suffix) + "$")
    taken = [int(m.group(1)) for f in os.listdir(target_dir) if (m := pat.match(f))]
    return target_dir, name, (max(taken) + 1 if taken else 0)


def _host_array(t):
    import numpy as np

    if torch.is_tensor(t):
        return t.detach().float().cpu().numpy()
    return np.asarray(t)


class TPUSaveImage:
    """IMAGE → numbered PNG files; returns their paths. The workflow (hidden
    ``prompt``) is embedded as the PNG's ``prompt`` text chunk, ``metadata`` as
    ``parameters``."""

    DESCRIPTION = "Save a batch of images as numbered PNGs."
    RETURN_TYPES = ("PATHS",)
    RETURN_NAMES = ("paths",)
    FUNCTION = "save"
    CATEGORY = CATEGORY
    OUTPUT_NODE = True

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "images": ("IMAGE", {}),
                "filename_prefix": ("STRING", {"default": "tpu"}),
            },
            "optional": {
                "output_dir": ("STRING", {"default": "",
                                          "tooltip": "empty = $PA_OUTPUT_DIR, else ./output"}),
                "metadata": ("STRING", {"default": "", "multiline": True,
                                        "tooltip": "embedded as the PNG 'parameters' text "
                                                   "chunk"}),
            },
            "hidden": {"prompt": "PROMPT"},
        }

    def save(self, images, filename_prefix: str = "tpu", output_dir: str = "",
             metadata: str = "", prompt=None):
        import json

        import numpy as np
        from PIL import Image

        target_dir, name, start = resolve_save_target(filename_prefix, output_dir, "png")
        arr = _host_array(images)
        if arr.ndim == 3:
            arr = arr[None]
        elif arr.ndim == 5:
            arr = arr.reshape((-1,) + arr.shape[2:])  # video: every frame its own file
        arr = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        pnginfo = None
        if metadata or prompt is not None:
            from PIL.PngImagePlugin import PngInfo

            pnginfo = PngInfo()
            if metadata:
                pnginfo.add_text("parameters", metadata)
            if prompt is not None:
                try:
                    pnginfo.add_text("prompt", json.dumps(prompt, default=repr))
                except Exception:  # noqa: BLE001 - an unserialisable graph still saves
                    pass
        paths = []
        for i, img in enumerate(arr):
            path = os.path.join(target_dir, f"{name}_{start + i:05d}.png")
            Image.fromarray(img).save(path, pnginfo=pnginfo)
            paths.append(path)
        return (tuple(paths),)


class TPULoadImage:
    """Image file → (IMAGE floats in [0, 1], MASK = 1 where the alpha is
    transparent, zeros without alpha), EXIF orientation applied, on the run's
    device."""

    DESCRIPTION = "Load an image file as IMAGE (+ alpha-derived MASK)."
    RETURN_TYPES = ("IMAGE", "MASK")
    RETURN_NAMES = ("image", "mask")
    FUNCTION = "load"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"image_path": ("STRING", {"default": ""})}, "hidden": DEVICE_INPUT}

    def load(self, image_path: str, device=None):
        import numpy as np
        from PIL import Image, ImageOps

        dev = resolve_device(device)
        img = ImageOps.exif_transpose(Image.open(image_path))
        # RGBA first: palette PNGs carry transparency without an 'A' band.
        rgba = np.asarray(img.convert("RGBA"), np.float32) / 255.0
        image = torch.from_numpy(np.ascontiguousarray(rgba[None, :, :, :3])).to(dev)
        alpha = rgba[None, :, :, 3]
        mask = (torch.from_numpy(1.0 - alpha).to(dev) if float(alpha.min()) < 1.0
                else torch.zeros(image.shape[:3], device=dev))
        return (image, mask)


class TPUImageScale:
    """IMAGE → IMAGE resized to an exact width/height (the image-space half of the
    hi-res-fix surface), clipped to [0, 1]."""

    DESCRIPTION = "Resize images to an exact width/height."
    RETURN_TYPES = ("IMAGE",)
    RETURN_NAMES = ("image",)
    FUNCTION = "scale"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "image": ("IMAGE", {}),
                "width": ("INT", {"default": 1024, "min": 8, "max": 16384, "step": 8}),
                "height": ("INT", {"default": 1024, "min": 8, "max": 16384, "step": 8}),
                "method": (list(RESIZE_METHODS), {"default": "bilinear"}),
            }
        }

    def scale(self, image, width: int, height: int, method: str = "bilinear"):
        from .ops.resize import resize

        if method not in RESIZE_METHODS:
            raise ValueError(f"method must be one of {RESIZE_METHODS}, got {method!r}")
        img = torch.as_tensor(image)
        if img.ndim == 3:
            img = img[None]
        out = resize(img, (img.shape[0], height, width, img.shape[-1]), method=method)
        return (torch.clamp(out, 0.0, 1.0),)


class TPURandomNoise:
    """seed → NOISE: the custom-sampling noise source; the sampler draws noise the
    latent's shape from the seed."""

    DESCRIPTION = "Noise source for the custom-sampling graph."
    RETURN_TYPES = ("NOISE",)
    RETURN_NAMES = ("noise",)
    FUNCTION = "get_noise"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"noise_seed": ("INT", {"default": 0, "min": 0, "max": SEED_MAX})}}

    def get_noise(self, noise_seed: int):
        return ({"seed": int(noise_seed)},)


class TPUKSamplerSelect:
    """sampler_name → SAMPLER (the host's KSamplerSelect)."""

    DESCRIPTION = "Pick the sampler for the custom-sampling graph."
    RETURN_TYPES = ("SAMPLER",)
    RETURN_NAMES = ("sampler",)
    FUNCTION = "get_sampler"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"sampler_name": (_sampler_names(), {"default": "euler"})}}

    def get_sampler(self, sampler_name: str):
        return ({"sampler": sampler_name},)


class TPUBasicScheduler:
    """(MODEL, scheduler, steps, denoise) → SIGMAS (the host's BasicScheduler): the
    named spacing over the model's sigma space (flow models: the shift-warped
    table), ``steps / denoise`` total with the last ``steps + 1`` kept."""

    DESCRIPTION = "Compute the sigma schedule for the custom-sampling graph."
    RETURN_TYPES = ("SIGMAS",)
    RETURN_NAMES = ("sigmas",)
    FUNCTION = "get_sigmas"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "model": ("MODEL", {}),
                "scheduler": (_scheduler_menu(), {"default": "normal"}),
                "steps": ("INT", {"default": 20, "min": 1, "max": 200}),
                "denoise": ("FLOAT", {"default": 1.0, "min": 0.01, "max": 1.0, "step": 0.01}),
            },
            "optional": {
                "shift": ("FLOAT", {"default": 1.15, "min": 0.25, "max": 8.0,
                                    "tooltip": "rectified-flow timestep shift (flow models)"}),
            },
        }

    def get_sigmas(self, model, scheduler: str, steps: int, denoise: float,
                   shift: float = 1.15):
        from .sampling.k_samplers import flow_sigma_table, make_sigmas

        shift = _shift_from_prefs(model, shift)
        total = max(steps, int(round(steps / denoise))) if denoise < 1.0 else steps
        if getattr(model_config_of(model), "prediction", "eps") == "flow":
            sigmas = make_sigmas(scheduler, total, sigma_table=flow_sigma_table(shift))
        else:
            sigmas = make_sigmas(scheduler, total)
        if denoise < 1.0:
            # run_sampler's guard: a schedule that realises fewer sigmas than asked
            # keeps the requested strength.
            realized = len(sigmas) - 1
            if realized > steps:
                sigmas = sigmas[-(steps + 1):]
            else:
                keep = min(realized, max(1, round(steps * realized / total)))
                sigmas = sigmas[-(keep + 1):]
        return (sigmas,)


class TPUFluxGuidance:
    """(CONDITIONING, guidance) → CONDITIONING tagged with FLUX-dev's distilled
    guidance."""

    DESCRIPTION = "Attach flux distilled guidance to a conditioning."
    RETURN_TYPES = ("CONDITIONING",)
    RETURN_NAMES = ("conditioning",)
    FUNCTION = "append"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"conditioning": ("CONDITIONING", {}),
                             "guidance": ("FLOAT", {"default": 3.5, "min": 0.0, "max": 100.0})}}

    def append(self, conditioning, guidance: float):
        return ({**conditioning, "guidance": float(guidance)},)


class TPUBasicGuider:
    """(MODEL, CONDITIONING) → GUIDER without CFG (distilled models)."""

    DESCRIPTION = "Guider without CFG (distilled models)."
    RETURN_TYPES = ("GUIDER",)
    RETURN_NAMES = ("guider",)
    FUNCTION = "get_guider"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"model": ("MODEL", {}), "conditioning": ("CONDITIONING", {})}}

    def get_guider(self, model, conditioning):
        return ({"model": model, "positive": conditioning, "negative": None, "cfg": 1.0},)


class TPUCFGGuider:
    """(MODEL, positive, negative, cfg) → GUIDER (the host's CFGGuider)."""

    DESCRIPTION = "Classifier-free-guidance guider."
    RETURN_TYPES = ("GUIDER",)
    RETURN_NAMES = ("guider",)
    FUNCTION = "get_guider"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"model": ("MODEL", {}), "positive": ("CONDITIONING", {}),
                             "negative": ("CONDITIONING", {}),
                             "cfg": ("FLOAT", {"default": 7.5, "min": 1.0, "max": 30.0})}}

    def get_guider(self, model, positive, negative, cfg: float):
        return ({"model": model, "positive": positive, "negative": negative,
                 "cfg": float(cfg)},)


class TPUDisableNoise:
    """→ NOISE of zeros: a later stage of a split-sigma graph continues from an
    already-noised latent."""

    DESCRIPTION = "Zero-noise source for split-sigma continuation stages."
    RETURN_TYPES = ("NOISE",)
    RETURN_NAMES = ("noise",)
    FUNCTION = "get_noise"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {}}

    def get_noise(self):
        return ({"seed": None},)


class TPUSplitSigmas:
    """(SIGMAS, step) → (high, low): the ladder cut at ``step``, the boundary sigma in
    both halves."""

    DESCRIPTION = "Split a sigma ladder for multi-stage sampling."
    RETURN_TYPES = ("SIGMAS", "SIGMAS")
    RETURN_NAMES = ("high_sigmas", "low_sigmas")
    FUNCTION = "split"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"sigmas": ("SIGMAS", {}),
                             "step": ("INT", {"default": 0, "min": 0, "max": 10000})}}

    def split(self, sigmas, step: int):
        return (sigmas[: step + 1], sigmas[step:])


class TPUFlipSigmas:
    """SIGMAS → SIGMAS reversed (unsampling); an exact-zero start becomes 1e-4."""

    DESCRIPTION = "Reverse a sigma ladder (unsampling)."
    RETURN_TYPES = ("SIGMAS",)
    RETURN_NAMES = ("sigmas",)
    FUNCTION = "flip"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"sigmas": ("SIGMAS", {})}}

    def flip(self, sigmas):
        flipped = torch.flip(torch.as_tensor(sigmas), dims=(0,)).clone()
        if float(flipped[0]) == 0.0:
            flipped[0] = 1e-4
        return (flipped,)


class TPUSamplerCustomAdvanced:
    """(NOISE, GUIDER, SAMPLER, SIGMAS, LATENT) → (output, denoised_output): the
    host's SamplerCustomAdvanced. The wired LATENT is the noising base; a partial
    flow run (final sigma > 0) stores its output un-interpolated (the host's
    inverse noise scaling). Both outputs are the same latent."""

    DESCRIPTION = "Custom-sampling driver (noise + guider + sampler + sigmas)."
    RETURN_TYPES = ("LATENT", "LATENT")
    RETURN_NAMES = ("output", "denoised_output")
    FUNCTION = "sample"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "noise": ("NOISE", {}),
                "guider": ("GUIDER", {}),
                "sampler": ("SAMPLER", {}),
                "sigmas": ("SIGMAS", {}),
                "latent_image": ("LATENT", {}),
            },
            "optional": {"compile_loop": ("BOOLEAN", {"default": False})},
        }

    def sample(self, noise, guider, sampler, sigmas, latent_image, compile_loop: bool = False):
        from .sampling.runner import run_sampler

        model = guider["model"]
        positive, negative = guider["positive"], guider.get("negative")
        samples = latent_image["samples"]
        seed = noise["seed"]
        rng = seed_generator(0 if seed is None else seed, samples.device)
        noise_arr = (torch.zeros_like(samples, dtype=torch.float32) if seed is None
                     else initial_noise(seed, samples.shape, samples.device))
        model_cfg, context, pooled, uncond_context, uncond_kwargs, cond_extra = (
            _prepare_sampling_inputs(model, positive, negative, latent_image, rng=rng))
        model = _model_with_control(model, _collect_control(positive),
                                    inpaint=positive.get("inpaint"), i2v=positive.get("i2v"))
        prediction = getattr(model_cfg, "prediction", "eps")
        out = run_sampler(
            model, noise_arr, context, sampler=sampler["sampler"], **cond_extra,
            steps=max(1, len(sigmas) - 1), sigmas=sigmas, cfg_scale=guider.get("cfg", 1.0),
            uncond_context=uncond_context, uncond_kwargs=uncond_kwargs, rng=rng,
            guidance=positive.get("guidance"), prediction=prediction, init_latent=samples,
            latent_mask=latent_image.get("noise_mask"), compile_loop=compile_loop,
            **({} if pooled is None else {"y": pooled}))
        s_last = float(sigmas[-1])
        if prediction == "flow" and s_last > 0:
            if s_last >= 1.0:
                raise ValueError(
                    "flow sigma ladder ends at 1.0 (pure noise): the partial-run inverse "
                    "noise scaling 1/(1-sigma) is undefined there. Split or flip the ladder "
                    "so the final sigma is below 1.")
            out = out / (1.0 - s_last)
        return ({"samples": out}, {"samples": out})


class TPUControlNetLoader:
    """ControlNet checkpoint file → CONTROL_NET (the base family sniffed from the
    context width)."""

    DESCRIPTION = "Load an SD-family ControlNet (family sniffed)."
    RETURN_TYPES = ("CONTROL_NET",)
    RETURN_NAMES = ("control_net",)
    FUNCTION = "load"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"ckpt_path": ("STRING", {"default": "",
                                                      "tooltip": "safetensors path"})},
                "hidden": DEVICE_INPUT}

    def load(self, ckpt_path: str, device=None):
        from . import models as M

        return ({"model": M.load_controlnet_checkpoint(ckpt_path,
                                                       device=resolve_device(device))},)


class TPUControlNetApply:
    """Tag a conditioning with ControlNet guidance; the sampler nodes compose the
    control trunk into the MODEL for the run (``_model_with_control``). ``image`` is
    the hint in pixels (8× the latent grid); chained Apply nodes stack."""

    DESCRIPTION = "Apply a ControlNet hint image to conditioning."
    RETURN_TYPES = ("CONDITIONING",)
    RETURN_NAMES = ("conditioning",)
    FUNCTION = "apply"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "conditioning": ("CONDITIONING", {}),
                "control_net": ("CONTROL_NET", {}),
                "image": ("IMAGE", {}),
                "strength": ("FLOAT", {"default": 1.0, "min": 0.0, "max": 10.0, "step": 0.01}),
            },
            "optional": {
                "start_percent": ("FLOAT", {"default": 0.0, "min": 0.0, "max": 1.0,
                                            "step": 0.001}),
                "end_percent": ("FLOAT", {"default": 1.0, "min": 0.0, "max": 1.0,
                                          "step": 0.001}),
            },
        }

    def apply(self, conditioning, control_net, image, strength: float = 1.0,
              start_percent: float = 0.0, end_percent: float = 1.0):
        img = torch.as_tensor(image)
        if img.ndim == 3:
            img = img[None]
        spec = {"model": control_net["model"], "hint": img, "strength": float(strength),
                "start_percent": float(start_percent), "end_percent": float(end_percent)}
        prior = conditioning.get("control") or ()
        prior = prior if isinstance(prior, (list, tuple)) else (prior,)
        return ({**conditioning, "control": tuple(prior) + (spec,)},)


class TPUInpaintModelConditioning:
    """(positive, negative, VAE, pixels, mask) → the conditioning pair tagged with the
    latent-resolution mask and the masked image's latent (for a 9-channel inpaint
    checkpoint), and the encoded source latent. Masked pixels go to 0.5 gray before
    encoding; ``noise_mask`` also pins the keep region each step."""

    DESCRIPTION = "Conditioning + latents for dedicated inpainting checkpoints."
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
                "pixels": ("IMAGE", {}),
                "mask": ("MASK", {}),
            },
            "optional": {"noise_mask": ("BOOLEAN", {"default": True})},
        }

    def encode(self, positive, negative, vae, pixels, mask, noise_mask: bool = True):
        from .models.vae import images_to_vae_input, normalize_mask
        from .ops.resize import resize

        px = images_to_vae_input(torch.as_tensor(pixels))
        m = normalize_mask(torch.as_tensor(mask).to(px.device), tuple(px.shape[1:3]))
        # In the VAE's [-1, 1] input space 0.5 gray is 0.
        masked_latent = vae.encode(px * (1.0 - m), None)
        latent = vae.encode(px, None)
        lat_mask = resize(m, (m.shape[0], *latent.shape[1:3], 1), method="nearest")
        tag = {"mask": lat_mask, "masked_latent": masked_latent}
        out_latent = {"samples": latent}
        if noise_mask:
            out_latent["noise_mask"] = lat_mask
        return ({**positive, "inpaint": tag}, {**negative, "inpaint": tag}, out_latent)


class TPUUpscaleModelLoader:
    """ESRGAN-family checkpoint → UPSCALE_MODEL (widths, depth and scale sniffed;
    both public key layouts, ``models/upscale.py``)."""

    DESCRIPTION = "Load an ESRGAN-family (RRDBNet) image upscaler."
    RETURN_TYPES = ("UPSCALE_MODEL",)
    RETURN_NAMES = ("upscale_model",)
    FUNCTION = "load"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"ckpt_path": ("STRING", {"default": "",
                                                      "tooltip": "safetensors path"})},
                "hidden": DEVICE_INPUT}

    def load(self, ckpt_path: str, device=None):
        from . import models as M

        return (M.load_upscale_checkpoint(ckpt_path, device=resolve_device(device)),)


class TPUImageUpscaleWithModel:
    """(UPSCALE_MODEL, IMAGE) → the model-upscaled IMAGE; large images run as
    overlapping tiles blended linearly."""

    DESCRIPTION = "Upscale images with an ESRGAN-family model (tiled)."
    RETURN_TYPES = ("IMAGE",)
    RETURN_NAMES = ("image",)
    FUNCTION = "upscale"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {"upscale_model": ("UPSCALE_MODEL", {}), "image": ("IMAGE", {})},
            "optional": {"tile": ("INT", {"default": 512, "min": 64, "max": 4096,
                                          "tooltip": "tile size for large images"})},
        }

    def upscale(self, upscale_model, image, tile: int = 512):
        from .models.upscale import upscale_image

        return (upscale_image(upscale_model, image, tile=tile),)


NODE_CLASS_MAPPINGS = {
    "ParallelAnything": ParallelAnything,
    "ParallelAnythingAdvanced": ParallelAnythingAdvanced,
    "ParallelDevice": ParallelDevice,
    "ParallelDeviceList": ParallelDeviceList,
    "TPUCheckpointLoader": TPUCheckpointLoader,
    "TPUCLIPLoader": TPUCLIPLoader,
    "TPUTextEncode": TPUTextEncode,
    "TPUConditioningCombine": TPUConditioningCombine,
    "TPUEmptyLatent": TPUEmptyLatent,
    "TPUEmptyVideoLatent": TPUEmptyVideoLatent,
    "TPUVAEEncode": TPUVAEEncode,
    "TPUSetLatentNoiseMask": TPUSetLatentNoiseMask,
    "TPULatentUpscale": TPULatentUpscale,
    "TPUKSampler": TPUKSampler,
    "TPUKSamplerAdvanced": TPUKSamplerAdvanced,
    "TPUVAEDecode": TPUVAEDecode,
    "TPUSaveImage": TPUSaveImage,
    "TPULoadImage": TPULoadImage,
    "TPUImageScale": TPUImageScale,
    "TPURandomNoise": TPURandomNoise,
    "TPUKSamplerSelect": TPUKSamplerSelect,
    "TPUBasicScheduler": TPUBasicScheduler,
    "TPUFluxGuidance": TPUFluxGuidance,
    "TPUBasicGuider": TPUBasicGuider,
    "TPUCFGGuider": TPUCFGGuider,
    "TPUSamplerCustomAdvanced": TPUSamplerCustomAdvanced,
    "TPUDisableNoise": TPUDisableNoise,
    "TPUSplitSigmas": TPUSplitSigmas,
    "TPUFlipSigmas": TPUFlipSigmas,
    "TPUControlNetLoader": TPUControlNetLoader,
    "TPUControlNetApply": TPUControlNetApply,
    "TPUUpscaleModelLoader": TPUUpscaleModelLoader,
    "TPUImageUpscaleWithModel": TPUImageUpscaleWithModel,
    "TPUInpaintModelConditioning": TPUInpaintModelConditioning,
}

NODE_DISPLAY_NAME_MAPPINGS = {
    "ParallelAnything": "Parallel Anything (True Multi-Device TPU)",
    "ParallelAnythingAdvanced": "Parallel Anything (Advanced: FSDP/TP)",
    "ParallelDevice": "Parallel Device Config",
    "ParallelDeviceList": "Parallel Device List (1-4x)",
    "TPUCheckpointLoader": "Load Checkpoint (TPU)",
    "TPUCLIPLoader": "Load Text Encoder (TPU)",
    "TPUTextEncode": "Text Encode (TPU)",
    "TPUSaveImage": "Save Image (TPU)",
    "TPULoadImage": "Load Image (TPU)",
    "TPUImageScale": "Image Scale (TPU)",
    "TPUConditioningCombine": "Conditioning Combine (TPU, SDXL/FLUX)",
    "TPUEmptyLatent": "Empty Latent (TPU)",
    "TPUEmptyVideoLatent": "Empty Video Latent (TPU, WAN)",
    "TPUVAEEncode": "VAE Encode (TPU)",
    "TPUSetLatentNoiseMask": "Set Latent Noise Mask (TPU)",
    "TPULatentUpscale": "Latent Upscale (TPU)",
    "TPUKSampler": "KSampler (TPU)",
    "TPUKSamplerAdvanced": "KSampler Advanced (TPU)",
    "TPUVAEDecode": "VAE Decode (TPU)",
    "TPURandomNoise": "Random Noise (TPU)",
    "TPUKSamplerSelect": "KSampler Select (TPU)",
    "TPUBasicScheduler": "Basic Scheduler (TPU)",
    "TPUFluxGuidance": "Flux Guidance (TPU)",
    "TPUBasicGuider": "Basic Guider (TPU)",
    "TPUCFGGuider": "CFG Guider (TPU)",
    "TPUSamplerCustomAdvanced": "Sampler Custom Advanced (TPU)",
    "TPUDisableNoise": "Disable Noise (TPU)",
    "TPUSplitSigmas": "Split Sigmas (TPU)",
    "TPUFlipSigmas": "Flip Sigmas (TPU)",
    "TPUControlNetLoader": "Load ControlNet (TPU)",
    "TPUControlNetApply": "Apply ControlNet (TPU)",
    "TPUUpscaleModelLoader": "Load Upscale Model (TPU)",
    "TPUImageUpscaleWithModel": "Upscale Image With Model (TPU)",
    "TPUInpaintModelConditioning": "Inpaint Model Conditioning (TPU)",
}

# The stock-ComfyUI class-name shims (CheckpointLoaderSimple, CLIPTextEncode,
# KSampler, ...), merged with setdefault: native names win.
from . import nodes_compat as _compat  # noqa: E402  (needs the classes above)

_compat.register(NODE_CLASS_MAPPINGS, NODE_DISPLAY_NAME_MAPPINGS)
