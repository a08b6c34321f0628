"""End-to-end text→image: tokenize → encode → (parallel) denoise → decode
(counterpart of ``comfyui_parallelanything_tpu/pipelines.py``).

``StableDiffusionPipeline`` (SD1.5 / SD2.x / SDXL: CLIP context, SDXL's pooled
and size vector, k-sampler or DDIM sampling with batched CFG), ``FluxPipeline``
(T5 context + CLIP-L pooled vector, flow-matching sampling) and ``Sd3Pipeline``
(CLIP-L ‖ G joint stream padded into the T5 context, L ⊕ G pooled vector, true
CFG, flow shift 3) are ported, each with txt2img, img2img and inpainting through
``run_sampler`` and a VAE decode. The diffusion model slot takes a bare
``DiffusionModel`` or the ``ParallelModel`` ``parallelize`` returns, so every
sampler step runs over the device chain. ``WanVideoPipeline`` is not ported yet
(ROADMAP Queue 1, the other model families).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .models.text_encoders import sd3_text_conditioning, sdxl_text_conditioning
from .models.vae import images_to_vae_input, vae_output_to_images
from .ops.resize import resize
from .parallel.orchestrator import model_config_of
from .sampling.runner import run_sampler


def initial_noise(shape: tuple[int, ...], generator: torch.Generator | None,
                  device) -> torch.Tensor:
    """The sampler's starting N(0, 1) latent, f32, drawn from ``generator`` (a
    generator seeded with 0 on ``device`` when None)."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return torch.randn(shape, generator=generator, dtype=torch.float32, device=device)


def _match_negatives(prompts: list[str], negative_prompt) -> list[str]:
    """Broadcast a str negative to the batch; validate list lengths here (a
    mismatch otherwise surfaces as a shape error deep inside the model)."""
    if isinstance(negative_prompt, str):
        return [negative_prompt] * len(prompts)
    negatives = list(negative_prompt)
    if len(negatives) != len(prompts):
        raise ValueError(
            f"negative_prompt list has {len(negatives)} entries for {len(prompts)} prompts")
    return negatives


def _encode_init(vae, init, denoise: float, batch: int, expect: tuple[int, ...],
                 what: str = "init_image", allow_full_denoise: bool = False):
    """Strength-seeded sampling entry: validate the (denoise, init) pairing, check
    the pixel shape against ``expect`` (the dims after batch), encode, and
    broadcast a batch-1 init to the prompt batch. ``allow_full_denoise`` lifts the
    denoise < 1 requirement (inpainting keeps regions through the mask)."""
    if init is None:
        if denoise < 1.0:
            raise ValueError(
                f"denoise < 1 without an {what} — partial strength needs something "
                f"to preserve; pass {what} or drop denoise")
        return None
    if denoise >= 1.0 and not allow_full_denoise:
        raise ValueError(f"{what} given but denoise=1.0 — lower denoise (strength) so it "
                         "actually seeds the sampler")
    init = torch.as_tensor(init)
    got = tuple(init.shape[1 : 1 + len(expect)])
    if got != tuple(expect):
        raise ValueError(f"{what} is {got}, pipeline is {tuple(expect)}")
    z = vae.encode(images_to_vae_input(init))
    if z.shape[0] == 1 and batch > 1:
        z = z.repeat_interleave(batch, dim=0)
    return z


def _latent_mask_for(mask, init, f: int, height: int, width: int,
                     what: str = "init_image") -> torch.Tensor | None:
    """Inpainting mask (B, H, W[, 1]) → latent-resolution blend mask (1 =
    regenerate), resized bilinearly as ``jax.image.resize`` does."""
    if mask is None:
        return None
    if init is None:
        raise ValueError(f"mask (inpainting) requires {what}")
    m = torch.as_tensor(mask).float()
    if m.ndim == 3:
        m = m[..., None]
    if m.ndim != 4:
        raise ValueError(f"mask rank {m.ndim} does not fit an image latent")
    return resize(m, (m.shape[0], height // f, width // f, 1), method="bilinear")


def _start_latents(vae, batch: int, height: int, width: int, rng, init_image, denoise: float,
                   mask):
    """What every pipeline hands the sampler from the VAE's side, on the VAE's
    device: the initial noise (``initial_noise``), the inpainting blend mask or None
    (``_latent_mask_for``) and the encoded init image or None (``_encode_init``)."""
    f = vae.spatial_factor
    device = vae.device
    noise = initial_noise((batch, height // f, width // f, vae.cfg.z_channels), rng, device)
    latent_mask = _latent_mask_for(mask, init_image, f, height, width)
    if latent_mask is not None:
        latent_mask = latent_mask.to(device)
    init_latent = _encode_init(vae, init_image, denoise, batch, (height, width),
                               allow_full_denoise=mask is not None)
    return noise, latent_mask, init_latent


@dataclasses.dataclass
class StableDiffusionPipeline:
    """SD1.5 / SD2.x (``clip`` only) and SDXL (``clip`` + ``clip_g``) text→image.

    ``unet`` may be a ``DiffusionModel`` or a ``ParallelModel`` (``parallelize``
    first to run each denoise step over the device chain); its config's
    ``prediction`` ("eps" or "v") selects the parameterization."""

    unet: Any
    vae: Any  # 4-channel autoencoder (models.vae.VAE)
    clip: Any  # CLIP-L (SD1.5) or OpenCLIP-H (SD2.x) TextEncoder
    tokenizer: Any  # prompts -> (ids, mask)
    clip_g: Any = None  # SDXL's second tower (OpenCLIP-G)
    tokenizer_g: Any = None
    # SD2.x conditions on the penultimate layer ("penultimate"; with
    # open_clip_h_config the tower applies SD2's ln_final to it), SD1.5 on the
    # final layer-normed stream ("last").
    clip_layer: str = "last"

    @property
    def is_sdxl(self) -> bool:
        return self.clip_g is not None

    def encode_prompt(self, prompts: list[str], height: int, width: int):
        """Prompts → (context, y) for the UNet family in use (y is None but for SDXL)."""
        ids, _ = self.tokenizer(prompts)
        last, penultimate, _pooled = self.clip(ids)
        if not self.is_sdxl:
            if self.clip_layer not in ("last", "penultimate"):
                raise ValueError(
                    f"clip_layer must be 'last' or 'penultimate', got {self.clip_layer!r}")
            return (penultimate if self.clip_layer == "penultimate" else last), None
        ids_g, _ = (self.tokenizer_g or self.tokenizer)(prompts)
        _, pen_g, pooled_g = self.clip_g(ids_g)
        return sdxl_text_conditioning(penultimate, pen_g, pooled_g, width=width, height=height)

    def __call__(
        self,
        prompt: str | list[str],
        negative_prompt: str | list[str] = "",
        *,
        steps: int = 30,
        cfg_scale: float = 7.5,
        height: int = 512,
        width: int = 512,
        rng: torch.Generator | None = None,
        sampler: str = "dpmpp_2m",
        karras: bool = True,
        scheduler: str | None = None,
        callback=None,
        init_image=None,
        denoise: float = 1.0,
        mask=None,
        compile_loop: bool = False,
    ) -> torch.Tensor:
        """Returns float images (B, height, width, 3) in [0, 1]. ``rng`` draws the
        initial noise and seeds the stochastic samplers' per-step noise (a
        generator seeded with 0 when None). CFG runs when ``cfg_scale != 1``, the
        uncond half on ``negative_prompt`` (SDXL: with its own pooled ``y``).
        img2img: ``init_image`` (B or 1, height, width, 3 in [0, 1]) with
        ``denoise < 1``; inpainting: ``mask`` (B or 1, height, width[, 1]; 1 =
        regenerate) at any denoise."""
        prompts = [prompt] if isinstance(prompt, str) else list(prompt)
        negatives = _match_negatives(prompts, negative_prompt)
        f = self.vae.spatial_factor
        if height % f or width % f:
            raise ValueError(f"height/width must be multiples of {f}")

        context, y = self.encode_prompt(prompts, height, width)
        use_cfg = cfg_scale != 1.0
        uncond_context = None
        uncond_kwargs = None
        if use_cfg:
            uncond_context, uncond_y = self.encode_prompt(negatives, height, width)
            if uncond_y is not None:
                uncond_kwargs = {"y": uncond_y}

        kwargs = {} if y is None else {"y": y}
        if sampler == "flow_euler":
            raise ValueError("flow_euler belongs to FluxPipeline, not the SD family")
        noise, latent_mask, init_latent = _start_latents(
            self.vae, len(prompts), height, width, rng, init_image, denoise, mask)
        latents = run_sampler(
            self.unet, noise, context, init_latent=init_latent, denoise=denoise,
            latent_mask=latent_mask,
            prediction=getattr(model_config_of(self.unet), "prediction", "eps"),
            sampler=sampler, steps=steps, cfg_scale=cfg_scale if use_cfg else 1.0,
            uncond_context=uncond_context, uncond_kwargs=uncond_kwargs, rng=rng,
            karras=karras, scheduler=scheduler, callback=callback,
            compile_loop=compile_loop, **kwargs,
        )
        return vae_output_to_images(self.vae.decode(latents))


@dataclasses.dataclass
class FluxPipeline:
    """FLUX / Z-Image flow-matching text→image: T5 context + CLIP-L pooled vec."""

    dit: Any  # FLUX-class DiffusionModel or ParallelModel
    vae: Any  # 16-channel autoencoder (models.vae.VAE)
    clip: Any  # CLIP-L TextEncoder (pooled y)
    t5: Any  # T5 TextEncoder (context)
    tokenizer: Any  # CLIP tokenizer
    t5_tokenizer: Any

    def encode_prompt(self, prompts: list[str]):
        ids, _ = self.tokenizer(prompts)
        _, _, pooled = self.clip(ids)
        t5_ids, t5_mask = self.t5_tokenizer(prompts)
        context = self.t5(t5_ids, mask=t5_mask)
        return context, pooled

    def __call__(
        self,
        prompt: str | list[str],
        *,
        steps: int = 20,
        sampler: str = "flow_euler",
        guidance: float | None = 3.5,
        shift: float = 1.15,
        height: int = 1024,
        width: int = 1024,
        rng: torch.Generator | None = None,
        negative_prompt: str | list[str] | None = None,
        cfg_scale: float = 1.0,
        callback=None,
        init_image=None,
        denoise: float = 1.0,
        mask=None,
        compile_loop: bool = False,
    ) -> torch.Tensor:
        """Returns float images (B, height, width, 3) in [0, 1]. ``guidance`` is the
        dev-family distilled guidance embed (None for schnell); true CFG runs only
        when ``negative_prompt`` + ``cfg_scale != 1`` are given. ``rng`` draws the
        initial noise (a generator seeded with 0 when None). img2img:
        ``init_image`` (B or 1, height, width, 3 in [0, 1]) with ``denoise < 1``;
        inpainting: ``mask`` (B or 1, height, width[, 1]; 1 = regenerate) at any
        denoise."""
        prompts = [prompt] if isinstance(prompt, str) else list(prompt)
        f = self.vae.spatial_factor
        patch = getattr(model_config_of(self.dit), "patch_size", 2)
        unit = f * patch  # VAE factor × DiT patchify
        if height % unit or width % unit:
            raise ValueError(f"height/width must be multiples of {unit}")
        context, pooled = self.encode_prompt(prompts)
        uncond_context = None
        uncond_kwargs = None
        kwargs: dict[str, Any] = {"y": pooled}
        use_cfg = cfg_scale != 1.0 and negative_prompt is not None
        if use_cfg:
            negatives = _match_negatives(prompts, negative_prompt)
            uncond_context, uncond_pooled = self.encode_prompt(negatives)
            uncond_kwargs = {"y": uncond_pooled}

        noise, latent_mask, init_latent = _start_latents(
            self.vae, len(prompts), height, width, rng, init_image, denoise, mask)
        latents = run_sampler(
            self.dit, noise, context, sampler=sampler, prediction="flow", steps=steps,
            shift=shift, guidance=guidance, cfg_scale=cfg_scale if use_cfg else 1.0,
            uncond_context=uncond_context, uncond_kwargs=uncond_kwargs, callback=callback,
            compile_loop=compile_loop, init_latent=init_latent, denoise=denoise,
            latent_mask=latent_mask, **kwargs,
        )
        return vae_output_to_images(self.vae.decode(latents))


@dataclasses.dataclass
class Sd3Pipeline:
    """SD3 / SD3.5 flow-matching text→image: the CLIP-L ‖ CLIP-G joint stream
    padded into the T5 context, the L ⊕ G pooled vector, true CFG, a large flow
    shift."""

    dit: Any  # MMDiT-class DiffusionModel or ParallelModel
    vae: Any  # 16-channel SD3 autoencoder (models.vae.VAE)
    clip: Any  # CLIP-L TextEncoder
    clip_g: Any  # OpenCLIP-G TextEncoder
    tokenizer: Any
    tokenizer_g: Any = None
    t5: Any = None  # optional (SD3 runs without T5 at reduced quality)
    t5_tokenizer: Any = None

    def encode_prompt(self, prompts: list[str]):
        """Prompts → (context, y): the joint CLIP (and T5) context and the pooled
        vector, both f32."""
        ids, _ = self.tokenizer(prompts)
        _, pen_l, pooled_l = self.clip(ids)
        ids_g, _ = (self.tokenizer_g or self.tokenizer)(prompts)
        _, pen_g, pooled_g = self.clip_g(ids_g)
        t5_ctx = None
        if self.t5 is not None:
            if self.t5_tokenizer is None:
                raise ValueError("t5 encoder set without t5_tokenizer — the CLIP BPE "
                                 "tokenizer's ids are meaningless to the T5 vocab")
            t5_ids, t5_mask = self.t5_tokenizer(prompts)
            t5_ctx = self.t5(t5_ids, mask=t5_mask)
        ctx_dim = getattr(model_config_of(self.dit), "context_in_dim", 4096)
        return sd3_text_conditioning(pen_l, pen_g, pooled_l, pooled_g, t5_ctx,
                                     context_dim=ctx_dim)

    def __call__(
        self,
        prompt: str | list[str],
        negative_prompt: str | list[str] = "",
        *,
        steps: int = 28,
        sampler: str = "flow_euler",
        cfg_scale: float = 4.5,
        shift: float = 3.0,
        height: int = 1024,
        width: int = 1024,
        rng: torch.Generator | None = None,
        callback=None,
        init_image=None,
        denoise: float = 1.0,
        mask=None,
        compile_loop: bool = False,
    ) -> torch.Tensor:
        """Returns float images (B, height, width, 3) in [0, 1]. CFG runs when
        ``cfg_scale != 1``, the uncond half on ``negative_prompt`` with its own
        pooled ``y``. ``rng`` draws the initial noise (a generator seeded with 0
        when None). img2img and inpainting as ``FluxPipeline``."""
        prompts = [prompt] if isinstance(prompt, str) else list(prompt)
        f = self.vae.spatial_factor
        patch = getattr(model_config_of(self.dit), "patch_size", 2)
        unit = f * patch
        if height % unit or width % unit:
            raise ValueError(f"height/width must be multiples of {unit}")

        context, y = self.encode_prompt(prompts)
        use_cfg = cfg_scale != 1.0
        uncond_context = None
        uncond_kwargs = None
        if use_cfg:
            uncond_context, uncond_y = self.encode_prompt(
                _match_negatives(prompts, negative_prompt))
            uncond_kwargs = {"y": uncond_y}

        noise, latent_mask, init_latent = _start_latents(
            self.vae, len(prompts), height, width, rng, init_image, denoise, mask)
        latents = run_sampler(
            self.dit, noise, context, sampler=sampler, prediction="flow", steps=steps,
            shift=shift, cfg_scale=cfg_scale if use_cfg else 1.0,
            uncond_context=uncond_context, uncond_kwargs=uncond_kwargs, callback=callback,
            compile_loop=compile_loop, init_latent=init_latent, denoise=denoise,
            latent_mask=latent_mask, y=y,
        )
        return vae_output_to_images(self.vae.decode(latents))
