"""End-to-end text→image and text→video: tokenize → encode → (parallel) denoise →
decode (counterpart of ``comfyui_parallelanything_tpu/pipelines.py``).

``StableDiffusionPipeline`` (SD1.5 / SD2.x / SDXL: CLIP context, SDXL's pooled
and size vector, k-sampler or DDIM sampling with batched CFG), ``FluxPipeline``
(T5 context + CLIP-L pooled vector, flow-matching sampling) and ``Sd3Pipeline``
(CLIP-L ‖ G joint stream padded into the T5 context, L ⊕ G pooled vector, true
CFG, flow shift 3) are ported, each with txt2img, img2img and inpainting through
``run_sampler`` and a VAE decode. The diffusion model slot takes a bare
``DiffusionModel`` or the ``ParallelModel`` ``parallelize`` returns, so every
sampler step runs over the device chain. ``WanVideoPipeline`` (UMT5 context,
flow matching, the causal video VAE) covers text→video, video→video, video
inpainting and image→video (channel-concat conditioning and the Wan2.1 CLIP-vision
branch), and the Wan2.2 A14B expert pair.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .models.experts import WAN22_I2V_BOUNDARY, WAN22_T2V_BOUNDARY, TimestepExpertSwitch
from .models.text_encoders import sd3_text_conditioning, sdxl_text_conditioning
from .models.vae import decode_maybe_tiled, images_to_vae_input, vae_output_to_images
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
                     t_lat: int | None = None, what: str = "init_image") -> torch.Tensor | None:
    """Inpainting mask → latent-resolution blend mask (1 = regenerate), resized
    bilinearly as ``jax.image.resize`` does. Image masks are (B, H, W[, 1]); with
    ``t_lat`` set (video) masks are (B, T, H, W[, 1]) and the time axis resizes to
    the latent frame count."""
    if mask is None:
        return None
    if init is None:
        raise ValueError(f"mask (inpainting) requires {what}")
    m = torch.as_tensor(mask).float()
    rank = m.ndim
    want_rank = 4 if t_lat is None else 5
    if m.ndim == want_rank - 1:
        m = m[..., None]
    if m.ndim != want_rank:
        raise ValueError(f"mask rank {rank} does not fit a "
                         f"{'video' if t_lat is not None else 'image'} latent")
    target = ((m.shape[0], height // f, width // f, 1) if t_lat is None
              else (m.shape[0], t_lat, height // f, width // f, 1))
    return resize(m, target, method="bilinear")


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


@dataclasses.dataclass
class WanVideoPipeline:
    """Wan text→video: UMT5 context + flow matching + the causal 3D VAE.

    ``dit`` may be a ``DiffusionModel`` or a ``ParallelModel``. Wan2.2 A14B: a
    second, low-noise expert in ``dit_low_noise`` makes ``dit`` the high-noise one,
    and every step routes by flow time (``models/experts.py``)."""

    dit: Any  # Wan-class DiffusionModel or ParallelModel
    vae: Any  # VideoVAE (causal 3D)
    t5: Any  # UMT5/T5 TextEncoder (context)
    t5_tokenizer: Any
    dit_low_noise: Any = None
    boundary: float | None = None

    def encode_prompt(self, prompts: list[str]):
        ids, mask = self.t5_tokenizer(prompts)
        return self.t5(ids, mask=mask)

    def __call__(
        self,
        prompt: str | list[str],
        negative_prompt: str | list[str] = "",
        *,
        steps: int = 30,
        sampler: str = "flow_euler",
        cfg_scale: float = 5.0,
        shift: float = 5.0,
        height: int = 480,
        width: int = 832,
        frames: int = 81,
        rng: torch.Generator | None = None,
        decode_tile: int = 0,
        callback=None,
        init_video=None,
        denoise: float = 1.0,
        image=None,
        mask=None,
        clip_vision_output: Any | None = None,
        compile_loop: bool = False,
    ) -> torch.Tensor:
        """Returns float video (B, frames, height, width, 3) in [0, 1]. Wan runs true
        CFG (``cfg_scale != 1`` with the negative prompt, cond ‖ uncond in one
        batch) and a large flow shift; ``frames`` must be ≡ 1 mod the VAE's temporal
        factor (81 by convention). ``rng`` draws the initial noise (a generator
        seeded with 0 when None). video2video: ``init_video`` (B or 1, frames,
        height, width, 3 in [0, 1]) with ``denoise < 1``. image→video: ``image``
        (B or 1, height, width, 3 in [0, 1]) for an i2v checkpoint (the frame mask
        and the encoded first frame ride the DiT's extra in-channels); Wan2.1-style
        i2v checkpoints (config ``img_dim``) also take ``clip_vision_output`` (a
        CLIP_VISION_OUTPUT dict or a (B|1, 257, img_dim) tensor of penultimate
        states). Video inpainting: ``mask`` (B or 1, frames, height, width[, 1];
        1 = regenerate) with ``init_video`` re-pins the keep region every step."""
        prompts = [prompt] if isinstance(prompt, str) else list(prompt)
        denoiser = self.dit
        if self.dit_low_noise is not None:
            default_boundary = WAN22_I2V_BOUNDARY if image is not None else WAN22_T2V_BOUNDARY
            denoiser = TimestepExpertSwitch(
                self.dit, self.dit_low_noise,
                self.boundary if self.boundary is not None else default_boundary)
        f = self.vae.spatial_factor
        patch = getattr(model_config_of(denoiser), "patch_size", (1, 2, 2))
        unit_h, unit_w = f * patch[1], f * patch[2]
        if height % unit_h or width % unit_w:
            raise ValueError(f"height/width must be multiples of {unit_h}/{unit_w}")
        t_lat = self.vae.cfg.latent_frames(frames)  # validates the 4k+1 schedule
        if t_lat % patch[0]:
            raise ValueError(f"latent frame count {t_lat} not divisible by temporal patch "
                             f"{patch[0]}")

        context = self.encode_prompt(prompts)
        use_cfg = cfg_scale != 1.0
        uncond_context = None
        if use_cfg:
            uncond_context = self.encode_prompt(_match_negatives(prompts, negative_prompt))

        B = len(prompts)
        zc = self.vae.cfg.z_channels
        device = self.vae.device
        noise = initial_noise((B, t_lat, height // f, width // f, zc), rng, device)
        latent_mask = _latent_mask_for(mask, init_video, f, height, width, t_lat=t_lat,
                                       what="init_video")
        if latent_mask is not None:
            latent_mask = latent_mask.to(device)
        init_latent = _encode_init(self.vae, init_video, denoise, B, (frames, height, width),
                                   what="init_video", allow_full_denoise=mask is not None)
        if image is not None:
            denoiser = self._i2v_conditioned(denoiser, image, B, frames, height, width, t_lat,
                                             clip_vision_output=clip_vision_output)
        elif clip_vision_output is not None:
            raise ValueError("clip_vision_output without `image` — the CLIP branch rides "
                             "the i2v conditioning; pass the start image too")
        latents = run_sampler(
            denoiser, noise, context, sampler=sampler, prediction="flow", steps=steps,
            shift=shift, guidance=None, cfg_scale=cfg_scale if use_cfg else 1.0,
            uncond_context=uncond_context, callback=callback, compile_loop=compile_loop,
            init_latent=init_latent, denoise=denoise, latent_mask=latent_mask,
        )
        return vae_output_to_images(decode_maybe_tiled(self.vae, latents, decode_tile))

    def _i2v_conditioned(self, denoiser, image, B, frames, height, width, t_lat,
                         clip_vision_output=None):
        """``denoiser`` with Wan i2v channel-concat conditioning: the DiT's extra
        in-channels carry [frame mask (4) ‖ encoded first-frame latent] beside the
        noisy latent. The conditioning is fixed across steps, so one closure serves
        every sampler call (and every expert); CFG's doubled batch tiles it."""
        cfg = model_config_of(denoiser)
        zc = self.vae.cfg.z_channels
        expect = zc + 4 + zc
        got_in = getattr(cfg, "in_channels", None)
        if got_in is not None and got_in != expect:
            raise ValueError(
                f"image→video needs an i2v checkpoint with in_channels={expect} (latent "
                f"{zc} + mask 4 + cond {zc}); this model has {got_in} — load the i2v "
                "variant or drop `image`")
        image = torch.as_tensor(image, device=self.vae.device).float()
        if tuple(image.shape[1:3]) != (height, width):
            raise ValueError(f"image is {tuple(image.shape[1:3])}, pipeline is "
                             f"({height}, {width})")
        if image.shape[0] == 1 and B > 1:
            image = image.repeat_interleave(B, dim=0)
        # The conditioning clip: the image as frame 0, zeros after, encoded by the
        # same causal VAE, so the first latent frame holds the image.
        clip = torch.cat([images_to_vae_input(image)[:, None],
                          image.new_zeros((B, frames - 1, height, width, image.shape[-1]))],
                         dim=1)
        cond_latent = self.vae.encode(clip)
        del clip
        # 4-channel frame mask: the first latent frame given, the rest generated.
        h, w = cond_latent.shape[2], cond_latent.shape[3]
        frame_mask = cond_latent.new_zeros((B, t_lat, h, w, 4))
        frame_mask[:, 0] = 1.0
        cond = torch.cat([frame_mask, cond_latent], dim=-1)

        clip_fea = None
        if clip_vision_output is not None:
            if getattr(cfg, "img_dim", None) is None:
                raise ValueError(
                    "clip_vision_output needs a Wan2.1-style i2v checkpoint with the "
                    "img_emb branch (config img_dim) — this model has none (Wan2.2 i2v "
                    "conditions by channel-concat only); drop clip_vision_output")
            clip_fea = torch.as_tensor(
                clip_vision_output["penultimate"] if isinstance(clip_vision_output, dict)
                else clip_vision_output)
            if clip_fea.shape[0] == 1 and B > 1:
                clip_fea = clip_fea.repeat_interleave(B, dim=0)

        def conditioned(x, t, context=None, **kw):
            c, fea = cond, clip_fea
            if x.shape[0] != c.shape[0]:
                # CFG doubles the batch (cond ‖ uncond in one forward): the
                # conditioning rides along for both halves.
                reps = x.shape[0] // c.shape[0]
                c = c.repeat(reps, 1, 1, 1, 1)
                if fea is not None:
                    fea = fea.repeat(reps, 1, 1)
            if fea is not None:
                kw = {**kw, "clip_fea": fea}
            return denoiser(torch.cat([x, c.to(x.dtype)], dim=-1), t, context, **kw)

        return conditioned
