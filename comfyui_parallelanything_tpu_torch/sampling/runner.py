"""Sampler dispatch shared by the pipelines (counterpart of
``comfyui_parallelanything_tpu/sampling/runner.py``).

The port has the rectified-flow sampler only: ``run_sampler(sampler="flow_euler")``
with the JAX runner's whole flow branch (shifted schedule, img2img truncation and
noising from ``init_latent`` + ``denoise``, ``latent_mask`` re-pinning, explicit
``sigmas``, true CFG). The other sampler names, the whole-loop compiled path,
per-request LoRA and combined/area conditioning raise ``NotImplementedError``
naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import torch

from .flow import flow_euler_sample, flow_timesteps

K_SAMPLER_NAMES = (
    "euler", "euler_ancestral", "heun", "dpm_2", "dpm_2_ancestral", "lms",
    "dpmpp_2s_ancestral", "dpmpp_sde", "dpmpp_2m", "dpmpp_2m_sde", "dpmpp_3m_sde",
    "lcm", "ddpm", "uni_pc", "uni_pc_bh2",
)
SAMPLER_NAMES = ("ddim", *K_SAMPLER_NAMES, "flow_euler")


def run_sampler(
    model,
    noise: torch.Tensor,
    context,
    *,
    sampler: str,
    steps: int,
    cfg_scale: float = 1.0,
    uncond_context=None,
    uncond_kwargs: dict | None = None,
    rng: torch.Generator | None = None,
    karras: bool = True,
    scheduler: str | None = None,
    shift: float = 1.0,
    guidance: float | None = None,
    callback=None,
    init_latent: torch.Tensor | None = None,
    denoise: float = 1.0,
    latent_mask: torch.Tensor | None = None,
    prediction: str = "eps",
    cfg_rescale: float = 0.0,
    compile_loop: bool = False,
    sigmas=None,
    extra_conds=None,
    cond_area=None,
    cond_area_pct=None,
    cond_mask=None,
    cond_strength: float = 1.0,
    cond_mask_strength: float = 1.0,
    lora: dict | None = None,
    **model_kwargs,
) -> torch.Tensor:
    """Drive ``model`` from ``noise`` (unit-variance N(0, 1)) to a clean latent.

    ``flow_euler``: the shift-warped flow schedule (``shift``), FLUX-dev's
    distilled ``guidance``, true CFG from ``cfg_scale`` + ``uncond_context``.
    img2img: with ``init_latent`` + ``denoise < 1`` the schedule for
    ``steps/denoise`` total steps is truncated to its last ``steps`` entries and
    ``init_latent`` is noised to its start (x_t = t·noise + (1−t)·x0).
    Inpainting: ``latent_mask`` (1 = denoise, 0 = keep ``init_latent``) re-pins the
    keep region to the init noised to each step's level after every step.
    ``sigmas`` is an explicit descending schedule: no construction, no
    ``denoise`` truncation, and a given ``init_latent`` is mixed in at
    ``sigmas[0]``. ``rng``, ``karras`` and ``scheduler`` do not apply to
    ``flow_euler``."""
    if sampler not in SAMPLER_NAMES:
        raise ValueError(f"unknown sampler {sampler!r} (have {', '.join(SAMPLER_NAMES)})")
    if sampler != "flow_euler":
        raise NotImplementedError(
            f"sampler {sampler!r} is not ported yet (ROADMAP Queue 1, The UNet slice: "
            "sampling/ddim.py, k_samplers.py and the rest of runner.py)")
    if compile_loop:
        raise NotImplementedError(
            "compile_loop=True, the whole-loop compiled sampler, is not ported yet "
            "(ROADMAP Queue 1, Serving: sampling/compiled.py)")
    if lora:
        raise NotImplementedError(
            "per-request LoRA is not ported yet (ROADMAP Queue 1, Nodes and host: "
            "models/lora.py)")
    if (extra_conds or cond_area is not None or cond_area_pct is not None
            or cond_mask is not None):
        raise NotImplementedError(
            "combined/area conditioning lives in the k-sampler family's EpsDenoiser, "
            "not ported yet (ROADMAP Queue 1, The UNet slice)")
    use_cfg = cfg_scale != 1.0 and uncond_context is not None
    eff_cfg = cfg_scale if use_cfg else 1.0
    if not 0.0 < denoise <= 1.0:
        raise ValueError(f"denoise must be in (0, 1], got {denoise}")
    if latent_mask is not None and init_latent is None:
        raise ValueError("latent_mask requires init_latent (the kept content)")
    if prediction == "v":
        raise ValueError("flow_euler is velocity-parameterized already; "
                         "prediction='v' applies to the eps-family samplers")
    img2img = init_latent is not None and denoise < 1.0
    total = max(steps, int(round(steps / denoise))) if img2img else steps

    if sigmas is not None:
        ts = torch.as_tensor(sigmas, dtype=torch.float32).cpu()
        x = ts[0] * noise
        if init_latent is not None:
            x = x + (1.0 - ts[0]) * init_latent
    else:
        ts = flow_timesteps(total, shift)
        x = noise
        if img2img:
            # x_t = t·noise + (1-t)·x0 under the v = noise - x0 flow.
            ts = ts[-(steps + 1):]
            x = ts[0] * noise + (1.0 - ts[0]) * init_latent

    cb = callback
    if latent_mask is not None:
        m, user = latent_mask, callback

        def cb(i, x):
            """Blend the keep region back after each step; the user callback (which
            may replace x) runs on the blended latent."""
            keep = (1.0 - ts[i + 1]) * init_latent + ts[i + 1] * noise
            x = x * m + keep * (1.0 - m)
            if user is not None:
                out = user(i, x)
                x = x if out is None else out
            return x

    return flow_euler_sample(
        model, x, context, steps=steps, shift=shift, guidance=guidance,
        cfg_scale=eff_cfg, uncond_context=uncond_context, uncond_kwargs=uncond_kwargs,
        callback=cb, ts=ts, cfg_rescale=cfg_rescale, **model_kwargs,
    )
