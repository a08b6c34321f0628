"""Sampler dispatch shared by the pipelines (counterpart of
``comfyui_parallelanything_tpu/sampling/runner.py``).

One table for every sampler name: ``flow_euler`` (the rectified-flow ladder),
``ddim`` (timestep-indexed, eps or v) and the k-sampler family (``SAMPLERS`` of
``k_samplers.py``, each over the KSampler scheduler menu, for eps, v and flow
models, with combined/area conditioning through ``EpsDenoiser``). img2img
truncation and noising, ``latent_mask`` re-pinning and explicit ``sigmas`` work on
every branch that takes them, as in the JAX runner. ``compile_loop=True`` runs
the whole loop as one captured CUDA graph (``compiled.py``) on every branch; the
eager loop stays where the JAX runner decides before the loop, from the caller's
inputs, and each such case is logged: a user callback, combined conditioning,
a weight-streaming model and a heterogeneous chain. A capture that fails
(``compiled.CaptureError``) takes the ``compile-eager`` rung
(``utils/degrade.py``), as the JAX runner's compile failure does: the rung is
recorded and the call runs the eager loop, with the stochastic samplers'
generator rewound to where the captured loop found it. An out-of-memory error or
a kernel that fails to build or launch raises instead. Per-request LoRA
(``lora=``, a factor map from ``models/lora.py``) rides a serving lane as per-lane
factors when a scheduler takes the run; every inline leg runs the eagerly merged
model (``lora_model``; a ControlNet composition is recomposed around its merged
base through its ``control_delegate``), as the JAX runner's inline legs do. With the
numerics sentinel on, the eager loops feed it their final latent's stats and digest
(``eager:k:<sampler>``, ``eager:ddim``, ``eager:flow``) as the captured loops do.

Continuous batching (``serving/``): with a scheduler installed
(``ContinuousBatchingScheduler.install()``, which ``server.py`` does for several
prompt workers), an eligible k-sampler run (a ``LaneStepSpec`` sampler, no user
callback, no ``compile_loop``) is handed to it and shares one batched model step
with the other requests in flight; the caller blocks until its lane retires.
Ineligible work (``maybe_submit`` returns None) and work the scheduler's OOM ladder
sheds (``DegradedToInline``) runs the inline path below, counted by
``pa_serving_inline_fallback_total{reason=}``. ``compile_loop=True`` callers
asked for the captured loop and are never handed over; their capture is made safe
beside the dispatcher in ``sampling/compiled.py``.

Every eager loop reports each step through ``utils/progress.report_progress``
(the progress hook, the latent preview hook, and the cooperative interrupt,
which raises ``Interrupted`` between steps), as the JAX runner's
``with_progress`` does. The captured loop is one CUDA graph replay: like the JAX
whole-loop XLA program it has no step boundaries, so it reports no steps, sends
no previews and cannot be interrupted mid-loop (the graph host still checks the
interrupt before and after the sampler node). A model's ``sampler_prefs`` dict
(set by schedule patch nodes such as RescaleCFG) supplies ``cfg_rescale`` when
the caller leaves it at 0.

Tracing (``utils/tracing.py``): every call is one ``sampler-run`` span, and the
eager loops record a ``step`` span per progress boundary: the host's dispatch
window of one step, since the eager loops do not synchronise per step and
tracing adds no synchronisation (the serving bucket's ``step`` spans end at its
synchronise and include device time). A captured loop records no per-step spans,
like the JAX whole-loop program.
"""

from __future__ import annotations

import functools
import logging

import torch

from .compiled import (
    compiled_ddim_sample,
    compiled_flow_sample,
    compiled_k_sample,
    emit_eager_numerics,
    trace_spec_of,
)
from ..utils import tracing
from ..utils.progress import report_progress
from .ddim import ddim_sample
from .flow import flow_euler_sample, flow_timesteps
from .k_samplers import (
    FLOW_REJECT,
    FLOW_VARIANTS,
    RNG_SAMPLERS,
    EpsDenoiser,
    flow_sigma_table,
    make_sigmas,
)
from .k_samplers import SAMPLERS as K_SAMPLERS
from .schedules import ddim_timesteps, scaled_linear_schedule

K_SAMPLER_NAMES = tuple(K_SAMPLERS)
SAMPLER_NAMES = ("ddim", *K_SAMPLER_NAMES, "flow_euler")

logger = logging.getLogger(__name__)


def _captured_or_none(call, sampler: str):
    """Run the captured loop (``call``). A capture failure takes the compile-eager
    rung: the rung is recorded and None returned, and the caller runs the eager
    loop. Anything else raises (an out-of-memory error has its own ladder; a kernel
    failure is never hidden)."""
    from ..utils.degrade import is_compile_failure, record_rung

    try:
        return call()
    except Exception as e:  # noqa: BLE001 - classified by the rung
        if not is_compile_failure(e):
            raise
        record_rung("compile-eager", f"{sampler}: {type(e).__name__}: {e}; eager loop "
                    "fallback", sampler=sampler)
        return None


def _compiled_spec(model, callback):
    """The ``TraceSpec`` for the whole-loop compiled path, or None with a logged
    reason (the caller runs the eager loop)."""
    if callback is not None:
        logger.info("compile_loop: a user callback cannot run inside the captured loop; "
                    "eager path")
        return None
    if getattr(model, "is_streaming", False):
        # Not a degradation: each eager step streams the stages (parallel/streaming.py),
        # where a captured loop would copy every weight into the graph's pool.
        logger.info("compile_loop: a weight-streaming model runs its stages from the eager "
                    "loop; eager path")
        return None
    spec = trace_spec_of(model)
    if spec is None:
        logger.info("compile_loop: the model cannot run as one captured loop (a "
                    "heterogeneous chain, a per-step expert switch or a "
                    "sequence_parallel context); eager path")
    return spec


def _merge_lora(model, factors):
    """The eager factor merge of the inline legs. A ControlNet composition's factors
    address its BASE's parameters, so it is recomposed around the merged base
    through its ``control_delegate``."""
    from ..models.lora import lora_model

    delegate = getattr(model, "control_delegate", None)
    if delegate is None:
        return lora_model(model, factors)
    from ..models.api import DiffusionModel
    from ..models.controlnet import apply_control

    return apply_control(lora_model(delegate["base"], factors),
                         DiffusionModel(module=delegate["ctrl_params"], name="ctrl"),
                         delegate["hint"], delegate["strength"], delegate["start"],
                         delegate["end"])


def _serve(callback=None, **request):
    """The continuous-batching seam: hand the prepared run to the installed
    scheduler and wait for its lane, or return None for the inline path (no
    scheduler; a user callback, which a lane cannot call between its steps; the
    scheduler could not take it; or its OOM ladder shed it)."""
    from ..serving.scheduler import get_scheduler

    sched = get_scheduler()
    if sched is None:
        return None
    from ..utils.degrade import DegradedToInline, record_rung
    from ..utils.metrics import registry

    sampler = request["sampler"]
    ticket = None if callback is not None else sched.maybe_submit(**request)
    if ticket is not None:
        try:
            return ticket.result()
        except DegradedToInline as e:
            # The serving layer shed this request (its OOM ladder ran out of
            # width): the inline eager path is the last rung, the prompt completes.
            record_rung("inline-fallback", f"{sampler}: {e}", sampler=sampler)
            reason = "degraded"
    else:
        reason = "ineligible"
    registry.counter("pa_serving_inline_fallback_total",
                     labels={"reason": reason, "sampler": sampler},
                     help="sampler runs that ran the inline eager loop with a scheduler "
                          "installed")
    return None


def _traced_sampler_run(fn):
    """Wrap the whole dispatch in a ``sampler-run`` span: the per-prompt timeline
    node every step and lane-wait span nests under. Off, one flag check."""

    @functools.wraps(fn)
    def wrapped(model, noise, context=None, **kwargs):
        if not tracing.on():
            return fn(model, noise, context, **kwargs)
        with tracing.span("sampler-run", cat="sampling", sampler=kwargs.get("sampler"),
                          steps=kwargs.get("steps"),
                          batch=int(noise.shape[0]) if hasattr(noise, "shape") else None):
            return fn(model, noise, context, **kwargs)

    return wrapped


@_traced_sampler_run
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
    """Drive ``model`` from ``noise`` (unit-variance N(0, 1)) to a clean latent with
    the named sampler; eps-family samplers scale the noise to sigma_max themselves.

    ``shift``/``guidance`` apply to the flow paths: ``flow_euler`` and any
    k-sampler with ``prediction="flow"`` (shift warps the flow sigma table the
    scheduler menu ranges over; guidance feeds FLUX-dev's distilled guidance).
    ``scheduler`` names the KSampler menu (``k_samplers.SCHEDULER_NAMES``); without
    it ``karras`` picks karras or normal (flow models: normal).

    img2img: with ``init_latent`` + ``denoise < 1`` the schedule for
    ``steps/denoise`` total steps is truncated to its last ``steps`` entries and
    ``init_latent`` is noised to its start; where a scheduler realises fewer
    sigmas than ``steps``, the truncation is rescaled to the realised length so
    the requested strength survives. ddim instead spaces ``steps`` timesteps over
    [0, denoise·T). Inpainting: ``latent_mask`` (1 = denoise, 0 = keep
    ``init_latent``) re-pins the keep region to the init noised to each step's
    level after every step, at any denoise. ``sigmas`` is an explicit descending
    schedule: no construction, no ``denoise`` truncation, and a given
    ``init_latent`` is the base it noises (``init + σ₀·noise``; flow:
    ``σ₀·noise + (1−σ₀)·init``); ddim refuses it. ``extra_conds``/``cond_*``
    combine conditionings on the k-sampler family only. ``rng`` is the generator
    of the stochastic samplers' per-step noise (``k_samplers.step_noise``; a
    generator seeded 0 on the latent's device when None). ``alphas_cumprod`` in
    ``model_kwargs`` replaces the scaled-linear schedule of ddim and the eps/v
    k-samplers. ``compile_loop=True`` captures the whole loop as a CUDA graph on
    first use and replays it after (``compiled.py``; on CPU tensors the same loop
    body runs uncaptured); it gives up step-OOM demotion, and a failed capture
    runs the eager loop (the ``compile-eager`` rung). ``lora`` maps parameter paths to ``(a, b)`` factor pairs
    (``models/lora.py``: ``W + b @ a``); the sampler drives the merged model, and a
    ``ParallelModel`` then runs unsharded on its lead device."""
    if sampler not in SAMPLER_NAMES:
        raise ValueError(f"unknown sampler {sampler!r} (have {', '.join(SAMPLER_NAMES)})")
    # Model-level sampler preferences (patch nodes, e.g. RescaleCFG): defaults
    # only, an explicit caller value wins.
    prefs = getattr(model, "sampler_prefs", None) or {}
    if cfg_rescale == 0.0:
        cfg_rescale = float(prefs.get("cfg_rescale", 0.0))
    lora = dict(lora) if lora else None
    if lora and (compile_loop or sampler in ("flow_euler", "ddim")):
        # No serving lane for these runs: merge now.
        model, lora = _merge_lora(model, lora), None
    use_cfg = cfg_scale != 1.0 and uncond_context is not None
    eff_cfg = cfg_scale if use_cfg else 1.0
    multi_cond = (bool(extra_conds) or cond_area is not None
                  or cond_area_pct is not None or cond_mask is not None)
    if multi_cond and sampler in ("ddim", "flow_euler"):
        raise ValueError(
            "combined/area conditioning (ConditioningCombine/SetArea) is supported on "
            f"the k-sampler family only, not {sampler!r} — pick any stock sampler name")
    if multi_cond and compile_loop:
        logger.info("compile_loop: multi-cond (Combine/SetArea) runs the eager path")
        compile_loop = False
    if not 0.0 < denoise <= 1.0:
        raise ValueError(f"denoise must be in (0, 1], got {denoise}")
    if latent_mask is not None and init_latent is None:
        raise ValueError("latent_mask requires init_latent (the kept content)")
    if prediction == "v" and sampler == "flow_euler":
        raise ValueError("flow_euler is velocity-parameterized already; "
                         "prediction='v' applies to the eps-family samplers")
    if prediction == "flow" and sampler == "ddim":
        raise ValueError("ddim runs in alpha-bar space and has no flow form; "
                         "use flow_euler or any k-sampler for flow models")
    if sigmas is not None and sampler == "ddim":
        raise ValueError("ddim is timestep-indexed, not sigma-driven; explicit "
                         "sigmas apply to flow_euler and the k-samplers")
    img2img = init_latent is not None and denoise < 1.0
    total = max(steps, int(round(steps / denoise))) if img2img else steps
    spec = _compiled_spec(model, callback) if compile_loop else None
    compiled_mask_kw = dict(
        mask=latent_mask,
        mask_init=init_latent if latent_mask is not None else None,
        mask_noise=noise if latent_mask is not None else None,
    )

    def masked_callback(keep_at):
        """Blend the keep region back after each step; the user callback (which
        may replace x) runs on the blended latent."""
        if latent_mask is None:
            return callback
        m, user = latent_mask, callback

        def cb(i, x):
            x = x * m + keep_at(i) * (1.0 - m)
            if user is not None:
                out = user(i, x)
                x = x if out is None else out
            return x

        return cb

    def with_progress(cb, n_steps):
        """Per-step progress, latent preview and cooperative interrupt on the eager
        loops (``utils/progress.report_progress``), then ``cb``; with tracing on,
        each boundary-to-boundary interval is a ``step`` span (a host dispatch
        window)."""
        t_last = [tracing.now_us()] if tracing.on() else None

        def cb2(i, x):
            if t_last is not None and tracing.on():
                now = tracing.now_us()
                tracing.record("step", t_last[0], now - t_last[0], cat="sampling",
                               step=i + 1, of=n_steps)
                t_last[0] = now
            report_progress(i + 1, n_steps, latent=x)
            return cb(i, x) if cb is not None else None

        return cb2

    if sampler == "flow_euler":
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
        if spec is not None:
            out = _captured_or_none(lambda: compiled_flow_sample(
                spec, x, ts, context, cfg_scale=eff_cfg, uncond_context=uncond_context,
                uncond_kwargs=uncond_kwargs, guidance=guidance, cfg_rescale=cfg_rescale,
                **compiled_mask_kw, model_kwargs=model_kwargs), "flow_euler")
            if out is not None:
                return out
        return emit_eager_numerics(flow_euler_sample(
            model, x, context, steps=steps, shift=shift, guidance=guidance,
            cfg_scale=eff_cfg, uncond_context=uncond_context, uncond_kwargs=uncond_kwargs,
            callback=with_progress(masked_callback(
                lambda i: (1.0 - ts[i + 1]) * init_latent + ts[i + 1] * noise), len(ts) - 1),
            ts=ts, cfg_rescale=cfg_rescale, **model_kwargs,
        ), "eager:flow")

    if sampler == "ddim":
        # One schedule drives the truncation, the noising and the sampler.
        acp = model_kwargs.pop("alphas_cumprod", None)
        acp = scaled_linear_schedule() if acp is None else torch.as_tensor(
            acp, dtype=torch.float32).cpu()
        x = noise
        if img2img:
            # `steps` timesteps evenly over [0, denoise·T), descending.
            t_start = max(1, round(denoise * (acp.shape[0] - 1)))
            ts = torch.linspace(t_start, 0, steps, dtype=torch.float32).round().to(torch.int32)
            a0 = acp[ts[0]]
            x = torch.sqrt(a0) * init_latent + torch.sqrt(1.0 - a0) * noise
        else:
            ts = ddim_timesteps(steps, acp.shape[0])
        if spec is not None:
            out = _captured_or_none(lambda: compiled_ddim_sample(
                spec, x, ts, acp, context, cfg_scale=eff_cfg,
                uncond_context=uncond_context, uncond_kwargs=uncond_kwargs,
                prediction=prediction, cfg_rescale=cfg_rescale, **compiled_mask_kw,
                model_kwargs=model_kwargs), "ddim")
            if out is not None:
                return out

        def ddim_keep(i):
            a = acp[ts[i + 1]] if i + 1 < len(ts) else torch.tensor(1.0)
            return torch.sqrt(a) * init_latent + torch.sqrt(1.0 - a) * noise

        return emit_eager_numerics(ddim_sample(
            model, x, context, steps=steps, cfg_scale=eff_cfg,
            uncond_context=uncond_context, uncond_kwargs=uncond_kwargs,
            callback=with_progress(masked_callback(ddim_keep), len(ts)), ts=ts, alphas_cumprod=acp,
            prediction=prediction, cfg_rescale=cfg_rescale, **model_kwargs,
        ), "eager:ddim")

    step_fn = K_SAMPLERS[sampler]
    is_flow = prediction == "flow"
    acp = model_kwargs.pop("alphas_cumprod", None)
    explicit_sigmas = sigmas is not None
    if is_flow:
        if acp is not None:
            raise ValueError(
                "alphas_cumprod is an eps-schedule input with no flow meaning; "
                "flow schedules derive from the shift-warped flow sigma table")
        if sampler in FLOW_REJECT:
            raise ValueError(
                f"{sampler} is an eps-schedule construction (alpha-bar posterior) with "
                "no rectified-flow form; pick any other k-sampler for flow models")
        if not explicit_sigmas:
            sigmas = make_sigmas(scheduler if scheduler is not None else "normal", total,
                                 sigma_table=flow_sigma_table(shift))
        if guidance is not None:
            model_kwargs["guidance"] = torch.full((noise.shape[0],), guidance,
                                                  dtype=torch.float32, device=noise.device)
    elif not explicit_sigmas:
        sched_name = scheduler if scheduler is not None else ("karras" if karras else "normal")
        sigmas = make_sigmas(sched_name, total, acp)
    if explicit_sigmas:
        sigmas = torch.as_tensor(sigmas, dtype=torch.float32).cpu()
    if img2img and not explicit_sigmas:
        # A schedule can realise fewer sigmas than asked (ddim_uniform's stride,
        # beta's dedup): slice `steps` while that still truncates, else rescale the
        # truncation to the realised length so the requested strength survives.
        realized = len(sigmas) - 1
        if realized > steps:
            sigmas = sigmas[-(steps + 1):]
        else:
            keep = min(realized, max(1, round(steps * realized / total)))
            sigmas = sigmas[-(keep + 1):]
    mix_init = img2img or (explicit_sigmas and init_latent is not None)
    if is_flow:
        x = sigmas[0] * noise
        if mix_init:
            x = x + (1.0 - sigmas[0]) * init_latent
    else:
        x = noise * sigmas[0]
        if mix_init:
            x = init_latent + x
    if sampler in RNG_SAMPLERS and rng is None:
        rng = torch.Generator(device=noise.device).manual_seed(0)
    if not compile_loop:
        served = _serve(
            callback=callback, model=model, x=x, sigmas=sigmas, context=context, sampler=sampler,
            cfg_scale=eff_cfg, uncond_context=uncond_context, uncond_kwargs=uncond_kwargs,
            alphas_cumprod=acp, prediction=prediction, cfg_rescale=cfg_rescale,
            model_kwargs=model_kwargs, rng=rng if sampler in RNG_SAMPLERS else None,
            latent_mask=latent_mask,
            mask_init=init_latent if latent_mask is not None else None,
            mask_noise=noise if latent_mask is not None else None,
            extra_conds=extra_conds, cond_area=cond_area, cond_area_pct=cond_area_pct,
            cond_mask=cond_mask, cond_strength=cond_strength,
            cond_mask_strength=cond_mask_strength, lora=lora)
        if served is not None:
            return served
    if lora:
        model = _merge_lora(model, lora)
    if spec is not None:
        # The captured loop draws every step's noise before it captures: the eager
        # fallback rewinds the generator to draw the same noise again.
        rng_state = rng.get_state() if rng is not None else None
        out = _captured_or_none(lambda: compiled_k_sample(
            spec, sampler, x, sigmas, context, cfg_scale=eff_cfg,
            uncond_context=uncond_context, uncond_kwargs=uncond_kwargs, acp=acp,
            prediction=prediction, cfg_rescale=cfg_rescale, rng=rng, **compiled_mask_kw,
            model_kwargs=model_kwargs), sampler)
        if out is not None:
            return out
        if rng_state is not None:
            rng.set_state(rng_state)
    denoiser = EpsDenoiser(
        model, context, cfg_scale=eff_cfg, uncond_context=uncond_context,
        uncond_kwargs=uncond_kwargs, alphas_cumprod=acp, prediction=prediction,
        cfg_rescale=cfg_rescale, extra_conds=extra_conds, cond_area=cond_area,
        cond_area_pct=cond_area_pct, cond_mask=cond_mask, cond_strength=cond_strength,
        cond_mask_strength=cond_mask_strength, **model_kwargs,
    )
    if is_flow:
        step_fn = FLOW_VARIANTS.get(sampler, step_fn)
        cb = masked_callback(
            lambda i: (1.0 - sigmas[i + 1]) * init_latent + sigmas[i + 1] * noise)
    else:
        cb = masked_callback(lambda i: init_latent + noise * sigmas[i + 1])
    cb = with_progress(cb, len(sigmas) - 1)
    if sampler in RNG_SAMPLERS:
        out = step_fn(denoiser, x, sigmas, rng, callback=cb)
    else:
        out = step_fn(denoiser, x, sigmas, callback=cb)
    return emit_eager_numerics(out, f"eager:k:{sampler}")
