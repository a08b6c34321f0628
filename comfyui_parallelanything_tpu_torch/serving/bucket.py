"""Shape-bucketed step batches: fixed-width stateful lanes in lockstep (counterpart
of ``comfyui_parallelanything_tpu/serving/bucket.py``).

One ``StepBucket`` owns everything needed to run ONE per-lane step program
(``sampling/compiled.lane_step_program``) over a fixed-width batch of lanes,
padded and masked, where each lane is one request at its own position in its own
sigma schedule, running its OWN sampler:

- stacked device state ``(x, xe, h1, h2)[W, b, ...]`` (latent, next eval input,
  two history slots) plus per-lane host bookkeeping: the sampler's eval-ordered
  ``StepPlan`` list (``sampling/lane_specs.py``), a plan counter, the request's
  pre-drawn noise table and its handle;
- step-boundary join and leave: a request enters by writing its row at a
  boundary (history slots zeroed) and retires the moment its own eval count
  completes, while the other lanes keep running: ragged schedules and mixed
  samplers share lockstep dispatches;
- masking: retired and empty lanes ride along with sigma pinned to 1, identity
  coefficients and a ``torch.where`` select, so occupancy never changes a live
  lane's values (the model is independent per sample, and the select keeps even a
  NaN in a pad lane there);
- stochastic lanes: each request's per-step noise is drawn at seat time with
  ``k_samplers.step_noise`` from its own generator, every step and part in the
  order the inline sampler draws them, so the noise is a function of (request,
  step) and a lane is bit-identical alone or co-batched;
- shared-cond epochs: a fresh epoch runs SHARED, every lane referencing ONE cond
  tensor expanded on the lane axis inside the program, so an N-seed fan-out of
  one prompt (whose requests alias one cond object through the embed cache)
  holds one cond; the first foreign cond demotes to stacked rows (a mode change,
  never a value change: the seated lanes' rows refill from the shared ref), and
  an idle release resets the epoch. Traced kwargs (pooled ``y``, ``guidance``,
  the uncond extras) follow the same state machine on their own.

Two execution modes share the bookkeeping: the per-lane step program (models that
run as one program on one device group, width W) and a width-1 eager mode for
models that cannot (weight-streaming models and heterogeneous chains), which walk
the SAME plans against their own ``EpsDenoiser``: step-boundary scheduling, the
full sampler family, cancel and metrics, without co-batching.

Tracing and the SLO plane (``utils/tracing.py``, ``utils/slo.py``): seating a
request observes the ``lane_wait`` stage and records its ``lane-wait`` span (submit
to seat); retiring it records the ``lane`` span (seat to retire); each dispatch
records one ``serving-dispatch`` span on the dispatcher's timeline (occupancy,
masked lanes, width) and a ``step`` span per live lane. The request spans go on
the submitter's timeline (its tid, captured at submit: it is blocked in
``result()`` for exactly those intervals), and the dispatch spans end after the
dispatch's own synchronise, so they include device time; tracing adds no
synchronisation.

Capability overlays (the JAX bucket's): everything a feature-carrying request
needs rides the request, and the bucket keeps it as per-lane state, so mixed traffic
shares one dispatch. The denoise mask (img2img, inpaint) builds on the epoch's first
masked seat; multi-cond CFG extras (``_ensure_mc``: weight maps, extra cond rows,
pooled rows and progress windows, the extra count growing within an epoch),
ControlNet (``_ensure_ctrl``: one control trunk an epoch, a second net bounced to the
inline path before any state changes, per-lane hint, strength and window) and
per-lane LoRA (``_ensure_lora``: the target union and largest rank growing within an
epoch, zero factors for the lanes without one) each turn on at the first seat that
carries one and reset on release. A reused slot rewrites its rows in every overlay,
so a lane never inherits its predecessor's maps, hint or factors.

The numerics quarantine (``utils/numerics.py``): with the sentinel on when the
epoch's state is built, every dispatch also returns per-lane non-finite counts and
bf16 digests, copied to the host before the dispatch's own synchronise and read
after it (no synchronise of its own). A lane whose state went NaN/Inf is retired at
that boundary before its plan counter moves (the select keeps its neighbours as
they are): its submitter gets ``NonFiniteLatent``, and the forensics (its stats,
step, σ and the block ``numerics.bisect_nonfinite`` names) go to
``sentinel.record_quarantine``. The JAX bucket also writes a postmortem bundle there;
the port's comes with the perf ledger (ROADMAP Queue 1 item 9d), so its ``bundle``
is None. A ``lane-nan`` fault plan (``numerics.take_injection``) poisons one seated
lane's next eval input once, to rehearse it. Each retired lane's per-eval digests go
to the sentinel's fingerprint ring.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import uuid
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..sampling.lane_specs import LANE_SPECS, StepPlan, plan_schedule
from ..utils import numerics, slo, tracing
from ..utils.metrics import registry
from ..utils.progress import Interrupted
from .policy import AdmissionQueue, DeadlineExceeded

# Identity update for padded and retired lanes: x'=x, xe'=xe, h1'=h1, h2'=h2, the
# host-side twin of the program's active-lane select.
_IDENTITY_COEF = np.zeros((4, 6), np.float32)
for _j, _k in ((0, 0), (1, 1), (2, 3), (3, 4)):
    _IDENTITY_COEF[_j, _k] = 1.0
del _j, _k

# Process-wide shared-dispatch accounting: lane-steps served in dispatches with
# occupancy > 1 over all lane-steps (the pa_serving_batched_fraction gauge).
_batch_stats = {"total": 0, "shared": 0}
_batch_lock = threading.Lock()


def record_dispatch_occupancy(occupancy: int) -> None:
    """Account one dispatch's lane-steps and refresh the fraction gauge."""
    with _batch_lock:
        _batch_stats["total"] += occupancy
        if occupancy > 1:
            _batch_stats["shared"] += occupancy
        frac = _batch_stats["shared"] / max(1, _batch_stats["total"])
    registry.gauge("pa_serving_batched_fraction", frac,
                   help="lane-steps served via shared dispatch / total lane-steps")


def batched_fraction() -> float:
    """Lane-steps served via shared (occupancy > 1) dispatch / total."""
    with _batch_lock:
        return _batch_stats["shared"] / max(1, _batch_stats["total"])


def reset_batch_stats() -> None:
    """Zero the shared-dispatch accounting (a fresh measurement window)."""
    with _batch_lock:
        _batch_stats["total"] = _batch_stats["shared"] = 0


@dataclasses.dataclass
class ServeRequest:
    """One sampler run handed to the scheduler: what ``run_sampler`` would
    otherwise have fed its own eager loop (the noised start latent, the schedule
    and the conditioning), plus the policy the serving layer adds."""

    x: Any                      # noised start latent [b, ...]
    sigmas: np.ndarray          # (n_steps+1,) descending, host float32
    context: Any
    uncond_context: Any
    traced_kwargs: dict
    static_kwargs: dict
    u_traced: dict
    uncond_kwargs: dict | None
    cfg_scale: float
    cfg_rescale: float
    prediction: str
    acp: Any                    # alphas_cumprod or None (default schedule)
    sampler: str = "euler"      # LaneStepSpec registry name
    rng: Any = None             # the stochastic samplers' torch.Generator
    latent_mask: Any = None     # denoise mask (img2img/inpaint), 1 = denoise
    mask_init: Any = None       # keep-region init latent
    mask_noise: Any = None      # keep-region unit noise
    # Capability state: a re-seat after an OOM rebuilds every overlay row from it.
    extra_conds: tuple = ()     # multi-cond CFG extras (EpsDenoiser's schema)
    cond_area: Any = None       # primary-cond scoping (SetArea family)
    cond_area_pct: Any = None
    cond_mask: Any = None
    cond_strength: float = 1.0
    cond_mask_strength: float = 1.0
    control: dict | None = None  # {"apply", "params", "hint", "strength", "start",
                                 #  "end"} from the model's control_delegate
    lora: dict | None = None    # {param_path: (a, b)}: W_eff = W + b @ a
    eager_model: Any = None     # the width-1 eager twin (the merged control net)
    priority: int = 0
    deadline: float | None = None  # time.monotonic() deadline
    progress_hook: Optional[Callable[[int, int], None]] = None
    interrupt_event: Optional[threading.Event] = None
    prompt_id: Optional[str] = None
    # Trace correlation captured at submit: the submitting thread's tid (the
    # request's spans land on its timeline), the submit time on the trace clock
    # (the lane-wait span's start) and the distributed trace id.
    trace_tid: Optional[int] = None
    trace_submit_us: Optional[float] = None
    trace_id: Optional[str] = None
    rid: str = dataclasses.field(default_factory=lambda: uuid.uuid4().hex)
    submit_ts: float = dataclasses.field(default_factory=time.monotonic)

    def __post_init__(self):
        self.cancel_event = threading.Event()
        self._done = threading.Event()
        self._result: Any = None
        self._error: BaseException | None = None

    @property
    def n_steps(self) -> int:
        return len(self.sigmas) - 1

    def cancelled(self) -> bool:
        return self.cancel_event.is_set() or (
            self.interrupt_event is not None and self.interrupt_event.is_set())

    def resolve(self, result=None, error: BaseException | None = None) -> None:
        self._result, self._error = result, error
        self._done.set()

    def result(self, timeout: float | None = None):
        """Block the submitting thread until its lane retires; re-raises the
        lane's error (``Interrupted`` as the inline sampler's check would)."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"serving request {self.rid} still in flight")
        if self._error is not None:
            raise self._error
        return self._result


@dataclasses.dataclass
class _Lane:
    req: ServeRequest
    idx: int = 0   # σ-intervals completed (the progress unit)
    pc: int = 0    # next StepPlan to run (the eval unit: 2 an interval for
                   # second-order samplers)
    plans: list = dataclasses.field(default_factory=list)
    noise: Any = None  # [n_steps, parts, b, ...] pre-drawn step_noise, or None
    # Width-1 eager mode only: the lane's own state and denoiser (program mode
    # keeps lane state stacked in the bucket's tensors).
    x_eager: Any = None
    xe_eager: Any = None
    h1_eager: Any = None
    h2_eager: Any = None
    denoiser: Any = None
    seat_us: float = 0.0  # when it was seated, on the trace clock (tracing on)
    # The sentinel's per-eval digests of the lane's latent (empty with it off),
    # recorded in the fingerprint ring when the lane retires.
    digests: list = dataclasses.field(default_factory=list)

    def plan(self) -> StepPlan:
        return self.plans[self.pc]

    def done(self) -> bool:
        return self.pc >= len(self.plans)


def _noise_table(req: ServeRequest, parts: int):
    """Every step's ``step_noise`` draw for the request, ``[n_steps, parts, b,
    ...]``: the draws the inline sampler makes, made once at seat time."""
    from ..sampling.compiled import _draw_noise

    if req.rng is None or req.n_steps <= 0:
        return None
    return _draw_noise(req.rng, req.n_steps, parts, req.x).movedim(0, 2)


def _noise_row(lane: _Lane, plan: StepPlan):
    """The lane's draw for this plan, or None when the plan draws nothing."""
    if plan.noise is None or lane.noise is None:
        return None
    return lane.noise[plan.step, 1 if plan.noise == "sde_end" else 0]


class StepBucket:
    """Fixed-width lockstep batch for one (model, shape, sampler-config) key."""

    def __init__(self, key, label: str, *, width: int, model, spec,
                 max_waiting: int = 64):
        self.key, self.label = key, label
        self.width = max(1, int(width))
        self.model, self.spec = model, spec
        self.queue = AdmissionQueue(max_waiting=max_waiting)
        self.lanes: list[_Lane | None] = [None] * self.width
        self.dispatch_count = 0
        self._program = None
        self._prog_kw = None
        self._log_sigmas = None
        self._labels = {"bucket": label}
        self.release_state()

    # -- occupancy ----------------------------------------------------------

    def active_lanes(self) -> list[int]:
        return [i for i, lane in enumerate(self.lanes) if lane is not None]

    def idle(self) -> bool:
        return not self.active_lanes() and len(self.queue) == 0

    def release_state(self) -> None:
        """Drop the stacked device tensors while idle: an idle serving layer holds
        no W-wide latents or conds between bursts. Rebuilt at the next admission,
        which also starts a fresh shared-cond epoch."""
        self._x = self._xe = self._h1 = self._h2 = None
        self._noise = None
        self._ctx = self._uctx = None
        self._cond_mode = None        # "shared" | "stacked"
        self._ctx_ref = self._uctx_ref = None
        self._kw = self._ukw = None
        self._kw_mode = None          # "shared" | "stacked"
        self._kw_ref = self._ukw_ref = None
        # The denoise-mask stacks build on the first masked seat of an epoch.
        self._mask = self._mask_init = self._mask_noise = None
        self._mask_has = np.zeros(self.width, bool)
        # Capability overlays: off until a carrying request seats.
        self._mc_k = None             # None: off; else the epoch's largest extra count
        self._mc_has_y = False
        self._mc_w0 = self._mc_ctx = self._mc_w = self._mc_y = None
        self._mc_win = None           # host [W, K, 2] progress windows
        self._ctrl = None             # {"apply", "params", "params_ref"}
        self._ctrl_hint = None        # [W, b, 8H, 8W, C]
        self._ctrl_strength = np.zeros(self.width, np.float32)
        self._ctrl_win = np.tile(np.asarray([0.0, 1.0], np.float32), (self.width, 1))
        self._lora_sig = ()           # ordered ((path, m, k), ...)
        self._lora_rmax = 0
        self._lora_ab = []            # per target: (a[W, r, k], b[W, m, r]) float32
        self._emit_stats = False      # the sentinel flag when the epoch's state built
        self._stats_host = None       # page-locked buffers the stats are read through
        self._program = None

    def _gauges(self) -> None:
        registry.gauge("pa_serving_occupancy", len(self.active_lanes()),
                       labels=self._labels, help="live lanes in the bucket's step batch")
        registry.gauge("pa_serving_queue_depth", len(self.queue), labels=self._labels,
                       help="requests waiting for a lane")

    # -- state assembly -----------------------------------------------------

    def _zeros_stack(self, template):
        """``[W, *template.shape]`` zeros in the template's dtype and device; a dict
        of tensors stacks leaf by leaf."""
        if isinstance(template, dict):
            return {k: self._zeros_stack(v) for k, v in template.items()}
        return torch.zeros((self.width,) + tuple(template.shape), dtype=template.dtype,
                           device=template.device)

    def _ensure_state(self, req: ServeRequest) -> None:
        if self.spec is None or self._x is not None:
            return
        self._x = self._zeros_stack(req.x)
        self._xe = self._zeros_stack(req.x)
        self._h1 = self._zeros_stack(req.x)
        self._h2 = self._zeros_stack(req.x)
        if req.prediction != "flow":
            from ..sampling.k_samplers import model_sigmas
            from ..sampling.schedules import scaled_linear_schedule

            acp = req.acp if req.acp is not None else scaled_linear_schedule()
            self._log_sigmas = torch.log(model_sigmas(acp))
        # The stats outputs are part of the program: the flag holds for the epoch.
        self._emit_stats = numerics.on()
        self._prog_kw = dict(
            prediction=req.prediction,
            use_cfg=req.uncond_context is not None and req.cfg_scale != 1.0,
            cfg_rescale=req.cfg_rescale, static_kwargs=req.static_kwargs)

    def _ensure_program(self) -> None:
        if self._program is not None or self.spec is None:
            return
        from ..sampling.compiled import lane_step_program

        self._program = lane_step_program(
            self.model, broadcast_cond=self._cond_mode == "shared",
            broadcast_kwargs=self._kw_mode == "shared", emit_stats=self._emit_stats,
            n_extra=self._mc_k, mc_has_y=self._mc_has_y,
            control_apply=None if self._ctrl is None else self._ctrl["apply"],
            lora_sig=self._lora_sig, lora_module=self._lora_module(), **self._prog_kw)

    def _lora_module(self):
        """The module the program's model runs (the per-lane LoRA hooks' target)."""
        return None if self.spec is None else self.spec.replicas[0]

    def _seat_cond(self, i: int, req: ServeRequest) -> None:
        """Seat lane ``i``'s conditioning. A fresh epoch (no other live lane)
        enters SHARED mode with the request's cond objects as the bucket's refs;
        a sibling whose cond is the SAME object rides the shared tensor. The first
        foreign cond demotes to STACKED rows, refilled for the seated lanes from
        their own requests."""
        others = [j for j in self.active_lanes() if j != i]
        if not others:
            self._cond_mode = "shared"
            self._ctx_ref, self._uctx_ref = req.context, req.uncond_context
            self._ctx = self._uctx = None
            self._program = None
            return
        if self._cond_mode == "shared":
            if req.context is self._ctx_ref and req.uncond_context is self._uctx_ref:
                registry.counter("pa_serving_shared_cond_seats_total", labels=self._labels,
                                 help="lanes seated against an already-shared cond tensor")
                return
            self._cond_mode = "stacked"
            self._ctx = None if self._ctx_ref is None else self._zeros_stack(self._ctx_ref)
            self._uctx = (None if self._uctx_ref is None
                          else self._zeros_stack(self._uctx_ref))
            for j in others:
                if self._ctx is not None:
                    self._ctx[j].copy_(self.lanes[j].req.context)
                if self._uctx is not None:
                    self._uctx[j].copy_(self.lanes[j].req.uncond_context)
            self._ctx_ref = self._uctx_ref = None
            self._program = None
        if self._ctx is not None:
            self._ctx[i].copy_(req.context)
        if self._uctx is not None:
            self._uctx[i].copy_(req.uncond_context)

    @staticmethod
    def _same_tree(a, b) -> bool:
        """Key for key, tensor for tensor OBJECT identity: the sharing signal."""
        if a is b:
            return True
        if not a or not b:
            return not a and not b
        return a.keys() == b.keys() and all(a[k] is b[k] for k in a)

    def _seat_kwargs(self, i: int, req: ServeRequest) -> None:
        """Seat lane ``i``'s traced kwargs (and the uncond extras) under the same
        shared / stacked state machine as ``_seat_cond``."""
        kw, ukw = req.traced_kwargs or None, req.u_traced or None
        others = [j for j in self.active_lanes() if j != i]
        if not others:
            self._kw_mode = "shared"
            self._kw_ref, self._ukw_ref = kw, ukw
            self._kw = self._ukw = None
            self._program = None
            return
        if self._kw_mode == "shared":
            if self._same_tree(kw, self._kw_ref) and self._same_tree(ukw, self._ukw_ref):
                registry.counter("pa_serving_shared_kwargs_seats_total", labels=self._labels,
                                 help="lanes seated against already-shared traced kwargs")
                return
            self._kw_mode = "stacked"
            self._kw = None if self._kw_ref is None else self._zeros_stack(self._kw_ref)
            self._ukw = None if self._ukw_ref is None else self._zeros_stack(self._ukw_ref)
            for j in others:
                self._write_kwargs(j, self.lanes[j].req)
            self._kw_ref = self._ukw_ref = None
            self._program = None
        self._write_kwargs(i, req)

    def _write_kwargs(self, i: int, req: ServeRequest) -> None:
        for stack, tree in ((self._kw, req.traced_kwargs), (self._ukw, req.u_traced)):
            if stack is not None:
                for k, v in stack.items():
                    v[i].copy_(tree[k])

    def _seat_mask(self, i: int, req: ServeRequest) -> None:
        """The denoise-mask rows: written for a masked lane (stacks built on the
        epoch's first), a gate flag for every lane. An unmasked lane needs no row
        write: the program's select never reads a gated-off lane's rows."""
        if req.latent_mask is None:
            self._mask_has[i] = False
            return
        if self._mask is None:
            self._mask = self._zeros_stack(torch.zeros(req.x.shape, dtype=torch.float32,
                                                       device=req.x.device))
            self._mask_init = self._zeros_stack(req.x)
            self._mask_noise = self._zeros_stack(req.x)
        for stack, ref in ((self._mask, req.latent_mask), (self._mask_init, req.mask_init),
                           (self._mask_noise, req.mask_noise)):
            stack[i].copy_(torch.as_tensor(ref).to(stack.device, stack.dtype)
                           .expand(req.x.shape))
        self._mask_has[i] = True

    # -- capability overlays -------------------------------------------------

    def _mc_map(self, req: ServeRequest, w):
        """One cond's weight (a 0-d strength, or a (1|b, H, W, 1) map from
        ``area_weight``) at the bucket's fixed per-sample map shape: ``[b, H, W, 1]``
        for 4-D latents, ``[b, 1, ...]`` otherwise."""
        b = req.x.shape[0]
        tgt = ((b,) + tuple(req.x.shape[1:-1]) + (1,) if req.x.ndim == 4
               else (b,) + (1,) * (req.x.ndim - 1))
        return torch.as_tensor(w, dtype=torch.float32).to(req.x.device).expand(tgt)

    def _ensure_mc(self, req: ServeRequest) -> None:
        """Build or grow the multi-cond overlay. The extra count K only grows within
        an epoch and the pooled leg turns on at most once; either change rebuilds
        the stacks and refills every seated lane from its own request (a mode
        change, never a value change)."""
        extras = req.extra_conds or ()
        k_req = len(extras)
        if not k_req and self._mc_k is None:
            return
        need_y = self._mc_has_y or any(e.get("pooled") is not None for e in extras)
        if self._mc_k is not None and k_req <= self._mc_k and need_y == self._mc_has_y:
            return
        k_new = max(k_req, self._mc_k or 0)
        dev = req.x.device
        map_t = self._mc_map(req, 0.0)
        self._mc_w0 = self._zeros_stack(map_t)
        self._mc_w = self._zeros_stack(torch.zeros((k_new,) + tuple(map_t.shape),
                                                   device=dev))
        self._mc_ctx = self._zeros_stack(torch.zeros((k_new,) + tuple(req.context.shape),
                                                     dtype=req.context.dtype, device=dev))
        self._mc_y = None
        if need_y:
            y = req.traced_kwargs["y"]
            self._mc_y = self._zeros_stack(torch.zeros((k_new,) + tuple(y.shape),
                                                       dtype=y.dtype, device=dev))
        self._mc_win = np.zeros((self.width, k_new, 2), np.float32)
        self._mc_win[:, :, 1] = 1.0
        self._mc_k, self._mc_has_y = k_new, need_y
        self._program = None
        for j in self.active_lanes():
            self._write_mc_row(j, self.lanes[j].req)

    def _write_mc_row(self, i: int, req: ServeRequest) -> None:
        """Lane ``i``'s multi-cond rows: the primary weight map and, per extra, its
        cond rows, weight map, pooled row and progress window; zero rows and the
        full window for a lane without extras and for the slots past its own
        count."""
        if self._mc_k is None:
            return
        from ..sampling.k_samplers import area_weight, broadcast_cond_batch

        for stack in (self._mc_w0, self._mc_w, self._mc_ctx, self._mc_y):
            if stack is not None:
                stack[i].zero_()
        self._mc_win[i, :, 0] = 0.0
        self._mc_win[i, :, 1] = 1.0
        extras = req.extra_conds or ()
        if not extras:
            return
        b = req.x.shape[0]
        dev = req.x.device
        self._mc_w0[i].copy_(self._mc_map(req, area_weight(
            req.cond_area, req.cond_strength, req.x.shape, mask=req.cond_mask,
            mask_strength=req.cond_mask_strength, area_pct=req.cond_area_pct, device=dev)))
        y_fill = (req.traced_kwargs or {}).get("y")
        for k, e in enumerate(extras):
            self._mc_ctx[i, k].copy_(broadcast_cond_batch(e["context"], b))
            self._mc_w[i, k].copy_(self._mc_map(req, area_weight(
                e.get("area"), float(e.get("strength", 1.0)), req.x.shape,
                mask=e.get("mask"), mask_strength=float(e.get("mask_strength", 1.0)),
                area_pct=e.get("area_pct"), device=dev)))
            window = e.get("timestep_range")
            if window is not None:
                self._mc_win[i, k] = (float(window[0]), float(window[1]))
            if self._mc_y is not None:
                pooled = e.get("pooled")
                y_row = y_fill if pooled is None else broadcast_cond_batch(pooled, b)
                if y_row is not None:
                    self._mc_y[i, k].copy_(torch.as_tensor(y_row).expand(
                        self._mc_y.shape[2:]))

    def _ctrl_hint_norm(self, req: ServeRequest):
        """``ControlledModel.residuals``' hint preparation, once at seat: rank 4,
        repeated to the request's batch, resized bilinearly to 8× the latent grid
        (the scheduler already refused per-sample hint batches, as the inline
        composition raises on them)."""
        from ..ops.resize import resize

        hint = torch.as_tensor(req.control["hint"], dtype=torch.float32).to(req.x.device)
        if hint.ndim == 3:
            hint = hint[None]
        b = req.x.shape[0]
        if hint.shape[0] != b:
            hint = hint[:1].expand((b,) + tuple(hint.shape[1:]))
        want = (req.x.shape[1] * 8, req.x.shape[2] * 8)
        if tuple(hint.shape[1:3]) != want:
            hint = resize(hint, (b, *want, hint.shape[-1]), method="bilinear")
        return hint

    def _ensure_ctrl(self, req: ServeRequest) -> None:
        """The ControlNet overlay, on the first carrying seat: one control trunk an
        epoch (a different one is bounced before any state changes)."""
        if req.control is None or self._ctrl is not None:
            return
        self._ctrl = {"apply": req.control["apply"], "params": req.control["params"],
                      "params_ref": req.control["params"]}
        self._ctrl_hint = self._zeros_stack(self._ctrl_hint_norm(req))
        self._ctrl_strength = np.zeros(self.width, np.float32)
        self._ctrl_win = np.tile(np.asarray([0.0, 1.0], np.float32), (self.width, 1))
        self._program = None

    def _ctrl_conflict(self, req: ServeRequest) -> bool:
        """True when the request carries another control trunk than the one this
        epoch runs (identity of the apply function and the net)."""
        return (self.spec is not None and req.control is not None and self._ctrl is not None
                and (req.control["apply"] is not self._ctrl["apply"]
                     or req.control["params"] is not self._ctrl["params_ref"]))

    def _ensure_lora(self, req: ServeRequest) -> None:
        """Build or grow the LoRA overlay: the target union and the largest rank
        only grow within an epoch; a growth rebuilds the zero-padded factor stacks
        and refills every seated lane (a zero rank slot adds an exact zero)."""
        if not req.lora:
            return
        module = self._lora_module()
        paths = sorted(set(req.lora) | {p for (p, _, _) in self._lora_sig})
        r_new = max(max(int(a.shape[0]) for (a, _b) in req.lora.values()), self._lora_rmax)
        if tuple(p for (p, _, _) in self._lora_sig) == tuple(paths) \
                and r_new == self._lora_rmax:
            return
        sig = []
        for p in paths:
            w = module.get_parameter(p)
            sig.append((p, int(w.shape[0]), int(w[0].numel())))
        self._lora_sig, self._lora_rmax = tuple(sig), r_new
        dev = req.x.device
        self._lora_ab = [(torch.zeros((self.width, r_new, k), device=dev),
                          torch.zeros((self.width, m, r_new), device=dev))
                         for (_p, m, k) in sig]
        self._program = None
        for j in self.active_lanes():
            self._write_lora_row(j, self.lanes[j].req)

    def _write_lora_row(self, i: int, req: ServeRequest) -> None:
        if not self._lora_sig:
            return
        from ..models.lora import pad_rank

        factors = req.lora or {}
        for (path, _m, _k), (a_s, b_s) in zip(self._lora_sig, self._lora_ab):
            pair = factors.get(path)
            if pair is None:
                a_s[i].zero_()
                b_s[i].zero_()
            else:
                a_, b_ = pad_rank(torch.as_tensor(pair[0]).to(a_s.device, torch.float32),
                                  torch.as_tensor(pair[1]).to(b_s.device, torch.float32),
                                  self._lora_rmax)
                a_s[i].copy_(a_)
                b_s[i].copy_(b_)

    def _seat_caps(self, i: int, req: ServeRequest) -> None:
        """Lane ``i``'s capability rows: the mask rows and gate, then every overlay
        the bucket runs (built on the first carrying seat), each row rewritten for
        a reused slot."""
        kinds = []
        self._seat_mask(i, req)
        if req.latent_mask is not None:
            kinds.append("img2img_mask")
        if req.extra_conds:
            kinds.append("multi_cond")
        self._ensure_mc(req)
        self._write_mc_row(i, req)
        if req.control is not None:
            self._ensure_ctrl(req)
            kinds.append("controlnet")
        if self._ctrl is not None:
            if req.control is not None:
                self._ctrl_hint[i].copy_(self._ctrl_hint_norm(req))
                self._ctrl_strength[i] = float(req.control["strength"])
                self._ctrl_win[i] = (float(req.control["start"]), float(req.control["end"]))
            else:
                # Gain 0: exact zero residuals; a stale hint row feeds only those.
                self._ctrl_strength[i] = 0.0
                self._ctrl_win[i] = (0.0, 1.0)
        if req.lora:
            self._ensure_lora(req)
            kinds.append("lora")
        self._write_lora_row(i, req)
        for kind in kinds or ["txt2img"]:
            registry.counter("pa_serving_lane_capability_total",
                             labels={**self._labels, "kind": kind},
                             help="lanes seated, by capability carried (a lane counts "
                                  "once per capability; plain lanes as txt2img)")

    def _set_lane(self, i: int, req: ServeRequest) -> bool:
        """Seat ``req`` in lane ``i``; False when it was bounced to the inline path
        (a second ControlNet this epoch), resolved ``DegradedToInline`` before any
        state changed."""
        if self._ctrl_conflict(req):
            from ..utils.degrade import DegradedToInline

            req.resolve(error=DegradedToInline(
                f"bucket {self.label} already carries a different ControlNet this "
                "epoch; re-submit inline"))
            registry.counter("pa_serving_ctrl_conflict_total", labels=self._labels,
                             help="seats bounced to inline: a second ControlNet arrived "
                                  "within one bucket epoch")
            return False
        self._ensure_state(req)
        lane = _Lane(req)
        # The whole schedule becomes an eval-ordered plan list at seat time (host
        # float64, once a request); a stochastic lane also draws its noise here.
        lane.plans = plan_schedule(req.sampler, req.sigmas, req.prediction)
        spec_entry = LANE_SPECS[req.sampler]
        if spec_entry.needs_rng:
            lane.noise = _noise_table(req, 2 if spec_entry.split_keys else 1)
        if self.spec is not None:
            # A reused slot never sees its predecessor's carries.
            self._x[i].copy_(req.x)
            self._xe[i].copy_(req.x)
            self._h1[i].zero_()
            self._h2[i].zero_()
            self._seat_cond(i, req)
            self._seat_kwargs(i, req)
            self._seat_caps(i, req)
        else:
            from ..sampling.k_samplers import EpsDenoiser

            lane.x_eager = lane.xe_eager = req.x
            lane.h1_eager = torch.zeros_like(req.x)
            lane.h2_eager = torch.zeros_like(req.x)
            # The width-1 eager twin: multi-cond through the denoiser's own blend,
            # ControlNet through the merged ``eager_model``, the mask in dispatch.
            lane.denoiser = EpsDenoiser(
                req.eager_model if req.eager_model is not None else self.model,
                req.context, cfg_scale=req.cfg_scale,
                uncond_context=req.uncond_context, uncond_kwargs=req.uncond_kwargs,
                alphas_cumprod=req.acp, prediction=req.prediction,
                cfg_rescale=req.cfg_rescale, extra_conds=req.extra_conds or None,
                cond_area=req.cond_area, cond_area_pct=req.cond_area_pct,
                cond_mask=req.cond_mask, cond_strength=req.cond_strength,
                cond_mask_strength=req.cond_mask_strength,
                **req.traced_kwargs, **req.static_kwargs)
            registry.counter("pa_serving_lane_capability_total",
                             labels={**self._labels, "kind": "img2img_mask"
                                     if req.latent_mask is not None else "txt2img"},
                             help="lanes seated, by capability carried (a lane counts "
                                  "once per capability; plain lanes as txt2img)")
        self.lanes[i] = lane
        return True

    # -- scheduling ---------------------------------------------------------

    def admit(self, now: float | None = None) -> int:
        """Fill free lanes from the waiting line (policy order), resolving expired
        and cancelled entries instead of seating them. Returns how many joined;
        the dispatcher calls this between dispatches, never mid-step."""
        now = time.monotonic() if now is None else now
        for req in self.queue.expired(now):
            req.resolve(error=DeadlineExceeded(
                f"deadline passed after {now - req.submit_ts:.3f}s waiting"))
            registry.counter("pa_serving_expired_total", labels=self._labels)
        joined = 0
        for i in range(self.width):
            if self.lanes[i] is not None:
                continue
            req = self.queue.pop()
            if req is None:
                break
            if req.cancelled():
                req.resolve(error=Interrupted("cancelled while queued"))
                registry.counter("pa_serving_cancelled_total", labels=self._labels)
                continue
            if req.deadline is not None and now >= req.deadline:
                # A deadline that lapsed between the sweep above and this pop
                # rejects instead of spending a dispatch on it.
                req.resolve(error=DeadlineExceeded(
                    f"deadline passed after {now - req.submit_ts:.3f}s waiting "
                    "(caught at admission)"))
                registry.counter("pa_serving_expired_total", labels=self._labels)
                continue
            if not self._set_lane(i, req):
                continue  # bounced to the inline path; the slot refills next sweep
            joined += 1
            registry.histogram("pa_serving_lane_wait_seconds", now - req.submit_ts,
                               labels=self._labels, help="submit-to-lane admission wait")
            # The SLO lane_wait stage: the same clock, without the bucket label.
            slo.observe_stage("lane_wait", now - req.submit_ts)
            if tracing.on():
                self.lanes[i].seat_us = tracing.now_us()
                if req.trace_submit_us is not None:
                    tracing.record(
                        "lane-wait", req.trace_submit_us,
                        self.lanes[i].seat_us - req.trace_submit_us, cat="serving",
                        tid=req.trace_tid, prompt_id=req.prompt_id, bucket=self.label,
                        lane=i, rid=req.rid, queue_depth=len(self.queue),
                        **({"trace_id": req.trace_id} if req.trace_id else {}))
        if joined:
            self._gauges()
        return joined

    def _retire(self, i: int, result=None, error=None) -> None:
        lane = self.lanes[i]
        self.lanes[i] = None
        if lane.digests:
            # The lane's per-eval fingerprint stack: independent of occupancy and
            # width by the digest's construction, so a drift is a numerics change.
            numerics.sentinel.record_fingerprints(
                rid=lane.req.rid, sampler=lane.req.sampler, bucket=self.label,
                steps=lane.idx, digests=list(lane.digests))
        if tracing.on() and lane.seat_us:
            # Seat to retire on the submitter's timeline; the dispatches' step spans
            # nest inside it.
            tracing.record(
                "lane", lane.seat_us, tracing.now_us() - lane.seat_us, cat="serving",
                tid=lane.req.trace_tid, prompt_id=lane.req.prompt_id, bucket=self.label,
                lane=i, rid=lane.req.rid, steps_run=lane.idx,
                outcome="error" if error is not None else "completed",
                **({"trace_id": lane.req.trace_id} if lane.req.trace_id else {}))
        lane.req.resolve(result=result, error=error)
        registry.counter("pa_serving_cancelled_total" if error is not None
                         else "pa_serving_completed_total", labels=self._labels)

    def _quarantine(self, i: int, plan: StepPlan, stats_vec, xe_lane,
                    occupancy: int = 0) -> None:
        """Retire lane ``i`` whose state went non-finite, through the select
        discipline (the stacked state is not touched, so its neighbours equal their
        solo runs). Its submitter gets ``NonFiniteLatent``; the forensics (stats,
        step, σ, and the first non-finite block from ``bisect_nonfinite``: the
        failing eval input re-run through the model's ``PipelineSpec``) go to
        ``sentinel.record_quarantine``. This dispatch is the first non-finite one,
        since every emitting dispatch is checked. ``bundle`` is None: the postmortem
        bundle comes with the perf ledger (ROADMAP Queue 1 item 9d)."""
        lane = self.lanes[i]
        req = lane.req
        err = numerics.NonFiniteLatent(
            f"lane {i} ({req.sampler}) went non-finite at step {plan.step} "
            f"(σ_eval={plan.sigma_eval:.6g}) in bucket {self.label}; lane quarantined")
        forensics = {
            "bucket": self.label, "lane": i, "rid": req.rid, "sampler": req.sampler,
            "step": int(plan.step), "sigma": float(plan.sigma_eval), "pc": lane.pc,
            "occupancy": occupancy, "prompt_id": req.prompt_id,
            "stats": numerics.stats_to_dict(stats_vec),
        }
        log_sig = self._log_sigmas
        if log_sig is None and lane.denoiser is not None:
            log_sig = getattr(lane.denoiser, "log_sigmas", None)
        try:
            bisect = numerics.bisect_nonfinite(
                self.model, xe_lane, plan.sigma_eval, req.prediction, log_sig,
                req.context, {**req.traced_kwargs, **req.static_kwargs})
        except Exception as e:  # noqa: BLE001 - forensics never blocks the retire
            bisect = {"block": None, "bisect_error": f"{type(e).__name__}: {e}"}
        forensics["first_nonfinite"] = {"step": int(plan.step),
                                        "sigma": float(plan.sigma_eval), **bisect}
        numerics.sentinel.record_event("serving-lane", bucket=self.label, lane=i,
                                       step=int(plan.step), sampler=req.sampler)
        numerics.sentinel.record_quarantine(**forensics, bundle=None)
        self._retire(i, error=err)

    def sweep_cancelled(self) -> int:
        """Retire lanes whose request was cancelled (client cancel, per-prompt
        interrupt) or whose deadline passed: the slot frees at the boundary without
        touching the stacked state (the lane is masked from the next dispatch on),
        so its neighbours are untouched."""
        now = time.monotonic()
        swept = 0
        for i in self.active_lanes():
            req = self.lanes[i].req
            if req.cancelled():
                self._retire(i, error=Interrupted(
                    f"cancelled mid-batch at step {self.lanes[i].idx}"))
                swept += 1
            elif req.deadline is not None and now >= req.deadline:
                self._retire(i, error=DeadlineExceeded(
                    f"deadline passed at step {self.lanes[i].idx}"))
                swept += 1
        if swept:
            self._gauges()
        return swept

    def _program_inputs(self, active: list[int], plans: dict) -> dict:
        """The host side of one program dispatch: per-lane sigma, activity, cfg,
        update coefficients, the noise rows and the mask mix."""
        sig = [1.0] * self.width
        act = [False] * self.width
        cfg = [1.0] * self.width
        coef = np.broadcast_to(_IDENTITY_COEF, (self.width, 4, 6)).copy()
        mask_mix = np.zeros((self.width, 3), np.float32)
        rows = {}
        for i in active:
            lane, plan = self.lanes[i], plans[i]
            sig[i], act[i], cfg[i] = plan.sigma_eval, True, lane.req.cfg_scale
            coef[i] = plan.coef
            row = _noise_row(lane, plan)
            if row is not None:
                rows[i] = row
            if self._mask_has[i] and plan.completes:
                # The inline mask callback's keep region at the lane's next sigma
                # (eps/v: init + σ'·noise; flow: (1−σ')·init + σ'·noise).
                s_next = float(lane.req.sigmas[plan.step + 1])
                mask_mix[i] = ((1.0, 1.0 - s_next, s_next) if lane.req.prediction == "flow"
                               else (1.0, 1.0, s_next))
        noise = None
        if rows:
            if self._noise is None:
                self._noise = torch.zeros_like(self._x)
            for i in range(self.width):
                if i in rows:
                    self._noise[i].copy_(rows[i])
                else:
                    self._noise[i].zero_()
            noise = self._noise
        masked = any(self._mask_has[i] for i in active)
        caps = {}
        # The overlays the program was built with, and only those.
        if self._mc_k is not None:
            caps.update(mc_w0=self._mc_w0, mc_ctx=self._mc_ctx, mc_w=self._mc_w,
                        mc_win=self._mc_win, mc_y=self._mc_y)
        if self._ctrl is not None:
            caps.update(ctrl_params=self._ctrl["params"], ctrl_hint=self._ctrl_hint,
                        ctrl_strength=self._ctrl_strength, ctrl_win=self._ctrl_win)
        if self._lora_sig:
            caps.update(lora_ab=self._lora_ab,
                        lora_lanes=[i for i in active if self.lanes[i].req.lora])
        return dict(sigma_eval=sig, active=act, cfg_scale=cfg,
                    coef=torch.from_numpy(coef), noise=noise,
                    mask=self._mask if masked else None, mask_init=self._mask_init,
                    mask_noise=self._mask_noise,
                    mask_mix=torch.from_numpy(mask_mix) if masked else None, **caps)

    def _dispatch_program(self, active: list[int], plans: dict):
        """One program dispatch; with the sentinel's outputs, returns ``(stats,
        digests, eval input)``, the first two copied toward the host without
        blocking (read after the dispatch's synchronise), else None."""
        self._ensure_program()
        xe_prev = None
        if self._emit_stats:
            inj = numerics.take_injection(active)
            if inj is not None:
                # The lane-nan rehearsal: one element of the seated lane's next eval
                # input, once; this dispatch's stats must catch it.
                self._xe[(inj,) + (0,) * (self._xe.ndim - 1)] = float("nan")
            # The eval input survives the dispatch (the program makes new state
            # tensors) for the quarantine's bisection.
            xe_prev = self._xe
        shared = self._cond_mode == "shared"
        ctx = self._ctx_ref if shared else self._ctx
        uctx = self._uctx_ref if shared else self._uctx
        if shared:
            registry.counter("pa_serving_cond_broadcast_total", labels=self._labels,
                             help="dispatches whose cond rode the lane axis as ONE tensor")
        kw_shared = self._kw_mode == "shared"
        kw = self._kw_ref if kw_shared else self._kw
        ukw = self._ukw_ref if kw_shared else self._ukw
        use_cfg = self._prog_kw["use_cfg"]
        outs = self._program(
            self._x, self._xe, self._h1, self._h2, context=ctx,
            uncond_context=uctx if use_cfg else None, kwargs=kw,
            u_kwargs=ukw if use_cfg else None, log_sigmas=self._log_sigmas,
            **self._program_inputs(active, plans))
        self._x, self._xe, self._h1, self._h2 = outs[:4]
        if not self._emit_stats:
            return None
        # Read after this dispatch's synchronise and before the next copy: one pair
        # of page-locked buffers serves the epoch.
        self._stats_host = numerics.to_host_async(outs[4:], out=self._stats_host)
        st, dg = self._stats_host
        return st, dg, lambda i: xe_prev[i]

    def _dispatch_eager(self, active: list[int], plans: dict):
        """Width-1 eager mode: the SAME plan walk against each lane's own
        denoiser, one model call an eval. With the sentinel on (read live: there is
        no program), returns the lanes' stats and digests as ``_dispatch_program``
        does."""
        emit = numerics.on()
        xe_inputs = {}
        if emit:
            inj = numerics.take_injection(active)
            if inj is not None:
                lane0 = self.lanes[inj]
                lane0.xe_eager = lane0.xe_eager.clone()
                lane0.xe_eager[(0,) * lane0.xe_eager.ndim] = float("nan")
        for i in active:
            lane, plan = self.lanes[i], plans[i]
            if emit:
                xe_inputs[i] = lane.xe_eager
            x0 = lane.denoiser(lane.xe_eager, plan.sigma_eval)
            basis = (lane.x_eager, lane.xe_eager, x0, lane.h1_eager, lane.h2_eager,
                     _noise_row(lane, plan))

            def combine(row_c, like, basis=basis):
                acc = None
                for c, term in zip(row_c, basis):
                    if float(c) == 0.0 or term is None:
                        continue
                    part = float(c) * term
                    acc = part if acc is None else acc + part
                return torch.zeros_like(like) if acc is None else acc.to(like.dtype)

            lane.x_eager, lane.xe_eager, lane.h1_eager, lane.h2_eager = (
                combine(plan.coef[0], lane.x_eager), combine(plan.coef[1], lane.xe_eager),
                combine(plan.coef[2], lane.h1_eager), combine(plan.coef[3], lane.h2_eager))
            rq = lane.req
            if plan.completes and rq.latent_mask is not None:
                # The program's mask blend: re-pin the keep region on σ-interval
                # completion (histories untouched).
                s_next = float(rq.sigmas[plan.step + 1])
                keep = ((1.0 - s_next) * rq.mask_init + s_next * rq.mask_noise
                        if rq.prediction == "flow" else rq.mask_init + s_next * rq.mask_noise)
                mk = torch.as_tensor(rq.latent_mask).to(lane.x_eager.device, torch.float32)
                lane.x_eager = (lane.x_eager * mk + keep * (1.0 - mk)).to(lane.x_eager.dtype)
                lane.xe_eager = (lane.xe_eager * mk + keep * (1.0 - mk)).to(lane.xe_eager.dtype)
        if not emit:
            return None
        st = torch.cat([numerics.lane_stats(self.lanes[i].x_eager[None],
                                            extra=self.lanes[i].xe_eager[None])
                        for i in active])
        dg = torch.stack([numerics.digest(self.lanes[i].x_eager) for i in active])
        st, dg = numerics.to_host_async([st, dg])
        pos = {i: k for k, i in enumerate(active)}
        return ({i: st[k] for i, k in pos.items()}, {i: dg[k] for i, k in pos.items()},
                lambda i: xe_inputs[i])

    def dispatch(self) -> bool:
        """Run ONE lockstep model eval for every active lane, apply each lane's own
        sampler update, advance the plan counters, fire each lane's progress hook at
        its σ-interval boundaries and retire finished lanes. Returns False when there
        was nothing to run."""
        active = self.active_lanes()
        if not active:
            return False
        # A profiler range while a hardware_trace window is open (else nothing): the
        # same interval as the serving-dispatch span.
        with tracing.annotate("serving-dispatch"):
            plans, sentinel = self._step(active)
        self._advance(active, plans, sentinel)
        return True

    def _step(self, active: list[int]) -> tuple:
        """The lockstep eval, its synchronise, its metrics and spans; returns the
        lanes' plans and the sentinel's ``(stats, digests, eval input)`` or None."""
        t0_us = tracing.now_us() if tracing.on() else 0.0
        t0 = time.perf_counter()
        plans = {i: self.lanes[i].plan() for i in active}
        with torch.no_grad():
            if self.spec is not None:
                sentinel = self._dispatch_program(active, plans)
                out = self._x
            else:
                sentinel = self._dispatch_eager(active, plans)
                out = self.lanes[active[0]].x_eager
        if out.device.type == "cuda":
            # The step histogram must include device time.
            torch.cuda.synchronize(out.device)
        dt = time.perf_counter() - t0
        self.dispatch_count += 1
        registry.counter("pa_serving_dispatch_total", labels=self._labels,
                         help="lockstep step dispatches")
        registry.counter("pa_serving_lane_steps_total", inc=len(active), labels=self._labels,
                         help="lane-steps served (occupancy summed over dispatches)")
        record_dispatch_occupancy(len(active))
        registry.histogram("pa_serving_step_seconds", dt, labels=self._labels,
                           help="wall time of one lockstep dispatch")
        if tracing.on() and t0_us:
            # One dispatcher-side span (occupancy and masked lanes), and one step
            # span per live lane on its own prompt's timeline. The dispatch above
            # ended at its synchronise, so the interval holds the device time, and
            # tracing added no synchronisation.
            dur_us = tracing.now_us() - t0_us
            tracing.record("serving-dispatch", t0_us, dur_us, cat="serving",
                           bucket=self.label, occupancy=len(active),
                           masked_lanes=self.width - len(active), width=self.width)
            for i in active:
                lane = self.lanes[i]
                tracing.record(
                    "step", t0_us, dur_us, cat="serving", tid=lane.req.trace_tid,
                    prompt_id=lane.req.prompt_id, bucket=self.label, lane=i,
                    step=lane.idx + 1, of=lane.req.n_steps, occupancy=len(active),
                    **({"trace_id": lane.req.trace_id} if lane.req.trace_id else {}))
        return plans, sentinel

    def _advance(self, active: list[int], plans: dict, sentinel=None) -> None:
        """After a dispatch: the sentinel's check (each lane's digest kept, a
        non-finite lane quarantined before its plan counter moves), then advance
        each lane's plan counter, fire its progress hook at a σ-interval boundary,
        retire it when its evals are done."""
        if sentinel is not None:
            st, dg, xe_of = sentinel  # host tensors: the dispatch has synchronised
            for i in active:
                self.lanes[i].digests.append(int(dg[i]))
                if float(st[i][0]) > 0:
                    self._quarantine(i, plans[i], st[i], xe_of(i), occupancy=len(active))
        for i in active:
            lane, plan = self.lanes[i], plans[i]
            if lane is None:
                continue  # quarantined at this boundary
            lane.pc += 1
            if plan.completes:
                # The σ-interval finished (two evals for second-order lanes): the
                # progress unit the hooks report.
                lane.idx += 1
                hook = lane.req.progress_hook
                if hook is not None:
                    try:
                        hook(lane.idx, lane.req.n_steps)
                    except Exception:  # noqa: BLE001 - a UI hook must not kill lanes
                        pass
            if lane.done():
                result = self._x[i].clone() if self.spec is not None else lane.x_eager
                self._retire(i, result=result)
        self._gauges()
