"""Continuous-batching scheduler: step-boundary batched scheduling of concurrent
sampler runs (counterpart of ``comfyui_parallelanything_tpu/serving/scheduler.py``).

Every model eval of a sampler run is the same batched call, so runs that agree on
(model, latent shape, prediction, CFG mode) can share ONE per-lane step program,
whatever sampler of the ``LaneStepSpec`` registry each runs: a request joins the
shared batch at the next step boundary, runs its own schedule and its own sampler
state machine in its own lane, and retires when its own eval count completes
(``serving/bucket.py``). This module is the glue between the callers
(``sampling/runner.py`` routes eligible ``run_sampler`` work here when a scheduler
is installed; ``server.py`` installs one when it runs several prompt workers) and
the buckets:

- **shape-bucketed admission**: work keyed by (model id, latent shape and dtype,
  prediction, CFG mode, cfg rescale, cond shape, kwarg shapes, the alpha-bar
  schedule's fingerprint), not the sampler, which rides per lane; each bucket is
  made on first sight with a width the model bounds
  (``ParallelModel.serving_bucket_width``: streaming and heterogeneous chains stay
  width 1);
- **policy**: FIFO within a priority, bounded depth (``serving/policy.py``), a
  per-request deadline, cancel through the per-thread cooperative interrupt scope
  (``utils/progress.py``): a prompt's Cancel frees its lane at the next boundary
  without touching its neighbours;
- **dispatcher**: one thread owns every model step (one card: lockstep is the
  schedule), round-robin over the buckets; ``auto=False`` exposes the same loop as
  ``pump()`` for deterministic tests;
- **the OOM ladder**: a dispatch that runs out of memory (``is_out_of_memory``:
  the card's or the host allocator's) halves the bucket's width and re-seats its
  requests from step 0; at width 1 it resolves them ``DegradedToInline`` and
  ``run_sampler`` runs them on the inline path.

Capability state rides the request as per-lane data, not the bucket key: a denoise
mask, multi-cond extras, a delegated ControlNet or per-request LoRA factors never
split buckets, so mixed traffic shares one dispatch stream (the JAX scheduler's
rules). A ControlNet composition that publishes a ``control_delegate``
(``models/controlnet.apply_control``) is bucketed on its base model with the control
trunk as per-lane state, and its width-1 eager twin keeps the merged net.
Multi-cond extras must pin to the primary cond's (L, D) and a batch of 1 or b;
pooled extras need ``y``. LoRA factors must match the served module's parameters
(``models/lora.lora_signature``), on ``nn.Linear`` / ``nn.Conv2d`` targets of a
single-replica model.

Ineligible work is never queued: ``maybe_submit`` returns None and the caller runs
inline exactly as before. That covers an unknown sampler, odd kwarg shapes, a full
queue, a latent-preview prompt, an extra cond of another (L, D), a LoRA whose
signature misses, a hint batch that is neither 1 nor b, and what the JAX scheduler
also keeps inline: a model that carries per-request conditioning inside it with no
delegate (a chained ControlNet composition, inpaint and Wan i2v compositions).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

import numpy as np
import torch

from ..sampling.lane_specs import LANE_SPECS
from ..utils import tracing
from ..utils.metrics import registry
from ..utils.progress import (
    Interrupted,
    clear_interrupt,
    current_progress_hook,
    current_scope,
    interrupt_requested,
)
from .bucket import ServeRequest, StepBucket
from .policy import ServingRejected

# Every registered LaneStepSpec (sampling/lane_specs.py): history-carrying,
# two-eval and stochastic families included.
BATCHABLE_SAMPLERS = frozenset(LANE_SPECS)

_installed: "ContinuousBatchingScheduler | None" = None
_install_lock = threading.Lock()
_hints = threading.local()


def get_scheduler() -> "ContinuousBatchingScheduler | None":
    """The process-wide scheduler ``run_sampler`` consults, or None (inline)."""
    return _installed


@contextlib.contextmanager
def serving_hints(priority: int = 0, deadline_s: float | None = None):
    """Per-thread policy hints for sampler work submitted inside the block (the
    server's worker sets them from POST /prompt's ``extra_data``)."""
    prev = getattr(_hints, "value", None)
    _hints.value = {
        "priority": int(priority),
        "deadline": None if deadline_s is None else time.monotonic() + float(deadline_s),
    }
    try:
        yield
    finally:
        _hints.value = prev


def _current_hints() -> dict:
    return getattr(_hints, "value", None) or {"priority": 0, "deadline": None}


def _kwarg_sig(tree: dict, batch: int):
    """Hashable (name, shape, dtype) signature of a traced-kwargs dict, or None if
    a leaf lacks the request's batch dim (lanes stack kwargs on a new axis, so
    every leaf must be per request)."""
    sig = []
    for k in sorted(tree):
        v = tree[k]
        if getattr(v, "ndim", 0) < 1 or v.shape[0] != batch:
            return None
        sig.append((k, tuple(v.shape), str(v.dtype), str(v.device)))
    return tuple(sig)


def _carries_request_state(model) -> bool:
    """True for a model whose module holds per-request conditioning with no serving
    delegate (a chained ControlNet composition's hints, an inpaint mask and masked
    latent, a Wan i2v clip): it cannot take other requests' rows in the same call,
    and the JAX scheduler keeps it inline too."""
    from ..models.controlnet import ControlledModel
    from ..models.unet import InpaintConditioned
    from ..models.wan import I2VConditioned

    module = getattr(model, "_module", None)
    module = model if module is None else module
    module = getattr(module, "module", module)
    if not isinstance(module, torch.nn.Module):
        return False
    return any(isinstance(m, (ControlledModel, InpaintConditioned, I2VConditioned))
               for m in module.modules())


class ContinuousBatchingScheduler:
    """Owns the buckets, the admission policy and the dispatcher thread."""

    def __init__(self, max_width: int | None = None, max_waiting: int = 64,
                 samplers=BATCHABLE_SAMPLERS, auto: bool = True):
        self.max_width = int(max_width if max_width is not None
                             else os.environ.get("PA_SERVING_WIDTH", "4"))
        self.max_waiting = max_waiting
        self.samplers = frozenset(samplers)
        self.buckets: dict[tuple, StepBucket] = {}  # guarded-by: _lock
        # OOM-ladder width caps: the bucket key without its width → the widest
        # lane count still allowed after a dispatch OOM, applied to later
        # submissions of the same shape (an OOM is a property of the shape on this
        # device, not of one request).
        self._width_caps: dict[tuple, int] = {}  # guarded-by: _lock
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        # Held for a whole scheduling round; a captured loop's warm-up and
        # capture hold it too (sampling/compiled.py), so none overlaps a dispatch.
        self.dispatch_lock = threading.Lock()
        self._stop = False
        self._thread = None
        if auto:
            self._thread = threading.Thread(target=self._loop, name="pa-serving-dispatcher",
                                            daemon=True)
            self._thread.start()

    # -- lifecycle ----------------------------------------------------------

    def install(self) -> "ContinuousBatchingScheduler":
        global _installed
        with _install_lock:
            _installed = self
        return self

    def uninstall(self) -> None:
        global _installed
        with _install_lock:
            if _installed is self:
                _installed = None

    def shutdown(self, timeout: float = 10.0) -> None:
        """Stop the dispatcher and resolve every outstanding request with
        ``Interrupted``: no submitter is left blocked on a dead scheduler."""
        self.uninstall()
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
        with self._lock:
            buckets = list(self.buckets.values())
            self.buckets.clear()
        for b in buckets:
            for req in self._drain_bucket(b):
                req.resolve(error=Interrupted("scheduler shutdown"))

    # -- submission ---------------------------------------------------------

    def maybe_submit(
        self, *, model, x, sigmas, context, sampler, cfg_scale, uncond_context,
        uncond_kwargs, alphas_cumprod, prediction, cfg_rescale, model_kwargs, rng=None,
        latent_mask=None, mask_init=None, mask_noise=None, extra_conds=(),
        cond_area=None, cond_area_pct=None, cond_mask=None, cond_strength=1.0,
        cond_mask_strength=1.0, lora=None,
    ) -> ServeRequest | None:
        """Admit one sampler run, or return None when it cannot share a step program
        (the caller runs inline). Called from ``run_sampler`` with the prepared
        noised latent, schedule and conditioning; per-step sampler math comes from
        the sampler's ``LaneStepSpec``. ``rng`` is the generator the inline sampler
        would draw its per-step noise from. Capability state (a denoise mask, extra
        conds, a delegated ControlNet, LoRA factors) rides the request, not the
        bucket key; eligibility checks only what the lane program cannot take."""
        if self._stop or sampler not in self.samplers:
            return None
        spec_entry = LANE_SPECS.get(sampler)
        if spec_entry is None or (prediction == "flow" and not spec_entry.flow_ok):
            return None
        if spec_entry.needs_rng and rng is None:
            return None
        from ..utils.progress import current_preview_hook

        if current_preview_hook() is not None:
            # Latent previews come from the inline loops' report_progress; a lane has
            # no preview channel.
            return None
        from ..parallel.split import partition_kwargs, static_kwargs_key
        from ..sampling.compiled import trace_spec_of

        b = int(x.shape[0])
        traced, static = partition_kwargs(model_kwargs or {})
        t_sig = _kwarg_sig(traced, b)
        if t_sig is None:
            return None
        use_cfg = uncond_context is not None and cfg_scale != 1.0
        u_traced: dict = {}
        u_sig: tuple = ()
        if use_cfg:
            if context is None or tuple(getattr(uncond_context, "shape", ())) != tuple(
                    context.shape):
                return None
            u_traced, _ = partition_kwargs(uncond_kwargs or {})
            u_sig = _kwarg_sig(u_traced, b)
            if u_sig is None:
                return None
        if context is not None and (getattr(context, "ndim", 0) < 1 or context.shape[0] != b):
            return None
        # ControlNet delegation: an apply_control composition is bucketed on its BASE
        # model (so control lanes co-batch with plain lanes of the same UNet) and the
        # control trunk rides the request; the width-1 eager twin keeps the merged
        # net. A chained composition publishes no delegate and stays opaque.
        eager_model = None
        control = None
        delegate = getattr(model, "control_delegate", None)
        if delegate is not None and getattr(x, "ndim", 0) == 4:
            base = delegate["base"]
            if trace_spec_of(base) is not None:
                hint = delegate["hint"]
                hb = 1 if getattr(hint, "ndim", 3) == 3 else int(hint.shape[0])
                if hb not in (1, b):
                    # The inline composition raises on a per-sample hint batch;
                    # inline surfaces that same error to the caller.
                    return None
                control = {"apply": delegate["ctrl_apply"], "params": delegate["ctrl_params"],
                           "hint": hint, "strength": delegate["strength"],
                           "start": delegate["start"], "end": delegate["end"]}
                eager_model = model
                model = base
        if _carries_request_state(model):
            return None
        if latent_mask is not None:
            # A denoise-mask lane needs both blend references.
            if mask_init is None or mask_noise is None:
                return None
            try:
                for ref in (latent_mask, mask_init, mask_noise):
                    if np.broadcast_shapes(tuple(getattr(ref, "shape", ())),
                                           tuple(x.shape)) != tuple(x.shape):
                        return None
            except ValueError:
                return None
        # Multi-cond extras pin to the primary cond's (L, D): the lane program stacks
        # every role's rows in one eval. Pooled extras need ``y`` in the traced
        # kwargs (whose shape the bucket key already holds).
        extra_conds = tuple(extra_conds or ())
        if extra_conds:
            if context is None or getattr(context, "ndim", 0) != 3:
                return None
            for e in extra_conds:
                ec = e.get("context")
                if ec is None or getattr(ec, "ndim", 0) != 3:
                    return None
                if tuple(ec.shape[1:]) != tuple(context.shape[1:]) \
                        or int(ec.shape[0]) not in (1, b):
                    return None
                pooled = e.get("pooled")
                if pooled is not None:
                    y = traced.get("y")
                    if (y is None or getattr(pooled, "ndim", 0) != 2
                            or int(pooled.shape[-1]) != int(y.shape[-1])
                            or int(pooled.shape[0]) not in (1, b)):
                        return None
        spec = trace_spec_of(model)
        # Per-lane LoRA: the factors must address the parameters of the module the
        # lane program runs (one replica: the hooks act on it), on layers the hook
        # serves. Width-1 eager lanes gain nothing over the inline merge.
        lora_factors = None
        if lora:
            if spec is None or len(spec.replicas) != 1 \
                    or not isinstance(spec.replicas[0], torch.nn.Module):
                return None
            from ..models.lora import lora_signature
            from ..sampling.compiled import lora_targets_ok

            module = spec.replicas[0]
            sig = lora_signature(lora, module)
            if sig is None or not lora_targets_ok(module, sig):
                return None
            if sig:
                lora_factors = dict(lora)
        if (control is not None or lora_factors) and spec is not None \
                and len(spec.replicas) != 1:
            return None  # the overlays run on one replica's module
        width = self.max_width
        bound = getattr(model, "serving_bucket_width", None)
        if callable(bound):
            width = bound(width)
        elif spec is None:
            width = 1
        if spec is not None and len(spec.replicas) > 1:
            # Data-parallel replicas: lanes pad to a whole share per replica.
            n = len(spec.replicas)
            width = max(n, (width // n) * n)
        acp = alphas_cumprod
        acp_fp = None
        if acp is not None:
            # Interior samples too: two custom schedules agreeing in length and
            # range must not share a bucket (its log-sigma table comes from the
            # first request).
            a = np.asarray(torch.as_tensor(acp, dtype=torch.float64).cpu())
            stride = max(1, a.shape[0] // 7)
            acp_fp = (a.shape[0],) + tuple(float(v) for v in a[::stride]) + (float(a[-1]),)
        key_prefix = (
            id(model), prediction, use_cfg, float(cfg_rescale), tuple(x.shape),
            str(x.dtype), str(x.device),
            None if context is None else (tuple(context.shape), str(context.dtype)),
            static_kwargs_key(static), t_sig, u_sig, acp_fp,
        )
        with self._lock:
            cap = self._width_caps.get(key_prefix)
        if cap is not None:
            width = min(width, cap)
        key = key_prefix + (width,)
        scope = current_scope()
        req = ServeRequest(
            x=x, sigmas=np.asarray(torch.as_tensor(sigmas, dtype=torch.float32).cpu()),
            context=context, sampler=sampler, rng=rng,
            uncond_context=uncond_context if use_cfg else None,
            traced_kwargs=traced, static_kwargs=static, u_traced=u_traced,
            uncond_kwargs=uncond_kwargs if use_cfg else None,
            cfg_scale=float(cfg_scale), cfg_rescale=float(cfg_rescale),
            prediction=prediction, acp=acp, latent_mask=latent_mask,
            mask_init=mask_init, mask_noise=mask_noise, extra_conds=extra_conds,
            cond_area=cond_area, cond_area_pct=cond_area_pct, cond_mask=cond_mask,
            cond_strength=float(cond_strength), cond_mask_strength=float(cond_mask_strength),
            control=control, lora=lora_factors, eager_model=eager_model,
            progress_hook=current_progress_hook(),
            interrupt_event=scope.interrupt_event if scope is not None else None,
            prompt_id=(tracing.current_prompt_id() if tracing.on()
                       else scope.prompt_id if scope is not None else None),
            # Trace correlation captured on the submitting thread: its tid (the
            # dispatcher records this request's lane-wait/step/lane spans onto that
            # timeline), its submit time on the trace clock and its trace id.
            trace_tid=threading.get_ident() if tracing.on() else None,
            trace_submit_us=tracing.now_us() if tracing.on() else None,
            trace_id=tracing.current_trace_id() if tracing.on() else None,
            **_current_hints(),
        )
        with self._lock:
            bucket = self.buckets.get(key)
            if bucket is None:
                name = getattr(model, "name", None) or type(model).__name__
                label = f"{name}:{prediction}:{'x'.join(str(d) for d in x.shape)}"
                bucket = StepBucket(key, label, width=width, model=model, spec=spec,
                                    max_waiting=self.max_waiting)
                self.buckets[key] = bucket
            try:
                bucket.queue.push(req)
            except ServingRejected:
                registry.counter("pa_serving_rejected_total", labels={"bucket": bucket.label},
                                 help="admissions refused (queue depth bound)")
                return None
            self._cond.notify_all()
        return req

    def kick(self) -> None:
        """Wake the dispatcher (a cancel should act at the next boundary)."""
        with self._cond:
            self._cond.notify_all()

    # -- dispatch -----------------------------------------------------------

    def total_dispatches(self) -> int:
        with self._lock:
            return sum(b.dispatch_count for b in self.buckets.values())

    def reuse_stats(self) -> dict:
        """The /health ``reuse.serving`` section: occupied buckets running the
        shared-cond program against stacked rows."""
        with self._lock:
            buckets = list(self.buckets.values())
        modes = [b._cond_mode for b in buckets if b.active_lanes()]
        return {"buckets_shared_cond": sum(1 for m in modes if m == "shared"),
                "buckets_stacked_cond": sum(1 for m in modes if m == "stacked")}

    def _has_work(self) -> bool:
        with self._lock:
            return any(not b.idle() for b in self.buckets.values())

    def pump(self) -> bool:
        """One scheduling round: sweep cancels, admit at the boundary, and run ONE
        lockstep dispatch per non-empty bucket. Returns whether any bucket
        dispatched. The dispatcher thread calls this in a loop; ``auto=False``
        tests call it directly."""
        did = False
        with self.dispatch_lock:
            with self._lock:
                buckets = list(self.buckets.values())
            if interrupt_requested() and any(b.active_lanes() or len(b.queue)
                                             for b in buckets):
                # Process-wide Cancel (POST /interrupt): every lane and queued
                # request stops at this boundary; the flag is consumed as the
                # inline loops' check consumes it.
                clear_interrupt()
                for b in buckets:
                    while (req := b.queue.pop()) is not None:
                        req.resolve(error=Interrupted("interrupted while queued"))
                    for i in b.active_lanes():
                        b.lanes[i].req.cancel_event.set()
            for b in buckets:
                b.sweep_cancelled()
                b.admit()
            for b in buckets:
                try:
                    did = b.dispatch() or did
                except Exception as e:  # noqa: BLE001 - no waiter may hang
                    if self._degrade_bucket(b, e):
                        continue
                    # Resolve every request the dying bucket holds, seated lanes
                    # and the waiting line, before dropping it.
                    with self._lock:
                        self.buckets.pop(b.key, None)
                    for req in self._drain_bucket(b):
                        req.resolve(error=e)
            for b in buckets:
                if b.idle():
                    b.release_state()
            self._trim_buckets()
        return did

    # -- the OOM ladder (utils/degrade.py) ------------------------------------

    def _drain_bucket(self, b: StepBucket) -> list:
        """Every request the bucket holds (seated lanes first, then the waiting
        line), the bucket emptied. Seated requests restart from step 0 when
        re-seated: their noise is a function of (request, step), so a restart
        repeats the same draws."""
        reqs = []
        for i in b.active_lanes():
            reqs.append(b.lanes[i].req)
            b.lanes[i] = None
        while (req := b.queue.pop()) is not None:
            reqs.append(req)
        b.release_state()
        return reqs

    def _reseat(self, reqs, model, spec, label: str, key_prefix: tuple, width: int) -> None:
        """Park drained requests in a (new) bucket of ``width``; what the admission
        bound refuses goes to the inline path rather than being lost."""
        from ..utils.degrade import DegradedToInline

        key = key_prefix + (width,)
        with self._lock:
            bucket = self.buckets.get(key)
            if bucket is None:
                bucket = StepBucket(key, label, width=width, model=model, spec=spec,
                                    max_waiting=self.max_waiting)
                self.buckets[key] = bucket
            for req in reqs:
                try:
                    bucket.queue.push(req)
                except ServingRejected as e:
                    req.resolve(error=DegradedToInline(f"re-seat after degradation refused: {e}"))
            self._cond.notify_all()

    def _degrade_bucket(self, b: StepBucket, e: BaseException) -> bool:
        """The serving OOM ladder: width halve, then inline. Returns True when the
        ladder absorbed the error (every request the bucket held is re-seated or
        shed, none resolves with ``e``); False hands the error back to the caller's
        resolve-everything path."""
        from ..parallel.orchestrator import is_out_of_memory
        from ..utils.degrade import DegradedToInline, record_rung

        if not is_out_of_memory(e):
            return False
        # Pop before draining, under the submit lock: after the pop no new request
        # can land in the doomed bucket's queue.
        with self._lock:
            self.buckets.pop(b.key, None)
        reqs = self._drain_bucket(b)
        if b.spec is not None and b._x is not None and b._x.device.type == "cuda":
            torch.cuda.empty_cache()
        key_prefix = b.key[:-1]
        new_width = max(1, b.width // 2)
        if new_width < b.width:
            record_rung("lane-width-halve",
                        f"bucket {b.label}: {type(e).__name__} at width {b.width} → "
                        f"{new_width}; requests re-seated",
                        bucket=b.label, width_before=b.width, width_after=new_width)
            with self._lock:
                self._width_caps[key_prefix] = new_width
            self._reseat(reqs, b.model, b.spec, b.label, key_prefix, new_width)
            return True
        for req in reqs:
            req.resolve(error=DegradedToInline(
                f"serving OOM ladder exhausted for bucket {b.label}: {e}"))
        return True

    def drain(self, timeout: float = 120.0) -> None:
        """Pump until every bucket is idle (manual mode helper)."""
        t0 = time.monotonic()
        while self._has_work():
            self.pump()
            if time.monotonic() - t0 > timeout:
                raise TimeoutError("serving drain timed out")

    def _trim_buckets(self, keep: int = 32) -> None:
        with self._lock:
            if len(self.buckets) <= keep:
                return
            for key in [k for k, b in self.buckets.items() if b.idle()]:
                if len(self.buckets) <= keep:
                    break
                self.buckets.pop(key)

    def _loop(self) -> None:
        while True:
            with self._cond:
                if self._stop:
                    return
                if not self._has_work():
                    self._cond.wait(timeout=0.2)
                    continue
            try:
                self.pump()
            except Exception:  # noqa: BLE001 - the dispatcher must survive
                time.sleep(0.05)
