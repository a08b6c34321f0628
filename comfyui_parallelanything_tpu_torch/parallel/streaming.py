"""Double-buffered weight streaming: run a model whose weights exceed the device
budget (counterpart of ``comfyui_parallelanything_tpu/parallel/streaming.py``).

FLUX-dev holds 30.3 GB of weights in bf16 (12 GB in int8); a card with less room,
or one whose text encoders and VAE leave too little, cannot hold them. The answer
of ZeRO-Inference and of the JAX package is to keep the weights in host memory and
stream them through the device stage by stage, the next stage's copy overlapping
the current stage's compute. A ``PipelineSpec`` (``models/api.py``) splits the
forward into prepare → one segment per block → finalize, and
``models/loader.carve_ranges`` groups contiguous segments into byte-bounded
stages. On one device:

- **Master copy.** Every segment's parameters and buffers (an int8 weight's payload
  and its ``Dequantize`` scales too) are copied once into one flat host buffer in
  segment order (``loader.pin_params_host``), page-locked for a GPU. A stage, a
  contiguous run of segments, is one contiguous byte range of it, so one
  ``cudaMemcpyAsync``, and a re-carve reuses the buffer. The prepare and finalize
  submodules (the small remainder) are placed on the device once and stay there.
- **Ring.** Two device slots, each the size of the largest stage, allocated on the
  first call. Stage k's tensors are views into slot k mod 2 at the offsets they
  have in the host buffer, and its module is a view of the model (the pipeline
  runner's walk, ``pipeline._view_with``) whose stage submodules are copies holding
  those views. Nothing is allocated per call, so the caching allocator never hands
  a slot's memory to anything else while a copy or a stage still uses it.
- **Schedule.** Copies run on a copy stream of their own, stages on the caller's
  current stream, ordered by CUDA events: stage k+1's copy waits for stage k−1's
  compute, the last reader of its slot, and stage k's compute waits for its own
  copy. The host never blocks. The event wait is the backpressure the JAX runner
  gets from a host block on stage k−1's output: at most two stages of weights are
  on the device, and ``tracker`` (``devices.memory.ResidencyTracker``) shows it.
- ``overlap=False`` is the debug mode: every copy and every stage runs to
  completion in program order, so a failure points at one stage.
- On the CPU the same layout, ring and views run with synchronous copies (the CPU
  tests).
- A failed call retires its live stages and frees the ring (the next call
  allocates it again), so the orchestrator's re-carve on an out-of-memory error
  (``ParallelModel._stream_call``, ``recarved``) starts from a clean allocator.

Tracing (``utils/tracing.py``, the JAX runner's span vocabulary): a traced call
records one ``stream-run`` with ``stream-prepare``, a ``stream-stage-prefetch`` per
stage copy, a ``stream-wait`` where a copy waits for the compute that frees its
slot (the backpressure), a ``stream-prefetch-wait`` where a stage's compute waits
for its copy (the exposed transfer), a ``stream-stage-compute`` per stage and
``stream-finalize``, and sets ``pa_stream_overlap_efficiency{device=}`` (stage
compute over the run). On a GPU the host never blocks, so these are device
intervals: CUDA events recorded on the copy and compute streams while tracing is
on, placed on the trace clock when the trace is exported (``Tracer.defer``); the
copy stream's spans go on a track of their own. On the CPU they are host
intervals. Tracing adds no synchronisation.

Numerics sentinel (``utils/numerics.py``), as the JAX runner's ``_check_stage``:
with it on, each stage's carry and the call's output are counted for non-finite
elements on the compute stream into one small device buffer, copied to the host
without blocking, and read once that copy's event has completed (at the next call,
or any read of the sentinel's records): the runner still never blocks the host, and
a call makes the same synchronise calls with the sentinel on and off. A non-finite
stage records a ``stream-stage`` event naming its stage and blocks (the output a
``stream-output`` event); ``last_stage_counts`` keeps the last call's counts.

Fault site ``stream-prefetch-oom`` (``utils/faults.py``): an armed plan makes a
stage's copy raise an out-of-memory error, so the orchestrator's ``stream-recarve``
rung runs.

The orchestrator routes here when the weights do not fit the device budget, or for
``weight_sharding="stream"``. Under an active ``sequence_parallel`` context a call
raises ``ValueError``, as the JAX runner's. Not ported yet: the JAX runner's
``pa_hbm_stream_*`` gauges (ROADMAP Queue 1 item 9d).
"""

from __future__ import annotations

import copy
import dataclasses
import logging
import threading
from typing import Any, Callable

import torch

from ..devices.memory import ResidencyTracker
from ..models.api import PipelineSpec
from ..models.loader import (
    HostCopy,
    carve_ranges,
    host_view,
    module_tensors,
    params_nbytes,
    pin_params_host,
    segment_nbytes,
)
from ..utils import faults, numerics, tracing
from .orchestrator import _to
from .pipeline import _stage_view, _view_with

logger = logging.getLogger(__name__)


@dataclasses.dataclass(eq=False)
class _Master:
    """What every carve of one model on one device shares: the host copy, where
    each segment's tensors lie in it, the segments' bytes, the resident prepare and
    finalize views, and the copy stream."""

    host: HostCopy
    tensor_ranges: list[tuple[int, int]]  # per segment: its tensors' indices in ``host``
    sizes: list[int]  # per segment: stored bytes
    prepare: torch.nn.Module
    finalize: torch.nn.Module
    resident_nbytes: int
    copy_stream: Any  # torch.cuda.Stream on a GPU, else None

    @classmethod
    def build(cls, spec: PipelineSpec, module: torch.nn.Module,
              device: torch.device) -> "_Master":
        tensors: list[torch.Tensor] = []
        ranges = []
        for seg in spec.segments:
            ts = module_tensors(module, seg.param_keys)
            ranges.append((len(tensors), len(tensors) + len(ts)))
            tensors.extend(ts)
        return cls(
            host=pin_params_host(tensors, device), tensor_ranges=ranges,
            sizes=segment_nbytes(spec, module),
            prepare=_stage_view([module], spec.prepare_keys, device),
            finalize=_stage_view([module], spec.finalize_keys, device),
            resident_nbytes=(params_nbytes(module, spec.prepare_keys)
                             + params_nbytes(module, spec.finalize_keys)),
            copy_stream=torch.cuda.Stream(device) if device.type == "cuda" else None)


@dataclasses.dataclass
class _Stage:
    range: tuple[int, int]  # segments [s, e)
    keys: tuple[str, ...]  # the submodules it streams
    fns: tuple[Callable[[Any, dict], dict], ...]
    labels: tuple[str, ...]
    nbytes: int  # stored bytes of its tensors: the tracker's unit
    span: tuple[int, int]  # its bytes in the host copy
    module: torch.nn.Module | None = None  # the view bound to its slot, made with the ring


class _CallTrace:
    """The spans of one traced streamed call. A mark is a CUDA event recorded on a
    stream (a GPU) or the host clock (the CPU); ``finish`` records the spans at once
    (CPU) or hands them to the tracer to place at export (GPU)."""

    def __init__(self, runner: "StreamingRunner", device: torch.device):
        self.runner = runner
        self.device = device
        self.cuda = device.type == "cuda"
        self.tid = threading.get_ident()
        self.prompt_id = tracing.current_prompt_id()
        self.trace_id = tracing.current_trace_id()
        copy_stream = runner._master.copy_stream
        # The copy stream's spans overlap the compute stream's in time: a track of
        # their own keeps each track's spans nested.
        self.copy_tid = copy_stream.cuda_stream if self.cuda else self.tid
        if self.cuda:
            tracing.tracer.name_track(self.copy_tid, f"copy stream ({device})")
        self.spans: list[tuple] = []

    def mark(self, stream=None):
        if not self.cuda:
            return tracing.now_us()
        event = torch.cuda.Event(enable_timing=True)
        event.record(stream)
        return event

    def add(self, name: str, start, end, on_copy: bool = False, **attrs) -> None:
        self.spans.append((name, start, end, on_copy, attrs))

    def finish(self) -> None:
        if self.cuda:
            tracing.defer(self._resolve)
        else:
            self._resolve(lambda mark, device=None: mark)

    def _resolve(self, at) -> None:
        placed = [(name, at(a, self.device), at(b, self.device), on_copy, attrs)
                  for name, a, b, on_copy, attrs in self.spans]
        t0 = min(a for _, a, _, _, _ in placed)
        t1 = max(b for _, _, b, _, _ in placed)
        ctx = dict(prompt_id=self.prompt_id,
                   **({"trace_id": self.trace_id} if self.trace_id else {}))
        runner = self.runner
        tracing.record("stream-run", t0, t1 - t0, cat="stream", tid=self.tid,
                       stages=runner.n_stages, device=str(self.device),
                       overlap=runner.overlap, **ctx)
        compute_us = 0.0
        for name, a, b, on_copy, attrs in placed:
            tracing.record(name, a, b - a, cat="stream",
                           tid=self.copy_tid if on_copy else self.tid, **attrs, **ctx)
            if name == "stream-stage-compute":
                compute_us += b - a
        if t1 > t0:
            from ..utils.metrics import registry

            registry.gauge("pa_stream_overlap_efficiency", min(1.0, compute_us / (t1 - t0)),
                           labels={"device": str(self.device)},
                           help="stage-compute fraction of streamed-run time (1.0 = "
                                "transfers fully hidden)")


class StreamingRunner:
    """Callable ``(x, timesteps, context=None, **kwargs) -> output`` running the
    staged forward on ONE device with double-buffered weight streaming. Built once
    per (spec, module, device, carve); every call streams the stage weights from
    the host copy again, so only about two stages are ever on the device."""

    def __init__(self, spec: PipelineSpec, module: torch.nn.Module, device, *,
                 max_stage_bytes: int | None = None, n_stages: int | None = None,
                 overlap: bool = True, _master: _Master | None = None):
        self.device = torch.device(device)
        self.overlap = overlap
        self.tracker = ResidencyTracker()
        self._spec = spec
        self._module = module
        # A re-carve passes the master on, so the host copy is made once.
        self._master = _master or _Master.build(spec, module, self.device)
        m = self._master
        self.tracker.add_resident(m.resident_nbytes)
        self.stages: list[_Stage] = []
        for s, e in carve_ranges(m.sizes, max_stage_bytes=max_stage_bytes, n_stages=n_stages):
            keys: list[str] = []
            for seg in spec.segments[s:e]:
                keys.extend(k for k in seg.param_keys if k not in keys)
            first, last = m.tensor_ranges[s][0], m.tensor_ranges[e - 1][1]
            span = (m.host.offsets[first], m.host.ends[last - 1]) if last > first else (0, 0)
            self.stages.append(_Stage(
                range=(s, e), keys=tuple(keys), fns=tuple(seg.fn for seg in spec.segments[s:e]),
                labels=tuple(seg.label for seg in spec.segments[s:e]),
                nbytes=params_nbytes(module, keys), span=span))
        self._ring: list[torch.Tensor] | None = None
        # The numerics sentinel's per-stage non-finite counts of the last call whose
        # counts were read (stages, then the output), or None.
        self.last_stage_counts: list[int] | None = None
        cuda = self.device.type == "cuda"
        self._copied = [torch.cuda.Event() for _ in range(2)] if cuda else None
        self._freed = [torch.cuda.Event() for _ in range(2)] if cuda else None
        logger.info("weight streaming on %s: %d stages over %d segments, max stage %.1f MiB, "
                    "double-buffered (%s)", self.device, len(self.stages), len(spec.segments),
                    self.max_stage_nbytes / 2**20, "overlap" if overlap else "no-overlap debug")

    # -- introspection -------------------------------------------------------------

    @property
    def n_stages(self) -> int:
        return len(self.stages)

    @property
    def max_stage_nbytes(self) -> int:
        return max(st.nbytes for st in self.stages)

    @property
    def streamed_nbytes(self) -> int:
        return sum(st.nbytes for st in self.stages)

    @property
    def pinned_nbytes(self) -> int:
        """Host bytes page-locked for the master copy (0 off a GPU)."""
        return self._master.host.pinned_nbytes

    def recarved(self) -> "StreamingRunner | None":
        """A runner over the same host copy with the stage size halved: the
        streaming OOM demotion. None when no strictly finer carve exists: at one
        segment per stage, or when a lone oversized segment pins the cap (halving it
        would give the same carve, and the retry loop would spin on a deterministic
        OOM)."""
        if len(self.stages) >= len(self._spec.segments):
            return None
        cap = max(1, self.max_stage_nbytes // 2)
        if len(carve_ranges(self._master.sizes, max_stage_bytes=cap)) <= len(self.stages):
            return None
        return StreamingRunner(self._spec, self._module, self.device, max_stage_bytes=cap,
                               overlap=self.overlap, _master=self._master)

    # -- the ring --------------------------------------------------------------------

    def _bind(self, stage: _Stage, slot: torch.Tensor) -> torch.nn.Module:
        """A view of the model whose stage submodules hold views into ``slot``."""
        m, base = self._master, stage.span[0]
        memo: dict[int, Any] = {}
        for i in range(*stage.range):
            lo, hi = m.tensor_ranges[i]
            ts = module_tensors(self._module, self._spec.segments[i].param_keys)
            if len(ts) != hi - lo:
                raise RuntimeError("the model's tensors changed after its weights were "
                                   "copied to the host; wrap it again")
            for t, j in zip(ts, range(lo, hi)):
                if id(t) not in memo:
                    v = host_view(slot, m.host.offsets[j] - base, t)
                    memo[id(t)] = (torch.nn.Parameter(v, requires_grad=False)
                                   if isinstance(t, torch.nn.Parameter) else v)
        return _view_with(self._module, stage.keys,
                          lambda key: copy.deepcopy(self._module.get_submodule(key), memo))

    def _ensure_ring(self) -> None:
        if self._ring is not None:
            return
        size = max(b - a for a, b in (st.span for st in self.stages))
        ring = [torch.empty(size, dtype=torch.uint8, device=self.device)
                for _ in range(min(2, len(self.stages)))]
        if self._master.copy_stream is not None:
            for slot in ring:  # written on the copy stream: freed only after its copies
                slot.record_stream(self._master.copy_stream)
        for k, stage in enumerate(self.stages):
            stage.module = self._bind(stage, ring[k % 2])
        self._ring = ring

    def _release_ring(self) -> None:
        self._ring = None
        for stage in self.stages:
            stage.module = None

    def _fetch(self, k: int, trace: _CallTrace | None = None) -> None:
        """Issue stage ``k``'s host→device copy into slot k mod 2."""
        act = faults.check("stream-prefetch-oom", key=str(k))
        if act is not None:
            raise faults.oom_error(act)
        stage, slot = self.stages[k], self._ring[k % 2]
        a, b = stage.span
        src = self._master.host.buffer[a:b]
        cs = self._master.copy_stream
        if trace is not None:
            w0 = trace.mark(cs)
        if cs is None:
            start = w0 if trace is not None else None
            with tracing.annotate("stream-stage-prefetch"):
                slot[:b - a].copy_(src)
        else:
            cs.wait_event(self._freed[k % 2])  # stage k-2, the slot's last reader
            if trace is not None:
                start = trace.mark(cs)
                if k >= 2:
                    trace.add("stream-wait", w0, start, on_copy=True, stage=k - 2,
                              blocked_on="compute")
            with torch.cuda.stream(cs), tracing.annotate("stream-stage-prefetch"):
                slot[:b - a].copy_(src, non_blocking=True)
            self._copied[k % 2].record(cs)
            if not self.overlap:
                cs.synchronize()
        if trace is not None:
            trace.add("stream-stage-prefetch", start, trace.mark(cs), on_copy=True, stage=k,
                      nbytes=stage.nbytes, blocking=not self.overlap)
        self.tracker.place(k, stage.nbytes)

    # -- the double-buffered schedule ---------------------------------------------

    def __call__(self, x, timesteps, context=None, **kwargs):
        from ..ops.attention import sequence_ctx_key

        if sequence_ctx_key() is not None:
            raise ValueError(
                "weight streaming does not compose with an active "
                "sequence_parallel context (stage programs are pinned to one "
                "device); exit the context or run a resident placement"
            )
        with tracing.annotate("stream-run"):
            return self._run(x, timesteps, context, kwargs)

    def _record_counts(self, counts) -> None:
        """The sentinel's read of one call's counts (stages, then the output)."""
        counts = [int(c) for c in counts]
        self.last_stage_counts = counts
        last = len(self.stages) - 1
        for k, nf in enumerate(counts):
            if not nf:
                continue
            stage = self.stages[min(k, last)]
            numerics.sentinel.record_event(
                "stream-stage" if k < last else "stream-output", stage=min(k, last),
                device=str(self.device), nonfinite=nf, blocks=",".join(stage.labels))
            if k >= last:
                break  # the output covers the last stage, as the JAX tail check

    def _run(self, x, timesteps, context, kwargs):
        dev, n = self.device, len(self.stages)
        numerics.sentinel.flush()
        self._ensure_ring()
        compute = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
        trace = _CallTrace(self, dev) if tracing.on() else None
        counts = torch.zeros(n + 1, dtype=torch.int64, device=dev) if numerics.on() else None
        try:
            with torch.no_grad():
                if trace is not None:
                    start = trace.mark(compute)
                carry = self._spec.prepare(self._master.prepare, _to(x, dev),
                                           _to(timesteps, dev), _to(context, dev),
                                           **_to(kwargs, dev))
                if trace is not None:
                    done = trace.mark(compute)
                    trace.add("stream-prepare", start, done)
                self._fetch(0, trace)
                for k, stage in enumerate(self.stages):
                    if k:
                        # Stage k-1's compute is ordered before the copy that reuses
                        # its slot (the event wait in ``_fetch``).
                        self.tracker.retire(k - 1)
                    if k + 1 < n:
                        self._fetch(k + 1, trace)
                    if compute is not None:
                        compute.wait_event(self._copied[k % 2])
                    if trace is not None:
                        # The exposed transfer: the compute stream waiting for this
                        # stage's copy, booked apart from the compute.
                        start = trace.mark(compute)
                        trace.add("stream-prefetch-wait", done, start, stage=k,
                                  blocked_on="prefetch")
                    with tracing.annotate("stream-stage-compute"):
                        for fn in stage.fns:
                            carry = fn(stage.module, carry)
                        if counts is not None:
                            nf = numerics.count_nonfinite(carry)
                            if nf is not None:
                                counts[k] = nf
                    if trace is not None:
                        done = trace.mark(compute)
                        trace.add("stream-stage-compute", start, done, stage=k,
                                  nbytes=stage.nbytes)
                    if compute is not None:
                        self._freed[k % 2].record(compute)
                        if not self.overlap:
                            compute.synchronize()
                out = self._spec.finalize(self._master.finalize, carry, tuple(x.shape))
                if counts is not None:
                    counts[n] = numerics.count_nonfinite(out)
                if trace is not None:
                    trace.add("stream-finalize", done, trace.mark(compute))
            if counts is not None:
                # Read after the copy's event completes: no synchronise of its own.
                numerics.sentinel.defer([counts], self._record_counts)
            self.tracker.retire(n - 1)
            if trace is not None:
                trace.finish()
            return out
        except BaseException:
            for tag in self.tracker.live_tags:
                self.tracker.retire(tag)
            self._release_ring()
            raise


def build_streaming_runner(spec: PipelineSpec | None, module: torch.nn.Module, device, *,
                           hbm_budget_bytes: int | None = None, n_stages: int | None = None,
                           overlap: bool = True) -> StreamingRunner | None:
    """The weight-streaming runner, or None when the model declares no pipeline spec
    (nothing to carve). ``hbm_budget_bytes`` sizes the stages: two slots plus room
    for activations must fit, so each stage is capped at 2/5 of the budget (2 × 2/5
    weights + 1/5 activations). An explicit ``n_stages`` (the planner's carve) wins
    over the cap only when its byte-balanced carve still fits it: a planned carve
    never widens the double-buffer bound."""
    if spec is None or not spec.segments:
        return None
    max_stage_bytes = None
    if hbm_budget_bytes:
        max_stage_bytes = max(1, int(hbm_budget_bytes) * 2 // 5)
    if n_stages and max_stage_bytes:
        sizes = segment_nbytes(spec, module)
        ranges = carve_ranges(sizes, n_stages=int(n_stages))
        if max(sum(sizes[s:e]) for s, e in ranges) <= max_stage_bytes:
            max_stage_bytes = None  # the planned carve honours the cap
        else:
            n_stages = None  # it would not: the cap rules
    runner = StreamingRunner(spec, module, device, max_stage_bytes=max_stage_bytes,
                             n_stages=n_stages, overlap=overlap)
    logger.info("weight streaming enabled: %.2f GiB streamed + %.2f MiB resident through %d "
                "stages on %s (%.2f GiB pinned)", runner.streamed_nbytes / 2**30,
                runner.tracker.resident_bytes / 2**20, runner.n_stages, runner.device,
                runner.pinned_nbytes / 2**30)
    return runner
