"""End-to-end span tracing: per-prompt timelines from HTTP ingress to the card's
step (counterpart of ``comfyui_parallelanything_tpu/utils/tracing.py``, the same
vocabulary and export).

A process-wide :class:`Tracer` records per-prompt traces of nested spans

    prompt → workflow-node → sampler-run → lane-wait → step
                                              → stream-stage-{prefetch,compute}

exported as Chrome/Perfetto trace-event JSON (``GET /trace?prompt_id=...`` on the
server; open it at ui.perfetto.dev). Span names, categories and attributes are the
JAX package's, so a reader of one package's trace reads the other's.

Design rules (the near-zero-overhead contract):

- **disabled is a single flag check**: :func:`span` returns one shared ``_NULL``
  singleton when tracing is off: no Span object, no clock read, no buffer touch.
  Instrumentation sites that must *compute* attributes guard on :func:`on` first.
- **recording is lock-free per thread**: every recording thread owns a bounded
  ring (``deque``); the tracer's lock is taken once per thread, at registration,
  and at export.
- **prompt correlation rides the progress scopes**: a span opened with
  ``prompt_id=...`` sets the thread's current prompt; nested spans inherit it, and
  a thread without span context falls back to its ``utils.progress`` scope (the
  serving scheduler captures the submitting thread's identity at admission, so
  lane-wait/step spans recorded by the dispatcher land on the prompt's timeline).
- **cross-thread spans carry an explicit tid**: :func:`record` writes a completed
  span into the recording thread's buffer, stamped with the submitter's tid.
- **metrics stay consistent with traces**: every span feeds
  ``pa_trace_span_seconds{name=,cat=}``; evictions count in
  ``pa_trace_dropped_total{reason=}``.

Synchronisation discipline: the clock is read only at boundaries that already
synchronise (the serving bucket's and the decode queue's post-dispatch
``torch.cuda.synchronize``) or, where nothing blocks, the span is a host dispatch
window (the eager loops' ``step`` spans) and says so. Where the device runs ahead of
the host with no block at all (the streaming runner's copy and compute streams), a
span is measured on the device: CUDA events recorded on the streams while tracing
is on, handed to :meth:`Tracer.defer`, and placed on the trace clock when the
trace is exported, from an anchor event taken after a ``torch.cuda.synchronize``
there. Tracing adds no synchronisation to a traced path.

While a :func:`hardware_trace` window (``torch.profiler``) is open, every span
opened with :func:`span`, and every :func:`annotate` range, is also a profiler
``record_function`` range, so the device timeline in the profiler's trace lines up
with the host spans.
"""

from __future__ import annotations

import contextlib
import hashlib
import itertools
import os
import tempfile
import threading
import time
from collections import OrderedDict, deque
from typing import Callable, Optional

# Per-thread span buffer capacity: at ~150 bytes/span a thread's trace memory is a
# few MiB while holding minutes of step-granularity spans.
DEFAULT_CAPACITY = 16384

# The two secondary retention tiers, each with an explicit budget whose evictions
# are COUNTED (``pa_trace_dropped_total{reason=}`` and ``Tracer.dropped``):
# - retired ring: dead threads whose thread ident was recycled (one entry per dead
#   thread's whole buffer);
# - prompt retention: completed prompts snapshotted by :meth:`retain_prompt`.
RETIRED_RING_BUDGET = 256
PROMPT_RETENTION = 64
# Device-measured spans waiting for export (one entry per traced call).
DEFERRED_BUDGET = 1024

_span_ids = itertools.count(1)

_HEX = set("0123456789abcdef")


def format_traceparent(trace_id: str, span_id: int | None = None,
                       sampled: bool = True) -> str:
    """W3C-traceparent-style header ``00-<32hex trace_id>-<16hex span_id>-<01|00>``.
    A trace id that is not 32 lowercase hex characters is md5-hashed into shape;
    ``span_id`` defaults to a fresh id from the process-wide counter."""
    tid = str(trace_id).lower()
    if len(tid) != 32 or not set(tid) <= _HEX:
        tid = hashlib.md5(str(trace_id).encode()).hexdigest()
    if span_id is None:
        span_id = next(_span_ids)
    sid = format((int(span_id) & ((1 << 64) - 1)) or 1, "016x")
    return f"00-{tid}-{sid}-{'01' if sampled else '00'}"


def parse_traceparent(header) -> dict | None:
    """Inverse of :func:`format_traceparent`: ``{"trace_id", "parent_span_id",
    "sampled"}``, or None for anything malformed (a bad inbound context degrades to
    an untraced hop, never to an exception on the serving path)."""
    if not isinstance(header, str):
        return None
    parts = header.strip().lower().split("-")
    if len(parts) != 4:
        return None
    ver, tid, sid, flags = parts
    if ver != "00" or len(tid) != 32 or len(sid) != 16 or len(flags) != 2:
        return None
    if not (set(tid) <= _HEX and set(sid) <= _HEX and set(flags) <= _HEX):
        return None
    parent = int(sid, 16)
    if int(tid, 16) == 0 or parent == 0:
        return None
    return {"trace_id": tid, "parent_span_id": parent, "sampled": bool(int(flags, 16) & 1)}


def now_us() -> float:
    """Monotonic microseconds: the trace-event clock (Chrome ``ts`` unit)."""
    return time.perf_counter_ns() / 1e3


class _NullSpan:
    """The disabled-path singleton: a context manager that does nothing and allocates
    nothing; ``set()`` is a no-op too, so call sites never need a second check."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


_NULL = _NullSpan()


class _OpenSpan:
    """One live span on the opening thread's stack; closing it records a completed
    ``X`` event into that thread's ring."""

    __slots__ = ("_tracer", "_local", "name", "cat", "ts", "attrs", "span_id", "_range")

    def __init__(self, tracer, local, name, cat, attrs):
        self._tracer = tracer
        self._local = local
        self.name = name
        self.cat = cat
        self.attrs = attrs
        self.span_id = next(_span_ids)
        self.ts = 0.0
        self._range = None

    def set(self, **attrs):
        self.attrs.update(attrs)
        return self

    def __enter__(self):
        self._local.stack.append(self)
        if self._tracer._annotating:
            self._range = self._tracer._profiler_range(self.name)
            self._range.__enter__()
        self.ts = now_us()
        return self

    def __exit__(self, *exc):
        dur = now_us() - self.ts
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        stack = self._local.stack
        # LIFO by construction; tolerate a corrupted stack rather than poison the
        # traced code path.
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        self._tracer._emit(self._local, self.name, self.ts, dur, self.cat,
                           threading.get_ident(), self.attrs, self.span_id)
        return False


class _Local(threading.local):
    """Per-thread recording state: the open-span stack, the ring, and the active
    distributed-trace context (a parsed traceparent or None)."""

    def __init__(self):
        self.stack: list[_OpenSpan] = []
        self.events: deque | None = None
        self.ctx: dict | None = None


class Tracer:
    """Process-wide span recorder. ``enabled`` is the hot-path flag; all other state
    is touched only while tracing is on."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.enabled = False
        self.capacity = capacity
        self._local = _Local()
        self._lock = threading.Lock()
        # thread ident -> (thread name, events deque). guarded-by: _lock
        self._buffers: dict[int, tuple[str, deque]] = {}
        # Buffers of dead threads whose ident a new thread claimed (thread idents
        # are recycled under http.server's thread-per-request churn): kept, bounded,
        # evictions counted. guarded-by: _lock
        self._retired: deque = deque(maxlen=RETIRED_RING_BUDGET)
        # Completed prompts snapshotted by retain_prompt(), LRU-bounded.
        # guarded-by: _lock
        self._retained: OrderedDict[str, list] = OrderedDict()
        # Device-measured spans waiting for their events to be placed on the trace
        # clock (``defer``). guarded-by: _lock
        self._deferred: list[Callable] = []
        # Evictions per reason: the local mirror of pa_trace_dropped_total.
        self.dropped: dict[str, int] = {}  # guarded-by: _lock
        # >0 while a hardware_trace window is open: spans become profiler ranges.
        self._annotating = 0
        # Chrome trace files written by hardware_trace windows, oldest first.
        self.hardware_traces: list[str] = []
        # Names of tracks that are not threads (a device stream's spans).
        self._track_names: dict[int, str] = {}
        self._epoch_us = now_us()
        # Wall-clock anchor taken with the monotonic epoch: a cross-host stitcher
        # aligns each process's trace clock onto a shared timeline with it.
        self._epoch_wall_s = time.time()

    # -- lifecycle ----------------------------------------------------------

    def enable(self, capacity: int | None = None) -> None:
        """Turn tracing on (clearing any previous trace). ``capacity`` is per-call,
        not sticky: omitting it restores the default."""
        with self._lock:
            self.capacity = DEFAULT_CAPACITY if capacity is None else capacity
            self._buffers.clear()
            self._retired.clear()
            self._retained.clear()
            self._deferred.clear()
            self.dropped = {}
            self._epoch_us = now_us()
            self._epoch_wall_s = time.time()
        self._local = _Local()
        self.enabled = True

    def disable(self) -> None:
        """Stop recording; the captured trace stays exportable until the next
        ``enable()``."""
        self.enabled = False

    def clear(self) -> None:
        with self._lock:
            self._buffers.clear()
            self._retired.clear()
            self._retained.clear()
            self._deferred.clear()
            self.dropped = {}

    # -- recording ----------------------------------------------------------

    def _events(self, local) -> deque:
        ev = local.events
        if ev is None:
            ev = local.events = deque(maxlen=self.capacity)
            t = threading.current_thread()
            evicted = 0
            with self._lock:
                prev = self._buffers.get(threading.get_ident())
                if prev is not None and prev[1]:
                    # Recycled ident: retire the dead thread's spans instead of
                    # dropping them.
                    if len(self._retired) == self._retired.maxlen:
                        evicted = len(self._retired[0][1])
                        self.dropped["retired-ring"] = (
                            self.dropped.get("retired-ring", 0) + evicted)
                    self._retired.append(prev)
                self._buffers[threading.get_ident()] = (t.name, ev)
            if evicted:
                # Outside the tracer lock: the registry has its own.
                self._count_dropped("retired-ring", evicted)
        return ev

    @staticmethod
    def _count_dropped(reason: str, n: int) -> None:
        try:
            from .metrics import registry

            registry.counter(
                "pa_trace_dropped_total", float(n), labels={"reason": reason},
                help="spans evicted from tracer retention tiers (retired-thread ring, "
                     "completed-prompt retention, device spans awaiting export): "
                     "nonzero means the timeline view is incomplete")
        except Exception:  # noqa: BLE001 - bookkeeping never breaks a traced path
            pass

    def _emit(self, local, name, ts, dur, cat, tid, attrs, span_id) -> None:
        self._events(local).append((name, ts, dur, cat, tid, attrs, span_id))
        self._feed_metrics(name, cat, dur)

    @staticmethod
    def _feed_metrics(name, cat, dur_us) -> None:
        try:
            from .metrics import registry

            registry.histogram(
                "pa_trace_span_seconds", dur_us / 1e6, labels={"name": name, "cat": cat},
                help="span durations from utils/tracing.py (trace/metrics consistency: "
                     "same measurements, two views)")
        except Exception:  # noqa: BLE001
            pass

    def span(self, name: str, cat: str = "host", prompt_id: str | None = None, **attrs):
        """Open a nested span on the calling thread (context manager). With tracing
        off this is one flag check returning the shared null singleton."""
        if not self.enabled:
            return _NULL
        local = self._local
        if prompt_id is None:
            prompt_id = self._current_prompt_id(local)
        if prompt_id is not None:
            attrs["prompt_id"] = prompt_id
        if local.ctx is not None:
            attrs.setdefault("trace_id", local.ctx["trace_id"])
        return _OpenSpan(self, local, name, cat, attrs)

    def record(self, name: str, ts: float, dur: float, cat: str = "host",
               tid: int | None = None, prompt_id: str | None = None, **attrs) -> None:
        """Record an already-measured span (explicit interval). ``tid`` puts it on
        another thread's timeline (the dispatcher recording for a blocked
        submitter); the write still goes to the calling thread's buffer."""
        if not self.enabled:
            return
        local = self._local
        if prompt_id is None:
            prompt_id = self._current_prompt_id(local)
        if prompt_id is not None:
            attrs["prompt_id"] = prompt_id
        if local.ctx is not None:
            attrs.setdefault("trace_id", local.ctx["trace_id"])
        self._emit(local, name, ts, max(0.0, dur), cat,
                   tid if tid is not None else threading.get_ident(), attrs,
                   next(_span_ids))

    # -- device-measured spans ----------------------------------------------

    def defer(self, resolve: Callable[[Callable[..., float]], None]) -> None:
        """Queue ``resolve(at)`` for the next :meth:`resolve_deferred`: ``at(event,
        device)`` maps a CUDA event (``enable_timing=True``) recorded on ``device`` to
        the trace clock, and
        ``resolve`` calls :meth:`record` with the intervals it measured, its
        submitter's tid and prompt captured when it was queued. The queue is bounded;
        an entry that does not fit is dropped and counted."""
        if not self.enabled:
            return
        with self._lock:
            full = len(self._deferred) >= DEFERRED_BUDGET
            if full:
                self.dropped["device-pending"] = self.dropped.get("device-pending", 0) + 1
            else:
                self._deferred.append(resolve)
        if full:
            self._count_dropped("device-pending", 1)

    def resolve_deferred(self) -> int:
        """Place every queued device span on the trace clock. Synchronises each
        device once (export time, never a traced path) and takes an anchor event
        right after it, read against the host clock. Returns the entries resolved."""
        with self._lock:
            pending, self._deferred = self._deferred, []
        if not pending:
            return 0
        import torch

        anchors: dict = {}

        def at(event, dev=None) -> float:
            if dev not in anchors:
                torch.cuda.synchronize(dev)
                anchor = torch.cuda.Event(enable_timing=True)
                anchor.record(torch.cuda.current_stream(dev))
                anchor.synchronize()
                anchors[dev] = (anchor, now_us())
            anchor, us = anchors[dev]
            return us - event.elapsed_time(anchor) * 1e3

        for resolve in pending:
            try:
                resolve(at)
            except Exception:  # noqa: BLE001 - a broken entry never breaks export
                pass
        return len(pending)

    def name_track(self, tid: int, name: str) -> None:
        """Name a track that is not a thread (spans recorded with ``tid=``)."""
        self._track_names[tid] = name

    # -- profiler ranges ----------------------------------------------------

    @staticmethod
    def _profiler_range(name: str):
        import torch

        return torch.profiler.record_function(name)

    def annotate(self, name: str):
        """A ``torch.profiler`` range named ``name`` while a :func:`hardware_trace`
        window is open, else the null singleton."""
        if not self._annotating:
            return _NULL
        return self._profiler_range(name)

    # -- context ------------------------------------------------------------

    def _current_prompt_id(self, local=None) -> Optional[str]:
        local = local if local is not None else self._local
        for s in reversed(local.stack):
            pid = s.attrs.get("prompt_id")
            if pid is not None:
                return pid
        # No span context on this thread: the per-thread progress scope (the
        # per-prompt correlation the server installs).
        try:
            from .progress import current_scope

            return getattr(current_scope(), "prompt_id", None)
        except Exception:  # noqa: BLE001
            return None

    def current_prompt_id(self) -> Optional[str]:
        """The prompt the calling thread works for right now, or None."""
        return self._current_prompt_id()

    def current_span_id(self) -> Optional[int]:
        stack = self._local.stack
        return stack[-1].span_id if stack else None

    def current_trace_id(self) -> Optional[str]:
        """The distributed trace id active on the calling thread (from
        :meth:`trace_context`, or inherited off the span stack), or None."""
        ctx = self._local.ctx
        if ctx is not None:
            return ctx["trace_id"]
        for s in reversed(self._local.stack):
            tid = s.attrs.get("trace_id")
            if tid:
                return tid
        return None

    @contextlib.contextmanager
    def trace_context(self, traceparent):
        """Activate a distributed-trace context (a traceparent string or a parsed
        dict) on the calling thread: every span and record inside carries its
        ``trace_id``. Malformed or absent context degrades to a local scope."""
        ctx = (parse_traceparent(traceparent)
               if not isinstance(traceparent, dict) else traceparent)
        if not self.enabled or not ctx:
            yield None
            return
        local = self._local
        prev = local.ctx
        local.ctx = ctx
        try:
            yield ctx
        finally:
            local.ctx = prev

    # -- completed-prompt retention -----------------------------------------

    def retain_prompt(self, prompt_id: str | None) -> int:
        """Snapshot every event stamped with ``prompt_id`` into the bounded
        completed-prompt retention, so the prompt's timeline survives its recording
        threads' rings wrapping. LRU-bounded at :data:`PROMPT_RETENTION` prompts,
        evictions counted (reason ``"prompt-retention"``). Returns the rows kept."""
        if not self.enabled or not prompt_id:
            return 0
        evicted = 0
        with self._lock:
            rows = []
            for _tid, (_name, ev) in self._buffers.items():
                rows.extend(r for r in ev if r[5].get("prompt_id") == prompt_id)
            for _name, ev in self._retired:
                rows.extend(r for r in ev if r[5].get("prompt_id") == prompt_id)
            if not rows:
                return 0
            self._retained[prompt_id] = rows
            self._retained.move_to_end(prompt_id)
            while len(self._retained) > PROMPT_RETENTION:
                _pid, old = self._retained.popitem(last=False)
                evicted += len(old)
            if evicted:
                self.dropped["prompt-retention"] = (
                    self.dropped.get("prompt-retention", 0) + evicted)
        if evicted:
            self._count_dropped("prompt-retention", evicted)
        return len(rows)

    # -- export -------------------------------------------------------------

    def export(self, prompt_id: str | None = None) -> dict:
        """Chrome/Perfetto trace-event JSON: complete ``X`` events with ``ts``/``dur``
        in microseconds plus thread-name metadata. ``prompt_id`` filters to one
        prompt's timeline. Device spans queued by :meth:`defer` are placed first."""
        self.resolve_deferred()
        pid = os.getpid()
        with self._lock:
            snap = [(tid, name, list(ev)) for tid, (name, ev) in self._buffers.items()]
            snap.extend((0, name, list(ev)) for name, ev in self._retired)
            # Retained rows may repeat live rows: deduplicated by span id below.
            if prompt_id is not None:
                retained = list(self._retained.get(prompt_id, ()))
            else:
                retained = [r for rows in self._retained.values() for r in rows]
            epoch_wall = self._epoch_wall_s
        snap.append((0, "retained", retained))
        events: list[dict] = []
        tids_seen: set[int] = set()
        span_ids_seen: set[int] = set()
        for _rec_tid, _tname, recs in snap:
            for name, ts, dur, cat, tid, attrs, span_id in recs:
                if prompt_id is not None and attrs.get("prompt_id") != prompt_id:
                    continue
                if span_id in span_ids_seen:
                    continue
                span_ids_seen.add(span_id)
                args = dict(attrs)
                args["span_id"] = span_id
                events.append({
                    "ph": "X", "name": name, "cat": cat,
                    "ts": round(ts - self._epoch_us, 3), "dur": round(dur, 3),
                    "pid": pid, "tid": tid, "args": args,
                })
                tids_seen.add(tid)
        events.sort(key=lambda e: (e["tid"], e["ts"], -e["dur"]))
        thread_names = {tid: tname for tid, tname, _ in snap}
        meta = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                 "args": {"name": thread_names.get(tid) or self._track_names.get(
                     tid, f"thread-{tid}")}}
                for tid in sorted(tids_seen)]
        meta.insert(0, {"ph": "M", "name": "process_name", "pid": pid,
                        "args": {"name": "parallel_anything_tpu"}})
        return {"traceEvents": meta + events, "displayTimeUnit": "ms",
                "epoch_wall_s": epoch_wall}


# The process-wide tracer every instrumentation site records into and the server's
# GET /trace renders. Tests may enable()/disable() it.
tracer = Tracer()


def on() -> bool:
    """The hot-path enabled check: guard attribute computation with this."""
    return tracer.enabled


def enable(capacity: int | None = None) -> None:
    tracer.enable(capacity)


def disable() -> None:
    tracer.disable()


def span(name: str, cat: str = "host", prompt_id: str | None = None, **attrs):
    return tracer.span(name, cat=cat, prompt_id=prompt_id, **attrs)


def record(name: str, ts: float, dur: float, cat: str = "host",
           tid: int | None = None, prompt_id: str | None = None, **attrs):
    tracer.record(name, ts, dur, cat=cat, tid=tid, prompt_id=prompt_id, **attrs)


def defer(resolve) -> None:
    tracer.defer(resolve)


def annotate(name: str):
    return tracer.annotate(name)


def export(prompt_id: str | None = None) -> dict:
    return tracer.export(prompt_id)


def current_prompt_id() -> Optional[str]:
    return tracer.current_prompt_id()


def current_span_id() -> Optional[int]:
    return tracer.current_span_id()


def trace_context(traceparent):
    return tracer.trace_context(traceparent)


def current_trace_id() -> Optional[str]:
    return tracer.current_trace_id()


def retain_prompt(prompt_id: str | None) -> int:
    return tracer.retain_prompt(prompt_id)


def epoch_wall_s() -> float:
    """Wall-clock instant of the tracer's ts == 0 origin (stitcher anchor)."""
    return tracer._epoch_wall_s


@contextlib.contextmanager
def hardware_trace(log_dir: str | None = None):
    """Bracket a span subtree with a ``torch.profiler`` window (``utils.metrics.
    trace``: CPU activity, and CUDA where a card is present) that writes a Chrome
    trace into ``log_dir`` (default ``parallelanything-trace`` under the temp
    directory); the file's path is appended to ``tracer.hardware_traces``. Inside
    the window spans and :func:`annotate` ranges are profiler ranges too, so the
    device timeline lines up with the ``GET /trace`` export; the ``hardware-trace``
    host span marks the window."""
    from .metrics import trace

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "parallelanything-trace")
    with span("hardware-trace", cat="profiler", log_dir=log_dir):
        with trace(log_dir) as window:
            tracer._annotating += 1
            try:
                yield log_dir
            finally:
                tracer._annotating -= 1
        tracer.hardware_traces.append(window.path)


# -- trace-derived aggregates ------------------------------------------------


def _percentile(samples: list[float], q: float) -> float:
    """Nearest-rank percentile."""
    if not samples:
        return 0.0
    s = sorted(samples)
    k = max(0, min(len(s) - 1, round(q / 100.0 * (len(s) - 1))))
    return s[k]


def _x_events(events) -> list[dict]:
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    return [e for e in events if e.get("ph") == "X"]


def stream_overlap_efficiency(events) -> float | None:
    """Fraction of each ``stream-run`` span's time occupied by
    ``stream-stage-compute`` spans, averaged over runs; in (0, 1] by construction.
    Exposed transfer and backpressure push it below 1. None without streamed runs."""
    xs = _x_events(events)
    runs = [e for e in xs if e["name"] == "stream-run" and e.get("dur", 0) > 0]
    if not runs:
        return None
    comps = [e for e in xs if e["name"] == "stream-stage-compute"]
    effs = []
    for r in runs:
        r0, r1 = r["ts"], r["ts"] + r["dur"]
        busy = sum(c["dur"] for c in comps
                   if c["tid"] == r["tid"] and c["ts"] >= r0
                   and c["ts"] + c["dur"] <= r1 + 1.0)  # float-rounding slack (µs)
        effs.append(min(1.0, busy / r["dur"]))
    return sum(effs) / len(effs)


def lane_wait_p95_s(events) -> float | None:
    """p95 of serving ``lane-wait`` spans (submit → seated), seconds."""
    waits = [e["dur"] / 1e6 for e in _x_events(events) if e["name"] == "lane-wait"]
    return _percentile(waits, 95) if waits else None


def host_gap_ms(events) -> float | None:
    """Mean host-side gap between consecutive ``step`` spans on each thread: the
    per-step scheduling overhead the device cannot see. None with fewer than two
    steps anywhere."""
    steps: dict[int, list[dict]] = {}
    for e in _x_events(events):
        if e["name"] == "step":
            steps.setdefault(e["tid"], []).append(e)
    gaps = []
    for evs in steps.values():
        evs.sort(key=lambda e: e["ts"])
        for a, b in zip(evs, evs[1:]):
            gaps.append(max(0.0, b["ts"] - (a["ts"] + a["dur"])) / 1e3)
    return sum(gaps) / len(gaps) if gaps else None


def fleet_hop_p95_ms(events) -> float | None:
    """p95 of a fleet router's ``fleet-hop`` spans, milliseconds; None when no fleet
    routing ran inside the traced window (the port has no router yet, so a port
    trace holds none)."""
    hops = [e["dur"] / 1e3 for e in _x_events(events) if e["name"] == "fleet-hop"]
    return round(_percentile(hops, 95), 4) if hops else None


def trace_aggregates(events) -> dict:
    """The trace-derived aggregate fields of one trace."""
    eff = stream_overlap_efficiency(events)
    p95 = lane_wait_p95_s(events)
    gap = host_gap_ms(events)
    return {
        "stream_overlap_efficiency": None if eff is None else round(eff, 4),
        "lane_wait_p95": None if p95 is None else round(p95, 6),
        "host_gap_ms": None if gap is None else round(gap, 4),
    }
