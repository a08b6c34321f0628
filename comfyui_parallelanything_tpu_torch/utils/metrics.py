"""Process-wide labeled metrics with a Prometheus text renderer (counterpart of
the registry half of ``comfyui_parallelanything_tpu/utils/metrics.py``).

``registry`` is what the serving layer (``serving/``), the server
(``server.py``, which renders it on ``GET /metrics``), the degradation rungs
(``utils/degrade.py``) and the device-memory gauges (``devices/memory.py``) write
to. Families: ``pa_serving_*`` (buckets: occupancy, queue depth, lane wait, step
seconds, dispatches, lane-steps, the batched fraction, completions, cancels,
rejections, the inline fallback), ``pa_decode_*`` (the batched decode tail),
``pa_server_*`` (prompt queue), ``pa_hbm_*`` (device memory) and
``pa_degradation_total{rung=}``, ``pa_trace_*`` (``utils/tracing.py``: span
durations, evicted spans), ``pa_slo_*`` (``utils/slo.py``: burn rate, budget,
objective verdicts, request and stage histograms) and
``pa_stream_overlap_efficiency`` (``parallel/streaming.py``).

The other half is the JAX module's step clocks and profiler window: ``StepTimer``
and ``StepStats`` (per-step wall time that waits for the device before the clock
stops: ``torch.cuda.synchronize`` where JAX blocks on the output),
``force_ready``, ``chained_time`` and ``trace``, a ``torch.profiler`` window that
writes a Chrome trace where JAX writes an XProf one.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os
import tempfile
import threading
import time
from typing import Any


class MetricsRegistry:
    """Thread-safe labeled metrics with Prometheus text exposition.

    Three instrument kinds, created on first touch (no registration step: an
    instrumentation site never fails a serving path over bookkeeping): ``counter``
    (monotonic), ``gauge`` (the latest value) and ``histogram`` (log-spaced buckets
    by default, exposed as Prometheus ``_bucket``/``_sum``/``_count``). Labels are a
    plain dict, canonicalised to a sorted tuple key. A histogram may declare its
    bucket bounds at first touch (``histogram(..., bounds=...)``); the first touch
    wins, so every label set of one metric shares one ladder."""

    # Log-spaced duration buckets, 1 ms … 100 s (~2.5x steps): lane waits under
    # load and millisecond step dispatches alike.
    HIST_BOUNDS = (
        0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
        1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
    )

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # name -> {"type": kind, "help": str, "values": {label_key: float | [buckets..]}}
        self._metrics: dict[str, dict] = {}  # guarded-by: _lock

    @staticmethod
    def _label_key(labels: dict | None) -> tuple:
        return tuple(sorted((str(k), str(v)) for k, v in (labels or {}).items()))

    def _slot(self, name: str, kind: str, help_: str) -> dict:  # caller holds _lock
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = {"type": kind, "help": help_, "values": {}}
        return m

    def counter(self, name: str, inc: float = 1.0, labels: dict | None = None,
                help: str = "") -> None:
        with self._lock:
            vals = self._slot(name, "counter", help)["values"]
            k = self._label_key(labels)
            vals[k] = vals.get(k, 0.0) + inc

    def gauge(self, name: str, value: float, labels: dict | None = None,
              help: str = "") -> None:
        with self._lock:
            self._slot(name, "gauge", help)["values"][self._label_key(labels)] = (
                float(value)
            )

    def histogram(self, name: str, value: float, labels: dict | None = None,
                  help: str = "", bounds=None) -> None:
        """Observe ``value`` (seconds) into the metric's buckets. ``bounds``
        (an ascending tuple of upper edges) fixes the ladder at the metric's
        FIRST touch — omitted, the log-spaced default applies; on later
        touches it is ignored (first wins: one ladder per metric, so every
        label set and every host's exposition stays mergeable)."""
        v = float(value)
        with self._lock:
            m = self._slot(name, "histogram", help)
            hb = m.get("bounds")
            if hb is None:
                hb = m["bounds"] = (
                    tuple(float(b) for b in bounds)
                    if bounds else self.HIST_BOUNDS
                )
            vals = m["values"]
            k = self._label_key(labels)
            acc = vals.get(k)
            if acc is None:
                # [per-bound counts..., +Inf count, sum, count]
                acc = vals[k] = [0.0] * (len(hb) + 1) + [0.0, 0.0]
            for i, bound in enumerate(hb):
                if v <= bound:
                    acc[i] += 1.0
                    break
            else:
                acc[len(hb)] += 1.0
            acc[-2] += v
            acc[-1] += 1.0

    def get(self, name: str, labels: dict | None = None):
        """Current value (float for a counter or gauge, (sum, count) for a
        histogram), or None."""
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                return None
            v = m["values"].get(self._label_key(labels))
            return (v[-2], v[-1]) if isinstance(v, list) else v

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()

    def render(self) -> str:
        """Prometheus text format 0.0.4 (the GET /metrics body)."""

        def esc(v: str) -> str:
            return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")

        lines: list[str] = []
        with self._lock:
            for name in sorted(self._metrics):
                m = self._metrics[name]
                if m["help"]:
                    lines.append(f"# HELP {name} {m['help']}")
                lines.append(f"# TYPE {name} {m['type']}")
                for key, v in sorted(m["values"].items()):
                    lbl = (
                        "{" + ",".join(f'{k}="{esc(val)}"' for k, val in key) + "}"
                        if key else ""
                    )
                    if m["type"] == "histogram":
                        def le_lbl(le: str) -> str:
                            pairs = list(key) + [("le", le)]
                            return "{" + ",".join(
                                f'{k}="{esc(val)}"' for k, val in pairs
                            ) + "}"

                        hb = m.get("bounds") or self.HIST_BOUNDS
                        cum = 0.0
                        for i, bound in enumerate(hb):
                            cum += v[i]
                            lines.append(
                                f"{name}_bucket{le_lbl(f'{bound:.9g}')} "
                                f"{cum:.9g}"
                            )
                        cum += v[len(hb)]
                        lines.append(f"{name}_bucket{le_lbl('+Inf')} {cum:.9g}")
                        lines.append(f"{name}_sum{lbl} {v[-2]:.9g}")
                        lines.append(f"{name}_count{lbl} {v[-1]:.9g}")
                    else:
                        lines.append(f"{name}{lbl} {v:.9g}")
        return "\n".join(lines) + "\n"


# The process-wide registry every instrumentation site writes to (serving/,
# server.py) and GET /metrics renders. Tests may reset() it.
registry = MetricsRegistry()



@dataclasses.dataclass
class StepStats:
    steps: int = 0
    total_s: float = 0.0
    last_s: float = 0.0
    images: int = 0

    @property
    def sec_per_it(self) -> float:
        return self.total_s / self.steps if self.steps else 0.0

    @property
    def images_per_sec(self) -> float:
        return self.images / self.total_s if self.total_s > 0 else 0.0


def _wait_for(value) -> None:
    """Wait until the device work producing ``value`` (a tensor, or a tree of them)
    is done: one ``torch.cuda.synchronize`` per CUDA device it lies on."""
    import torch

    devices = set()

    def walk(v):
        if isinstance(v, torch.Tensor):
            if v.device.type == "cuda":
                devices.add(v.device)
        elif isinstance(v, dict):
            for x in v.values():
                walk(x)
        elif isinstance(v, (list, tuple)):
            for x in v:
                walk(x)

    walk(value)
    for d in devices:
        torch.cuda.synchronize(d)


class StepTimer:
    """Times sampler steps honestly: waits for the step's output on the device
    before the clock stops. Warm-up steps (default 1: the first step pays for
    kernel builds and library set-up) are kept apart from the throughput stats."""

    def __init__(self, warmup_steps: int = 1):
        self.warmup_steps = warmup_steps
        self.warmup = StepStats()
        self.stats = StepStats()

    @contextlib.contextmanager
    def step(self, batch_size: int = 1):
        t0 = time.perf_counter()
        out_box: list[Any] = []
        yield out_box
        if out_box:
            _wait_for(out_box[0])
        dt = time.perf_counter() - t0
        target = self.warmup if self.warmup.steps < self.warmup_steps else self.stats
        target.steps += 1
        target.total_s += dt
        target.last_s = dt
        target.images += batch_size

    def time_step(self, fn, *args, batch_size: int = 1, **kwargs):
        """Run ``fn`` as one timed step and return its result."""
        with self.step(batch_size=batch_size) as box:
            out = fn(*args, **kwargs)
            box.append(out)
        return out

    def log_summary(self, label: str = "sampler") -> None:
        from .logging import get_logger

        s = self.stats
        get_logger().info("%s: %d steps, %.4f s/it, %.2f images/s (warmup %d steps, %.2fs)",
                          label, s.steps, s.sec_per_it, s.images_per_sec,
                          self.warmup.steps, self.warmup.total_s)


def force_ready(v) -> float:
    """Force ``v``'s whole dependency chain to finish by reading a reduced scalar
    back to the host: possessing the value proves the computation ran."""
    return float(v.float().sum().item())


def chained_time(step, x0, iters: int, warmup: int = 2):
    """Mean seconds per ``step`` call over a serial dependency chain.

    ``step`` maps a tensor to a like-shaped tensor. Each iteration feeds its output
    back as the next input, so no call can be skipped or overlapped, and the timed
    region closes with a ``force_ready`` readback. ``warmup`` calls (at least 2) run
    first. Returns ``(sec_per_iter, last_output)``."""
    out = step(x0)
    for _ in range(max(2, warmup) - 1):
        out = step(out)
    force_ready(out)
    run = out
    t0 = time.perf_counter()
    for _ in range(iters):
        run = step(run)
    force_ready(run)
    return (time.perf_counter() - t0) / iters, run


@dataclasses.dataclass
class ProfileWindow:
    """What ``trace`` yields: the directory, the ``torch.profiler.profile`` object
    and, once the window closes, the Chrome trace file it wrote."""

    log_dir: str
    profile: Any = None
    path: str | None = None


_trace_files = itertools.count()


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Profile a region with ``torch.profiler`` (CPU activity, and CUDA where a card
    is present) and write its Chrome trace (Perfetto opens it) into ``log_dir``
    (default ``parallelanything-trace`` under the temp directory). Yields a
    ``ProfileWindow``; the JAX package's ``trace`` yields the directory of an XProf
    trace instead."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "parallelanything-trace")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    window = ProfileWindow(log_dir)
    with profile(activities=activities) as prof:
        window.profile = prof
        yield window
    os.makedirs(log_dir, exist_ok=True)
    window.path = os.path.join(log_dir, f"trace-{os.getpid()}-{next(_trace_files)}.json")
    prof.export_chrome_trace(window.path)
    from .logging import get_logger

    get_logger().info("profiler trace written to %s", window.path)
