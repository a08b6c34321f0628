"""Process-wide labeled metrics with a Prometheus text renderer (counterpart of
the registry half of ``comfyui_parallelanything_tpu/utils/metrics.py``).

``registry`` is what the serving layer (``serving/``), the server
(``server.py``, which renders it on ``GET /metrics``), the degradation rungs
(``utils/degrade.py``) and the device-memory gauges (``devices/memory.py``) write
to. Families: ``pa_serving_*`` (buckets: occupancy, queue depth, lane wait, step
seconds, dispatches, lane-steps, the batched fraction, completions, cancels,
rejections, the inline fallback), ``pa_decode_*`` (the batched decode tail),
``pa_server_*`` (prompt queue), ``pa_hbm_*`` (device memory) and
``pa_degradation_total{rung=}``.

Left out: the JAX module's ``StepTimer``/``chained_time`` step clocks and its
``jax.profiler`` trace context; ``chip_smoke.py`` times with CUDA events and
profiles with ``torch.profiler``.
"""

from __future__ import annotations

import threading


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


# The process-wide registry every instrumentation site writes to and
# GET /metrics renders. Tests may reset() it.
registry = MetricsRegistry()
