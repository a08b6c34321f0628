"""SLO plane: declared latency objectives, window accounting, burn rates
(counterpart of ``comfyui_parallelanything_tpu/utils/slo.py``, the same objectives,
stages, metric names and exposition readers).

- **objective registry** (:class:`Objective` / :class:`SloRegistry`): declared
  latency objectives, "``target`` fraction of requests complete under
  ``threshold_s``, judged over ``window_s``", from ``PA_SLO_OBJECTIVES`` (a JSON
  list) or :data:`DEFAULT_OBJECTIVES`. The error budget of an objective is
  ``1 - target``; the **burn rate** is the bad fraction in the window over that
  budget (1.0: consuming budget exactly as fast as allowed).
- **stage decomposition**: a request's latency splits into ``admission`` (HTTP
  ingress to worker pickup, ``server.py``), ``encode`` (text-encode node wall),
  ``lane_wait`` (serving submit to seated, ``serving/bucket.py``), ``eval``
  (sampler-node wall, ``host.py``), ``decode_wait`` (the batched decode queue's
  wait, ``serving/decode.py``), ``decode`` (decode-node wall) and, client-side only,
  ``collect``. Stages ride the same measurement points as the spans of
  ``utils/tracing.py``: one clock, two views.
- **``pa_slo_*`` metrics**: ``pa_slo_request_seconds`` (server-side request
  residency, bucket edges at the declared thresholds), ``pa_slo_stage_seconds
  {stage=}``, and the scrape-time gauges ``pa_slo_burn_rate{objective=}``,
  ``pa_slo_budget_remaining{objective=}`` and ``pa_slo_objective_ok{objective=}``.
- **exposition readers** (:func:`histogram_quantile`, :func:`fraction_under`,
  :func:`verdicts_from_text`): stdlib parsers over Prometheus text.

``PA_SLO=0`` disables observation and gauge publication (one env read per call
site). The module level is stdlib-only; ``utils/metrics.py`` loads lazily and every
metrics write is best-effort.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import threading
import time
from collections import deque

SLO_SCHEMA = "pa-slo/v1"

# The stages of a request's end-to-end latency. "encode" is the text-encode node
# wall (what an embed-cache hit collapses); "decode_wait" is the batched-decode
# queue wait, a sub-stage of the decode node wall; "collect" is the client-side
# residual only: servers never observe it.
STAGES = ("admission", "encode", "lane_wait", "eval", "decode_wait",
          "decode", "collect")

# Stage histograms keep sub-millisecond resolution at the bottom (a healthy
# admission wait on an idle host is ~0) and minutes at the top (a saturated
# open-loop queue) — the metrics.py default ladder, restated here so the
# standalone loaders agree with the in-process registry.
STAGE_BOUNDS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
)


def enabled() -> bool:
    """The PA_SLO flag (default on; observation is one histogram write and
    one bounded-deque append per request — the tracer's cheap-path rule)."""
    return os.environ.get("PA_SLO", "") not in ("0", "false")


@dataclasses.dataclass(frozen=True)
class Objective:
    """One declared latency objective: ``target`` fraction of requests must
    complete under ``threshold_s``, judged over a sliding ``window_s``."""

    name: str
    threshold_s: float
    target: float = 0.95
    window_s: float = 3600.0

    @property
    def budget(self) -> float:
        """The error budget: the bad fraction the objective tolerates."""
        return max(1e-9, 1.0 - float(self.target))


# The default objective set: conservative enough that an unconfigured CPU
# smoke run doesn't page anyone, tight enough that a saturated open-loop
# queue (p95 blowing past half a minute) reads as burning.
DEFAULT_OBJECTIVES: tuple[Objective, ...] = (
    Objective(name="request_under_30s", threshold_s=30.0, target=0.95),
)


def parse_objectives(raw) -> list[Objective]:
    """Objectives from the ``PA_SLO_OBJECTIVES`` JSON value (a list of
    ``{"name", "threshold_s", "target", "window_s"}`` objects). Malformed
    input raises ValueError at parse — a typo'd objective must fail loudly,
    never silently observe nothing."""
    if isinstance(raw, str):
        try:
            raw = json.loads(raw)
        except json.JSONDecodeError as e:
            raise ValueError(f"PA_SLO_OBJECTIVES is not JSON: {e}") from e
    if not isinstance(raw, list):
        raise ValueError(
            f"PA_SLO_OBJECTIVES must be a JSON list, got {type(raw).__name__}"
        )
    out: list[Objective] = []
    for i, e in enumerate(raw):
        if not isinstance(e, dict) or "name" not in e or "threshold_s" not in e:
            raise ValueError(
                f"objective {i} must be an object with 'name' and "
                f"'threshold_s': {e!r}"
            )
        out.append(Objective(
            name=str(e["name"]),
            threshold_s=float(e["threshold_s"]),
            target=float(e.get("target", 0.95)),
            window_s=float(e.get("window_s", 3600.0)),
        ))
    return out


def objectives_from_env(env=os.environ) -> list[Objective]:
    raw = env.get("PA_SLO_OBJECTIVES")
    if not raw:
        return list(DEFAULT_OBJECTIVES)
    return parse_objectives(raw)


def request_bounds(objectives) -> tuple[float, ...]:
    """The ``pa_slo_request_seconds`` bucket ladder: the default log-spaced
    bounds with every declared threshold inserted as an exact bucket edge —
    so ``fraction_under(threshold)`` is a bucket read, not an interpolation."""
    bounds = set(STAGE_BOUNDS)
    for o in objectives:
        bounds.add(float(o.threshold_s))
    return tuple(sorted(bounds))


class SloRegistry:
    """Objective accounting + the ``pa_slo_*`` emission points. Thread-safe:
    server workers observe concurrently; /metrics scrapes publish gauges.

    Window accounting is a bounded per-objective deque of
    ``(monotonic_ts, ok)`` events — O(1) per observation, trimmed lazily at
    read time; the bound (:data:`MAX_EVENTS`) caps memory on a busy host at
    the cost of the window shrinking to the last N requests (noted in the
    verdict as ``window_clipped``)."""

    MAX_EVENTS = 65536

    def __init__(self, objectives: list[Objective] | None = None):
        self._lock = threading.Lock()
        # guarded-by: _lock (both: replaced/extended wholesale under it)
        self._objectives = list(
            objectives if objectives is not None else objectives_from_env()
        )
        self._events: dict[str, deque] = {  # guarded-by: _lock
            o.name: deque(maxlen=self.MAX_EVENTS) for o in self._objectives
        }
        # The threshold-aligned ladder, computed once per objective set —
        # the histogram only reads bounds at its first touch anyway, and
        # the hot path must not rebuild/sort it per request under the lock.
        self._bounds = request_bounds(self._objectives)

    # -- declaration ---------------------------------------------------------

    def objectives(self) -> list[Objective]:
        with self._lock:
            return list(self._objectives)

    def declare(self, objective: Objective) -> None:
        """Add/replace one objective (tests, programmatic config)."""
        with self._lock:
            self._objectives = [
                o for o in self._objectives if o.name != objective.name
            ] + [objective]
            self._events.setdefault(
                objective.name, deque(maxlen=self.MAX_EVENTS)
            )
            self._bounds = request_bounds(self._objectives)

    def reset(self, objectives: list[Objective] | None = None) -> None:
        with self._lock:
            self._objectives = list(
                objectives if objectives is not None else objectives_from_env()
            )
            self._events = {
                o.name: deque(maxlen=self.MAX_EVENTS)
                for o in self._objectives
            }
            self._bounds = request_bounds(self._objectives)

    # -- observation ---------------------------------------------------------

    def observe_request(self, seconds: float) -> None:
        """One request's server-side end-to-end residency (admission wait +
        execution): feeds the threshold-aligned histogram and every
        objective's window."""
        s = float(seconds)
        now = time.monotonic()
        with self._lock:
            bounds = self._bounds
            for o in self._objectives:
                self._events[o.name].append((now, s <= o.threshold_s))
        _histogram("pa_slo_request_seconds", s, bounds=bounds,
                   help="server-side request residency (admission + exec) — "
                        "bucket edges aligned to declared SLO thresholds")

    def observe_stage(self, stage: str, seconds: float) -> None:
        """One stage sample of a request's latency decomposition."""
        _histogram("pa_slo_stage_seconds", float(seconds),
                   labels={"stage": str(stage)}, bounds=STAGE_BOUNDS,
                   help="per-stage latency decomposition (admission/encode/"
                        "lane_wait/eval/decode_wait/decode)")

    # -- window math ---------------------------------------------------------

    def _window(self, o: Objective, now: float) -> tuple[int, int, bool]:
        """(n, bad, clipped) over the objective's window. Caller holds the
        lock; expired events are trimmed from the left."""
        ev = self._events.get(o.name)
        if ev is None:
            return 0, 0, False
        clipped = len(ev) == ev.maxlen
        cutoff = now - o.window_s
        while ev and ev[0][0] < cutoff:
            ev.popleft()
        n = len(ev)
        bad = sum(1 for _, ok in ev if not ok)
        return n, bad, clipped

    def verdicts(self) -> list[dict]:
        """One verdict per objective: the window's bad fraction, burn rate
        (bad fraction / error budget), remaining budget fraction, and the
        ok bit (burn rate ≤ 1 — within budget). An empty window is vacuously
        ok with burn rate 0 (no traffic burns no budget)."""
        now = time.monotonic()
        out: list[dict] = []
        with self._lock:
            for o in self._objectives:
                n, bad, clipped = self._window(o, now)
                bad_fraction = bad / n if n else 0.0
                # Rounded before the ok comparison: 1 - 0.9 is 0.0999…8 in
                # floats, and "burning exactly at the allowed rate" must
                # read as ok, not as a 1e-16 violation.
                burn = round(bad_fraction / o.budget, 9)
                out.append({
                    "name": o.name,
                    "threshold_s": o.threshold_s,
                    "target": o.target,
                    "window_s": o.window_s,
                    "requests": n,
                    "bad": bad,
                    "bad_fraction": round(bad_fraction, 6),
                    "burn_rate": round(burn, 4),
                    "budget_remaining": round(max(0.0, 1.0 - burn), 4),
                    "ok": burn <= 1.0,
                    "window_clipped": clipped,
                })
        return out

    def burn_rate(self, name: str) -> float | None:
        for v in self.verdicts():
            if v["name"] == name:
                return v["burn_rate"]
        return None

    # -- surfaces ------------------------------------------------------------

    def publish_gauges(self) -> None:
        """Scrape-time gauges (the server's ``GET /metrics``): burn rate,
        remaining budget, and the ok bit per objective. No-op when PA_SLO=0
        or metrics is absent (standalone load)."""
        if not enabled():
            return
        for v in self.verdicts():
            labels = {"objective": v["name"]}
            _gauge("pa_slo_burn_rate", v["burn_rate"], labels,
                   help="window bad-fraction / error budget (1.0 = burning "
                        "exactly at the allowed rate)")
            _gauge("pa_slo_budget_remaining", v["budget_remaining"], labels,
                   help="fraction of the error budget left in the window")
            _gauge("pa_slo_objective_ok", 1.0 if v["ok"] else 0.0, labels,
                   help="1 = the objective is within budget over its window")

    def snapshot(self) -> dict:
        return {"schema": SLO_SCHEMA, "enabled": enabled(),
                "objectives": self.verdicts()}


# The process-wide registry every instrumentation site writes to. Tests may
# reset() it (objectives re-read from the env).
registry = SloRegistry()


def observe_request(seconds: float) -> None:
    """Module-level hook (server.py worker): disabled path is one env read."""
    if not enabled():
        return
    registry.observe_request(seconds)


def observe_stage(stage: str, seconds: float) -> None:
    """Module-level hook (server/bucket/host stage sites)."""
    if not enabled():
        return
    registry.observe_stage(stage, seconds)


# ---------------------------------------------------------------------------
# best-effort metrics emission (lazy — this module must load standalone)
# ---------------------------------------------------------------------------


def _histogram(name, value, labels=None, bounds=None, help="") -> None:
    try:
        from .metrics import registry as _metrics
    except Exception:
        return
    try:
        _metrics.histogram(name, value, labels=labels, bounds=bounds,
                           help=help)
    except Exception:
        pass


def _gauge(name, value, labels=None, help="") -> None:
    try:
        from .metrics import registry as _metrics
    except Exception:
        return
    try:
        _metrics.gauge(name, value, labels=labels, help=help)
    except Exception:
        pass


# ---------------------------------------------------------------------------
# Prometheus-text readers (the scraped twins of the in-process reads)
# ---------------------------------------------------------------------------


def _series_bucket_counts(text: str, name: str,
                          labels: dict | None = None) -> list[dict[str, float]]:
    """Per-SERIES cumulative ``_bucket`` counts by ``le``, one dict per
    distinct non-``le`` label set matching ``labels`` (each k="v" pair must
    appear in the line's label block). Kept per series so readers can
    handle mixed bucket ladders (two hosts with different declared
    objectives) correctly — summing cumulative counts across different
    ladders produces non-monotone garbage at edges only one host has."""
    need = [f'{k}="{v}"' for k, v in (labels or {}).items()]
    series: dict[str, dict[str, float]] = {}
    for m in re.finditer(
        rf'^{re.escape(name)}_bucket\{{([^}}]*)\}} ([0-9.eE+-]+)$',
        text, re.M,
    ):
        lbl = m.group(1)
        if any(pair not in lbl for pair in need):
            continue
        le = re.search(r'le="([^"]+)"', lbl)
        if le is None:
            continue
        key = re.sub(r'(^|,)le="[^"]*"', "", lbl)
        by_le = series.setdefault(key, {})
        by_le[le.group(1)] = by_le.get(le.group(1), 0.0) + float(m.group(2))
    return list(series.values())


def _bucket_counts(text: str, name: str,
                   labels: dict | None = None) -> dict[str, float]:
    """Cumulative ``_bucket`` counts by ``le``, merged across every label set
    matching ``labels``. Sound when the matching series share one bucket
    ladder (cumulative counts add per ``le``) — which every
    MetricsRegistry histogram of one metric name guarantees within a
    process, and fleets sharing one objective config guarantee across
    hosts; mixed-ladder readers must use :func:`_series_bucket_counts`."""
    by_le: dict[str, float] = {}
    for s in _series_bucket_counts(text, name, labels):
        for le, c in s.items():
            by_le[le] = by_le.get(le, 0.0) + c
    return by_le


def histogram_quantile(text: str, name: str, q: float,
                       labels: dict | None = None) -> float | None:
    """Quantile from a histogram's exposition, merged across matching label
    sets — linear interpolation within the target bucket (the same estimate
    ``MetricsRegistry.quantile`` computes in-process)."""
    by_le = _bucket_counts(text, name, labels)
    if not by_le:
        return None
    finite = sorted(
        (float(le), c) for le, c in by_le.items() if le != "+Inf"
    )
    total = by_le.get("+Inf", finite[-1][1] if finite else 0.0)
    if total <= 0:
        return None
    target = q / 100.0 * total
    lo = 0.0
    prev_cum = 0.0
    for le, cum in finite:
        if cum >= target and cum > prev_cum:
            frac = (target - prev_cum) / (cum - prev_cum)
            return lo + (le - lo) * min(1.0, max(0.0, frac))
        lo, prev_cum = le, cum
    return lo  # +Inf bucket: clamp to the last finite bound


def _series_under(by_le: dict[str, float],
                  threshold_s: float) -> tuple[float, float] | None:
    """(count ≤ threshold, total) for ONE series' cumulative buckets.
    Exact when the threshold is a bucket edge (the :func:`request_bounds`
    alignment); linear interpolation within the covering bucket otherwise
    (a mixed-version host with the default ladder)."""
    finite = sorted(
        (float(le), c) for le, c in by_le.items() if le != "+Inf"
    )
    total = by_le.get("+Inf", finite[-1][1] if finite else 0.0)
    if total <= 0:
        return None
    t = float(threshold_s)
    prev_le, prev_cum = 0.0, 0.0
    for le, cum in finite:
        if t < le:
            if le > prev_le:
                frac_in = (t - prev_le) / (le - prev_le)
                est = prev_cum + (cum - prev_cum) * max(0.0, min(1.0, frac_in))
            else:
                est = cum
            return min(total, est), total
        prev_le, prev_cum = le, cum
        if t == le:
            return min(total, cum), total
    return min(total, prev_cum), total


def fraction_under(text: str, name: str, threshold_s: float,
                   labels: dict | None = None) -> tuple[float, float] | None:
    """(fraction of observations ≤ threshold, total count) from a
    histogram's exposition. Evaluated PER SERIES and aggregated by count —
    each series interpolates on its OWN bucket ladder, so a merged
    multi-host scrape with heterogeneous ladders (hosts declaring
    different objectives) still answers correctly. None when the histogram
    is absent or empty."""
    under_total = 0.0
    count_total = 0.0
    for by_le in _series_bucket_counts(text, name, labels):
        got = _series_under(by_le, threshold_s)
        if got is None:
            continue
        under, total = got
        under_total += under
        count_total += total
    if count_total <= 0:
        return None
    return min(1.0, under_total / count_total), count_total


def verdicts_from_text(text: str, objectives: list[Objective],
                       labels: dict | None = None) -> list[dict]:
    """Objective verdicts judged over a (possibly multi-host merged)
    Prometheus scrape's ``pa_slo_request_seconds`` — the router's
    ``GET /fleet/slo`` view. Exposition histograms are cumulative (process
    lifetime), so these verdicts judge ALL observed traffic, not a sliding
    window — the burn-rate gauges carry the windowed view; the merged
    fraction is the fleet-lifetime achievement."""
    out: list[dict] = []
    for o in objectives:
        got = fraction_under(text, "pa_slo_request_seconds", o.threshold_s,
                             labels=labels)
        if got is None:
            out.append({
                "name": o.name, "threshold_s": o.threshold_s,
                "target": o.target, "requests": 0,
                "achieved_fraction": None, "ok": None,
            })
            continue
        fraction, total = got
        bad_fraction = 1.0 - fraction
        burn = bad_fraction / o.budget
        out.append({
            "name": o.name,
            "threshold_s": o.threshold_s,
            "target": o.target,
            "requests": int(total),
            "achieved_fraction": round(fraction, 6),
            "burn_rate": round(burn, 4),
            "ok": fraction >= o.target,
        })
    return out
