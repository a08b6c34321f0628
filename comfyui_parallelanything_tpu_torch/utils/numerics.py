"""Numerics sentinel: non-finite quarantine and latent fingerprints (counterpart of
``comfyui_parallelanything_tpu/utils/numerics.py``).

- **On-device reductions** (:func:`array_stats` / :func:`lane_stats`): a
  ``[nonfinite_count, max|x|, mean, rms]`` float32 vector computed on the device
  beside the work it watches, read by the host only where it synchronises anyway
  (the serving bucket's dispatch) or later, after the caller's own synchronise
  (:meth:`NumericsSentinel.defer`: a non-blocking copy into page-locked memory and a
  CUDA event, read once the event has completed). The sentinel adds no
  synchronisation of its own.
- **Latent fingerprints** (:func:`digest` / :func:`lane_digest` /
  :func:`latent_fingerprint`): ``Σ (bits_i + 1)·(i·2654435761 + salt) mod 2³²`` over
  the latent's bf16 bit patterns, the JAX package's digest bit for bit, so a
  fingerprint compares across the two packages. Modular addition does not depend on
  the order of the sum; per-lane digests use lane-local positions, so a lane's
  digest does not depend on its slot or the bucket's width.
- **The sentinel** (:data:`sentinel`): events, quarantines and a bounded ring of
  fingerprint records behind one ``enabled`` flag; off, a site costs one flag check.
- **Quarantine forensics**: :func:`bisect_nonfinite` re-runs one failing eval
  through the model's ``PipelineSpec`` (prepare → segments → finalize) and names the
  first block whose output is non-finite, with the JAX package's labels.
- **Failure injection**: a ``lane-nan`` fault plan (``utils/faults.py``, or the
  legacy ``PA_FAIL_INJECT=nan:<lane>``, armed only under a ``PA_LEDGER_DIR`` /
  ``PA_EVIDENCE_DIR`` redirect) poisons one seated lane's next eval input once,
  so the quarantine is rehearsed without a real NaN.

``gate_status`` reads ``<PA_LEDGER_DIR>/numerics_gate.json`` when that directory is
set; the port has no perf ledger and no fingerprint audit script yet (ROADMAP Queue 1
item 9d), so it is None otherwise.

The module level imports no torch: the device helpers import it when called.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

__all__ = [
    "NonFiniteLatent",
    "NumericsSentinel",
    "array_stats",
    "bisect_nonfinite",
    "digest",
    "disable",
    "enable",
    "fail_inject_lane",
    "gate_status",
    "lane_digest",
    "lane_stats",
    "latent_fingerprint",
    "on",
    "sentinel",
    "stats_to_dict",
    "take_injection",
    "tree_nonfinite",
]

GATE_FILENAME = "numerics_gate.json"

# The stats vector's layout, shared by every emitter and reader.
STAT_FIELDS = ("nonfinite", "max_abs", "mean", "rms")

# Digest constants (the JAX package's): a Knuth multiplicative step over element
# positions, everything mod 2^32.
_DIGEST_MULT = 2654435761
_DIGEST_SALT = 0x9E3779B9
_MASK32 = 0xFFFFFFFF


class NonFiniteLatent(RuntimeError):
    """A lane's (or run's) latent went NaN/Inf: raised to the submitter whose lane
    was quarantined (``serving/bucket.py``)."""


# ---------------------------------------------------------------------------
# on-device reductions (tensor ops only: safe inside a CUDA-graph capture)
# ---------------------------------------------------------------------------


def _safe(xf):
    import torch

    finite = torch.isfinite(xf)
    return finite, torch.where(finite, xf, 0.0)


def array_stats(x):
    """``[nonfinite_count, max|x|, mean, rms]`` float32 vector of one tensor, with the
    non-finite entries masked out of the magnitudes (readable on a poisoned
    latent)."""
    import torch

    xf = x.float()
    finite, safe = _safe(xf)
    return torch.stack([(~finite).sum().float(), safe.abs().max(), safe.mean(),
                        torch.sqrt((safe * safe).mean())])


def lane_stats(x, extra=None):
    """Per-lane stats ``[W, 4]`` over a ``[W, ...]`` stack. ``extra`` (same leading
    dim) adds only its non-finite count: the serving bucket passes the next eval
    input, so a NaN a two-eval sampler parks mid-step is caught at the dispatch that
    made it."""
    import torch

    xf = x.float().reshape(x.shape[0], -1)
    finite, safe = _safe(xf)
    nf = (~finite).sum(dim=1).float()
    if extra is not None:
        nf = nf + (~torch.isfinite(extra.float().reshape(extra.shape[0], -1))).sum(dim=1).float()
    return torch.stack([nf, safe.abs().amax(dim=1), safe.mean(dim=1),
                        torch.sqrt((safe * safe).mean(dim=1))], dim=1)


_weight_cache: dict = {}


def _position_weights(n: int, device):
    """``(i·2654435761 + salt) mod 2^32`` for i < n as int64, cached per (n, device)."""
    import torch

    key = (int(n), str(device))
    w = _weight_cache.get(key)
    if w is None:
        idx = torch.arange(n, dtype=torch.int64, device=device)
        w = (idx * _DIGEST_MULT + _DIGEST_SALT) & _MASK32
        if len(_weight_cache) > 64:
            _weight_cache.clear()
        _weight_cache[key] = w
    return w


def _bits(x):
    """The bf16 bit patterns of ``x`` (round to nearest even, as XLA's convert) as
    int64 in [0, 2^16)."""
    import torch

    return x.to(torch.bfloat16).view(torch.int16).to(torch.int64) & 0xFFFF


def digest(x):
    """The uint32 digest of one latent as a 0-d int64 tensor on its device:
    ``Σ (bits_i + 1)·w_i mod 2^32``. The JAX package sums in wrapping uint32; here
    each product (below 2^48) is masked to 32 bits before the int64 sum, so the sum
    stays below 2^63 for any tensor under 2^31 elements and is exact, and the final
    mask takes it mod 2^32: the same value."""
    bits = _bits(x).reshape(-1)
    w = _position_weights(bits.shape[0], bits.device)
    return (((bits + 1) * w) & _MASK32).sum() & _MASK32


def lane_digest(x):
    """Per-lane digests ``[W]`` (int64) over a ``[W, ...]`` stack, each over
    lane-local positions: ``lane_digest(s)[i] == digest(s[i])`` wherever the lane
    sits and however wide the bucket is."""
    bits = _bits(x).reshape(x.shape[0], -1)
    w = _position_weights(bits.shape[1], bits.device)
    return (((bits + 1) * w[None, :]) & _MASK32).sum(dim=1) & _MASK32


def latent_fingerprint(x) -> str:
    """``bf16:<shape>:<%08x>`` of a latent: a pure function of its values,
    independent of the sentinel flag (the JAX package's string)."""
    shape = "x".join(str(d) for d in getattr(x, "shape", ()))
    return f"bf16:{shape}:{int(digest(x)):08x}"


def stats_to_dict(vec) -> dict:
    """A host stats vector as the named dict the events and quarantines carry."""
    import numpy as np

    v = np.asarray(getattr(vec, "cpu", lambda: vec)(), np.float64).reshape(-1)
    out = {k: float(v[i]) for i, k in enumerate(STAT_FIELDS)}
    out["nonfinite"] = int(out["nonfinite"])
    return out


def _float_leaves(tree):
    import torch

    if isinstance(tree, torch.Tensor):
        if tree.is_floating_point():
            yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _float_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _float_leaves(v)


def count_nonfinite(tree):
    """Non-finite elements over every floating tensor of a tree, as a 0-d int64
    tensor on the first leaf's device (no host read); None for a tree without one."""
    import torch

    total = None
    for leaf in _float_leaves(tree):
        n = (~torch.isfinite(leaf)).sum()
        total = n if total is None else total + n.to(total.device)
    return total


def to_host_async(tensors, out: list | None = None) -> list:
    """Host copies of device tensors, enqueued without blocking into page-locked
    memory on the current stream: valid after the caller's next synchronise, which
    they add none to. ``out`` reuses page-locked buffers of the same shapes (a caller
    that reads them before its next copy); CPU tensors come back as they are."""
    import torch

    result = []
    for i, t in enumerate(tensors):
        if t.device.type != "cuda":
            result.append(t)
            continue
        h = out[i] if out is not None and i < len(out) else None
        if h is None or h.shape != t.shape or h.dtype != t.dtype:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t.detach(), non_blocking=True)
        result.append(h)
    return result


def tree_nonfinite(tree) -> int:
    """Total non-finite elements over every floating tensor of a tree, read on the
    host (forensics only: it synchronises)."""
    total = count_nonfinite(tree)
    return 0 if total is None else int(total)


# ---------------------------------------------------------------------------
# the sentinel
# ---------------------------------------------------------------------------


class NumericsSentinel:
    """Process-wide numerics bookkeeping behind one ``enabled`` flag. Enabled, it
    keeps non-finite events, quarantine records and a bounded ring of fingerprint
    records, mirrored into ``pa_numerics_*`` metrics and ``numerics``-category spans
    (best effort: a metrics fault never breaks the path it observes)."""

    def __init__(self) -> None:
        self.enabled = False
        self._lock = threading.Lock()
        self._events = 0
        self._quarantined = 0
        self.last_event: dict | None = None
        self.last_quarantine: dict | None = None
        # {"rid", "sampler", "bucket", "steps", "digests": [...]} per lane, or
        # {"where", "digests": [...]} per loop: bounded.
        self._fingerprints: deque = deque(maxlen=64)  # guarded-by: _lock
        self._inject_done = False
        # Deferred device reads: (event or None, host tensors, callback).
        self._pending: list = []  # guarded-by: _lock

    # -- lifecycle ----------------------------------------------------------

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        """Zero the counters and records (the flag stays) and re-arm the one-shot
        injection."""
        with self._lock:
            self._events = 0
            self._quarantined = 0
            self.last_event = None
            self.last_quarantine = None
            self._fingerprints.clear()
            self._inject_done = False
            self._pending.clear()

    # -- deferred device reads ----------------------------------------------

    def defer(self, tensors, callback) -> None:
        """Read ``tensors`` (device values) later without synchronising: each is
        copied without blocking into page-locked host memory on the current stream,
        an event marks the copies, and ``callback(*host_tensors)`` runs once the
        event has completed, at the next :meth:`flush` (which the streaming runner,
        the loops and every read of the records call). On the CPU the callback runs
        now."""
        import torch

        tensors = [t.detach() for t in tensors]
        if not tensors or tensors[0].device.type != "cuda":
            callback(*tensors)
            return
        host = to_host_async(tensors)
        event = torch.cuda.Event()
        event.record()
        with self._lock:
            self._pending.append((event, host, callback))

    def flush(self, wait: bool = False) -> int:
        """Run the callbacks of every deferred read whose copies have completed
        (``wait``: wait for them, which synchronises on their events: tests and
        reports only). Returns how many ran."""
        with self._lock:
            pending, self._pending = self._pending, []
        keep, ran = [], 0
        for event, host, callback in pending:
            if wait:
                event.synchronize()
            elif not event.query():
                keep.append((event, host, callback))
                continue
            try:
                callback(*host)
            except Exception:  # noqa: BLE001 - observation never breaks the path
                pass
            ran += 1
        if keep:
            with self._lock:
                self._pending[:0] = keep
        return ran

    # -- recording ----------------------------------------------------------

    def record_event(self, where: str, **info) -> dict:
        """One non-finite observation (not necessarily a quarantine: the streaming
        runner records stage events, a loop a poisoned final latent). Feeds the
        counter, the last-event slot and, with tracing on, a ``nonfinite-event``
        span."""
        event = {"where": where, "ts": time.time(), **info}
        with self._lock:
            self._events += 1
            self.last_event = event
        try:
            from .metrics import registry

            registry.counter("pa_numerics_nonfinite_total", labels={"where": where},
                             help="non-finite latent/state observations by site")
        except Exception:  # noqa: BLE001
            pass
        try:
            from . import tracing

            if tracing.on():
                tracing.record("nonfinite-event", tracing.now_us(), 0.0, cat="numerics",
                               **{k: v for k, v in info.items()
                                  if isinstance(v, (str, int, float))}, where=where)
        except Exception:  # noqa: BLE001
            pass
        return event

    def record_quarantine(self, **info) -> dict:
        """One lane quarantine (``serving/bucket.py``): bucket, lane, request,
        sampler, the first non-finite step, σ and block, and the postmortem bundle
        (None until the perf ledger and its bundles are ported, ROADMAP item 9d)."""
        rec = {"ts": time.time(), **info}
        with self._lock:
            self._quarantined += 1
            self.last_quarantine = rec
        try:
            from .metrics import registry

            registry.counter("pa_numerics_quarantined_total",
                             labels={"bucket": str(info.get("bucket", "?"))},
                             help="serving lanes retired by the non-finite quarantine")
        except Exception:  # noqa: BLE001
            pass
        try:
            from . import tracing

            if tracing.on():
                tracing.record("quarantine", tracing.now_us(), 0.0, cat="numerics",
                               bucket=str(info.get("bucket")), lane=info.get("lane"),
                               step=info.get("step"), rid=info.get("rid"))
        except Exception:  # noqa: BLE001
            pass
        return rec

    def record_fingerprints(self, **rec) -> None:
        with self._lock:
            self._fingerprints.append(rec)

    def recent_fingerprints(self) -> list[dict]:
        self.flush()
        with self._lock:
            return list(self._fingerprints)

    # -- read side ----------------------------------------------------------

    @property
    def event_count(self) -> int:
        return self._events

    @property
    def quarantined_count(self) -> int:
        return self._quarantined

    def snapshot(self) -> dict:
        """``GET /health``'s ``numerics`` section: the flag, the event and quarantine
        totals, the last of each, and the fingerprint gate's last verdict."""
        self.flush()
        with self._lock:
            out = {
                "enabled": self.enabled,
                "nonfinite_events": self._events,
                "quarantined_lanes": self._quarantined,
                "last_event": dict(self.last_event) if self.last_event else None,
                "last_quarantine": (dict(self.last_quarantine)
                                    if self.last_quarantine else None),
            }
        out["fingerprint_gate"] = gate_status()
        return out

    def publish_gauges(self) -> None:
        """The totals as gauges, so a scrape sees them before the first event."""
        self.flush()
        try:
            from .metrics import registry

            registry.gauge("pa_numerics_sentinel_enabled", 1.0 if self.enabled else 0.0,
                           help="numerics sentinel flag (utils/numerics.py)")
            registry.gauge("pa_numerics_nonfinite_events", self._events,
                           help="non-finite observations this process")
            registry.gauge("pa_numerics_quarantined_lanes", self._quarantined,
                           help="lanes quarantined this process")
        except Exception:  # noqa: BLE001
            pass


sentinel = NumericsSentinel()


def on() -> bool:
    """The hot-path check: guard every stats computation with it."""
    return sentinel.enabled


def enable() -> None:
    sentinel.enable()


def disable() -> None:
    sentinel.disable()


def gate_status() -> dict | None:
    """The fingerprint gate's last verdict, ``<PA_LEDGER_DIR>/numerics_gate.json``,
    or None (no directory set, no file)."""
    ledger = os.environ.get("PA_LEDGER_DIR")
    if not ledger:
        return None
    try:
        with open(os.path.join(ledger, GATE_FILENAME)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


# ---------------------------------------------------------------------------
# failure injection (a lane-nan fault plan, or PA_FAIL_INJECT=nan:<lane>)
# ---------------------------------------------------------------------------


def fail_inject_lane() -> int | None:
    """The lane to poison, or None: the ``lane-nan`` site of the fault registry
    (``utils/faults.py``), re-read when the environment changed since it was
    parsed."""
    from . import faults

    return faults.refresh().lane_nan_target()


def take_injection(active_lanes) -> int | None:
    """One-shot: the armed lane if it is seated now, consuming the injection; else
    None (it stays armed until the lane exists). ``sentinel.reset()`` re-arms. A
    consumed injection is reported to the fault registry (span and
    ``pa_fault_injected_total{site="lane-nan"}``)."""
    lane = fail_inject_lane()
    if lane is None or lane not in active_lanes:
        return None
    with sentinel._lock:
        if sentinel._inject_done:
            return None
        sentinel._inject_done = True
    from . import faults

    faults.registry.record_external("lane-nan", key=str(lane), mode="nan")
    return lane


# ---------------------------------------------------------------------------
# per-block bisection (which block of a quarantined eval went non-finite)
# ---------------------------------------------------------------------------


def _finite(tree) -> bool:
    return tree_nonfinite(tree) == 0


def eval_input(xe, sigma_eval: float, prediction: str, log_sigmas):
    """One request's model input for one eval, as the lane program prepares it:
    ``(x_in, t_vec)`` from the eval-input latent and σ (``EpsDenoiser``'s operations:
    the 1/√(σ²+1) scale and the σ→timestep log interpolation for eps/v, the flow
    time passed through for flow)."""
    import torch

    from ..sampling import k_samplers

    batch = xe.shape[0]
    s = k_samplers._f32(float(sigma_eval))
    if prediction == "flow":
        return xe, torch.full((batch,), float(s), dtype=torch.float32, device=xe.device)
    scale = 1.0 / torch.sqrt(s**2 + 1.0)
    t = k_samplers.interp(torch.log(s), torch.as_tensor(log_sigmas).cpu(),
                          torch.arange(len(log_sigmas), dtype=torch.float32))
    return (xe * scale.to(xe.device),
            torch.full((batch,), float(t), dtype=torch.float32, device=xe.device))


def _staged(model):
    """``(PipelineSpec, module)`` of a model that declares its stages, else None."""
    spec = getattr(model, "pipeline_spec", None)
    if spec is None:
        spec = getattr(model, "_pipeline_spec", None)
    if spec is None or not spec.segments:
        return None
    lead = getattr(model, "_lead_replica", None)
    module = lead() if callable(lead) else getattr(model, "module", model)
    return spec, module


def bisect_nonfinite(model, xe, sigma_eval: float, prediction: str, log_sigmas, context,
                     kwargs: dict | None = None) -> dict:
    """Re-run ONE model eval stage by stage and name the first non-finite block.
    Returns ``{"block": <label or None>, "sigma": σ, "prediction": ...}``:

    - ``"lane-input"``: the eval input was already poisoned (the injection's case,
      or a blow-up in the sampler update);
    - a ``PipelineSpec`` label (``prepare``, the segment's own label, ``finalize``)
      for a model that declares its stages: the same prepare → segments → finalize
      walk the pipeline and streaming runners take;
    - ``"model-output"``: a model without stages whose whole forward is non-finite;
    - None: nothing non-finite reproduced.

    The cond branch only (CFG mixes elementwise after the forward). Forensics: the
    callers catch what it raises."""
    import torch

    out: dict = {"sigma": float(sigma_eval), "prediction": prediction}
    if not _finite(xe):
        out["block"] = "lane-input"
        return out
    x_in, t_vec = eval_input(xe, sigma_eval, prediction, log_sigmas)
    kwargs = dict(kwargs or {})
    staged = _staged(model)
    with torch.no_grad():
        if staged is not None:
            spec, module = staged
            carry = spec.prepare(module, x_in, t_vec, context, **kwargs)
            if not _finite(carry):
                out["block"] = "prepare"
                return out
            for i, seg in enumerate(spec.segments):
                carry = seg.fn(module, carry)
                if not _finite(carry):
                    out["block"] = seg.label or f"segment[{i}]"
                    out["segment_index"] = i
                    return out
            final = spec.finalize(module, carry, tuple(x_in.shape))
            out["block"] = "finalize" if not _finite(final) else None
            return out
        try:
            y = model(x_in, t_vec, context, **kwargs)
            out["block"] = "model-output" if not _finite(y) else None
        except Exception as e:  # noqa: BLE001 - forensics, not control flow
            out["block"] = None
            out["rerun_error"] = f"{type(e).__name__}: {e}"
    return out
