"""Bounded degradation ladder: graceful, observable fallbacks (counterpart of
``comfyui_parallelanything_tpu/utils/degrade.py``).

    stream OOM      → re-carve (finer stages)     rung "stream-recarve"
                    → …until one segment/stage    → exhaustion (clean error)
    serving OOM     → lane-width halve            rung "lane-width-halve"
                    → inline fallback             rung "inline-fallback"
    capture failure → eager loop fallback         rung "compile-eager"

Every rung taken is (1) logged with the reference's vocabulary, (2) counted as
``pa_degradation_total{rung=}`` and (3) recorded as an instant ``degradation`` span
(category ``degrade``) on the tracer, so a quietly degrading server is visible in
``/metrics`` and in ``/trace``, never just slower. A ladder that runs out of rungs
goes through :func:`ladder_exhausted` and re-raises the original error.

The ladder mechanics live where the resources are: ``parallel/orchestrator.py``
re-carves the weight stream, ``serving/scheduler.py`` re-buckets, and
``sampling/runner.py`` falls back to the eager loop when a captured loop cannot
capture (``sampling/compiled.py`` raises ``CaptureError``). This module owns the
rung vocabulary and the failure classification.

Differences from the JAX ladder:
- no ``attn-chunk-shrink`` rung: it lowers the chunked-attention threshold before
  giving up, and the port's attention on the card is K1, which never materialises
  the logits, so there is no threshold to lower;
- ``compile-eager`` is taken by the whole-loop captured sampler only: the port's
  per-lane step program is eager, so the JAX scheduler's ``compile-eager`` branch
  has nothing to fail;
- the perf-ledger record of each rung and the postmortem bundle of an exhausted
  ladder come with the port's ledger (ROADMAP Queue 1 item 9d): until then
  ``ladder_exhausted`` returns None.
"""

from __future__ import annotations

# Rung vocabulary (the pa_degradation_total{rung=} label set).
LADDER_RUNGS = {
    "stream-recarve": "streaming OOM: stage granularity halved "
                      "(parallel/orchestrator._stream_call)",
    "lane-width-halve": "serving dispatch OOM: bucket lane width halved, requests "
                        "re-seated from step 0 (serving/scheduler.py)",
    "inline-fallback": "serving OOM with nothing left to shed: requests resolve "
                       "DegradedToInline and run_sampler runs the inline eager path",
    "compile-eager": "capture failure: the captured whole loop abandoned for the eager "
                     "per-step loop (sampling/runner.py)",
    "exhausted": "a ladder ran out of rungs: clean error (labelled with the ladder "
                 "that exhausted)",
}


class DegradedToInline(RuntimeError):
    """The serving layer shed this request: the submitter (``run_sampler``) runs
    the inline eager path instead. Never escapes ``run_sampler``."""


def _log(rung: str, detail: str, attrs: dict) -> None:
    from .logging import log_degradation

    extra = "".join(f" {k}={v}" for k, v in sorted(attrs.items()))
    log_degradation(rung, f"{detail}{extra}")


def _span(**attrs) -> None:
    from . import tracing

    if tracing.on():
        tracing.record("degradation", tracing.now_us(), 0.0, cat="degrade", **attrs)


def record_rung(rung: str, detail: str, **attrs) -> None:
    """One rung taken: log + counter + span. Never raises once the rung is known:
    the degradation path is where secondary failures are likeliest."""
    if rung not in LADDER_RUNGS:
        raise ValueError(f"unknown degradation rung {rung!r}")
    try:
        _log(rung, detail, attrs)
    except Exception:  # noqa: BLE001
        pass
    try:
        from .metrics import registry

        registry.counter(
            "pa_degradation_total", labels={"rung": rung},
            help="degradation-ladder rungs taken (utils/degrade.py): a quietly "
                 "degrading server is visible here, never just slower")
    except Exception:  # noqa: BLE001
        pass
    try:
        _span(rung=rung, detail=detail, **attrs)
    except Exception:  # noqa: BLE001
        pass


def ladder_exhausted(ladder: str, error: BaseException, detail: str = "") -> str | None:
    """A ladder ran out of rungs: log it, count it, record its span. The caller
    re-raises the original error. Returns the postmortem bundle's path, which the
    port does not write yet (None)."""
    try:
        _log("exhausted", f"{ladder}: {detail or error}", {})
    except Exception:  # noqa: BLE001
        pass
    try:
        from .metrics import registry

        registry.counter("pa_degradation_total", labels={"rung": "exhausted", "ladder": ladder})
    except Exception:  # noqa: BLE001
        pass
    try:
        _span(rung="exhausted", ladder=ladder)
    except Exception:  # noqa: BLE001
        pass
    return None


def _chain(err: BaseException):
    seen = set()
    while err is not None and id(err) not in seen:
        seen.add(id(err))
        yield err
        err = err.__cause__ or err.__context__


def never_degrades(err: BaseException) -> bool:
    """True when ``err`` or anything it was raised from or during is an out-of-memory
    error (its own ladder) or a kernel that failed to build, load or launch
    (``ops.kernels.build.KernelError``: no fallback may hide the kernel)."""
    from ..ops.kernels.build import KernelError
    from ..parallel.orchestrator import is_out_of_memory

    return any(is_out_of_memory(e) or isinstance(e, KernelError) for e in _chain(err))


def is_compile_failure(err: BaseException) -> bool:
    """True when the eager fallback rung applies: a broken capture
    (``sampling.compiled.CaptureError``) that ``never_degrades`` does not claim,
    since the JAX classifier also leaves out-of-memory errors to their own ladder."""
    from ..sampling.compiled import CaptureError

    return isinstance(err, CaptureError) and not never_degrades(err)
