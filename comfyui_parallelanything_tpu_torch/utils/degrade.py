"""The serving layer's degradation rungs (counterpart of
``comfyui_parallelanything_tpu/utils/degrade.py``, the part the scheduler uses).

A dispatch that runs out of device memory does not fail its prompts: the
scheduler (``serving/scheduler.py``) halves the bucket's lane width and re-seats
its requests from step 0, and once the width is 1 it hands every request back to
``run_sampler``, which runs it on the inline eager path. Each rung taken is logged
with the reference's vocabulary and counted as ``pa_degradation_total{rung=}``.

The port's ladder has two rungs where the JAX one has three: the JAX ladder's
``attn-chunk-shrink`` lowers the chunked-attention threshold before giving up, and
the port's attention on the card is K1, which never materialises the logits, so
no threshold is there to lower. Left out with the telemetry utils (ROADMAP Queue 1
item 9): the rung's tracing span and its perf-ledger record, the streaming ladder
(``stream-recarve``; the port's orchestrator logs its re-carve) and the compile
ladder (the port has no compile step to fail: a captured loop that cannot capture
raises, ``sampling/compiled.py``).
"""

from __future__ import annotations

LADDER_RUNGS = {
    "lane-width-halve": "serving dispatch OOM: bucket lane width halved, requests "
                        "re-seated from step 0 (serving/scheduler.py)",
    "inline-fallback": "serving OOM with nothing left to shed: requests resolve "
                       "DegradedToInline and run_sampler runs the inline eager path",
}


class DegradedToInline(RuntimeError):
    """The serving layer shed this request: the submitter (``run_sampler``) runs
    the inline eager path instead. Never escapes ``run_sampler``."""


def record_rung(rung: str, detail: str, **attrs) -> None:
    """One rung taken: a warning in the package log and a
    ``pa_degradation_total{rung=}`` count. Never raises: the degradation path is
    where secondary failures are likeliest."""
    if rung not in LADDER_RUNGS:
        raise ValueError(f"unknown degradation rung {rung!r}")
    try:
        from .logging import get_logger

        extra = "".join(f" {k}={v}" for k, v in sorted(attrs.items()))
        get_logger().warning("degradation %s: %s%s", rung, detail, extra)
    except Exception:  # noqa: BLE001
        pass
    try:
        from .metrics import registry

        registry.counter(
            "pa_degradation_total", labels={"rung": rung},
            help="degradation-ladder rungs taken (utils/degrade.py)")
    except Exception:  # noqa: BLE001
        pass
