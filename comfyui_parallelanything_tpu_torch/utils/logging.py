"""The package logger with the reference's event vocabulary (counterpart of
``comfyui_parallelanything_tpu/utils/logging.py``).

Records carry the ``[ParallelAnything]`` prefix of the reference's prints and the
calling thread's ``prompt_id`` and ``span_id`` from its trace context
(``utils/tracing.py``'s span stack, falling back to the ``utils/progress.py``
scope), or ``-``, so a grep for one prompt's id yields its log and its ``/trace``
timeline with the same key. The JAX module's flight-recorder ring (the last
records a postmortem bundle dumps) comes with the postmortem bundles (ROADMAP
Queue 1 item 9d).
"""

from __future__ import annotations

import logging
from collections.abc import Sequence

_LOGGER_NAME = "parallel_anything_tpu_torch"


class ContextFilter(logging.Filter):
    """Stamp the calling thread's prompt and span ids into every record (``-``
    without one). A tracing hiccup degrades to ``-`` fields, never to a lost line."""

    def filter(self, record: logging.LogRecord) -> bool:
        prompt_id = span_id = None
        try:
            from . import tracing

            prompt_id = tracing.current_prompt_id()
            span_id = tracing.current_span_id()
        except Exception:  # noqa: BLE001
            pass
        record.prompt_id = prompt_id if prompt_id is not None else "-"
        record.span_id = span_id if span_id is not None else "-"
        return True


def get_logger() -> logging.Logger:
    """The port's logger, configured once: INFO and up to stderr."""
    logger = logging.getLogger(_LOGGER_NAME)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(
            "[ParallelAnything] %(levelname)s prompt=%(prompt_id)s span=%(span_id)s "
            "%(message)s"))
        handler.addFilter(ContextFilter())
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


def log_setup_summary(devices: Sequence[str], weights: Sequence[float], mode: str) -> None:
    """The setup summary: the reference's device/percentage table print."""
    table = ", ".join(f"{d}={w * 100:.1f}%" for d, w in zip(devices, weights))
    get_logger().info("parallel setup (%s): %s", mode, table)


def log_placement(device: str, what: str) -> None:
    """Per-device placement: the reference's per-device clone progress prints."""
    get_logger().info("placed %s on %s", what, device)


def log_degradation(event: str, detail: str) -> None:
    """Degradation events: the reference's OOM warnings ("Reducing to N devices")."""
    get_logger().warning("degradation [%s]: %s", event, detail)
