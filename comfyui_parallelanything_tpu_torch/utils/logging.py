"""The package logger with the reference's event vocabulary (counterpart of
``comfyui_parallelanything_tpu/utils/logging.py``).

Records carry the ``[ParallelAnything]`` prefix of the reference's prints and the
calling thread's ``prompt_id`` from its progress scope (``utils/progress.py``), or
``-``. The JAX module also stamps a tracing span id and keeps a flight-recorder
ring for postmortems; both come with the telemetry utils (ROADMAP Queue 1 item 9).
"""

from __future__ import annotations

import logging

_LOGGER_NAME = "parallel_anything_tpu_torch"


class ContextFilter(logging.Filter):
    """Stamp the calling thread's prompt id into every record (``-`` without one)."""

    def filter(self, record: logging.LogRecord) -> bool:
        from .progress import current_scope

        scope = current_scope()
        pid = scope.prompt_id if scope is not None else None
        record.prompt_id = pid if pid is not None else "-"
        return True


def get_logger() -> logging.Logger:
    """The port's node-layer logger, configured once: INFO and up to stderr."""
    logger = logging.getLogger(_LOGGER_NAME)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(
            "[ParallelAnything] %(levelname)s prompt=%(prompt_id)s %(message)s"))
        handler.addFilter(ContextFilter())
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger
