from .logging import get_logger, log_degradation, log_placement, log_setup_summary
from .metrics import StepStats, StepTimer, trace
from .checks import assert_finite, checked
from . import degrade, faults, numerics, roofline, slo, telemetry, tracing

# The JAX package's retry module waits for ROADMAP Queue 1 item 9d; its compile
# cache and cleanup are not ported (``NOT_EXPORTED`` in the package's ``__init__``).
__all__ = [
    "degrade",
    "faults",
    "numerics",
    "roofline",
    "slo",
    "get_logger",
    "log_setup_summary",
    "log_placement",
    "log_degradation",
    "StepTimer",
    "StepStats",
    "trace",
    "tracing",
    "telemetry",
    "assert_finite",
    "checked",
]
