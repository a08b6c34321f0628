from .logging import get_logger, log_degradation, log_placement, log_setup_summary
from .metrics import StepStats, StepTimer, trace
from .checks import assert_finite, checked
from . import degrade, roofline, slo, telemetry, tracing

# The JAX package's faults, numerics and retry modules wait for ROADMAP Queue 1
# items 9b and 9d; its compile cache and cleanup are not ported (``NOT_EXPORTED``
# in the package's ``__init__``).
__all__ = [
    "degrade",
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
