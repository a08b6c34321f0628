"""Continuous-batching serving (counterpart of
``comfyui_parallelanything_tpu/serving/``).

Sits between ``server.PromptQueue`` and ``sampling/runner.py``: concurrent prompts'
sampler runs that agree on (model, shape, CFG mode), running any sampler of the
``LaneStepSpec`` registry, stochastic ones included, share ONE batched model step,
joining and leaving the fixed-width batch at step boundaries. See
``serving/scheduler.py`` for the architecture and ``sampling/lane_specs.py`` for the
per-lane step plans.
"""

from .bucket import ServeRequest, StepBucket, batched_fraction
from .decode import DecodeQueue, DecodeTicket, get_decode_queue
from .policy import AdmissionQueue, DeadlineExceeded, ServingRejected
from .scheduler import (
    BATCHABLE_SAMPLERS,
    ContinuousBatchingScheduler,
    get_scheduler,
    serving_hints,
)

__all__ = [
    "AdmissionQueue",
    "BATCHABLE_SAMPLERS",
    "ContinuousBatchingScheduler",
    "DeadlineExceeded",
    "DecodeQueue",
    "DecodeTicket",
    "ServeRequest",
    "ServingRejected",
    "StepBucket",
    "batched_fraction",
    "get_decode_queue",
    "get_scheduler",
    "serving_hints",
]
