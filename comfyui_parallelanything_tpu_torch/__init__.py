"""PyTorch/CUDA port of ``comfyui_parallelanything_tpu`` for NVIDIA Hopper GPUs.

The JAX package is the reference; this package mirrors its layout (``devices/``,
``ops/``, ``models/``, ``parallel/``, ``sampling/``) and keeps its public tensor
layouts (NHWC latents, BSHD attention), and its node layer and graph host
(``nodes.py``, ``host.py``) run the JAX package's ComfyUI API-format graphs under
the same node names. Its hand-written CUDA kernels live in
``csrc/`` and build at first use (``ops/kernels/build.py``). Entry points run on
``cuda:0`` unless the caller passes a CPU device.
"""

from .devices.discovery import available_devices, default_device, get_device
from .host import WorkflowCache, WorkflowError, run_workflow
from .nodes import NODE_CLASS_MAPPINGS, NODE_DISPLAY_NAME_MAPPINGS
from .parallel.chain import DeviceChain, DeviceLink
from .parallel.orchestrator import ParallelConfig, ParallelModel, parallelize
from .models.generic import derive_pipeline_spec, wrap_module
from .pipelines import FluxPipeline, Sd3Pipeline, StableDiffusionPipeline, WanVideoPipeline

__all__ = [
    "NODE_CLASS_MAPPINGS",
    "NODE_DISPLAY_NAME_MAPPINGS",
    "DeviceChain",
    "DeviceLink",
    "FluxPipeline",
    "ParallelConfig",
    "ParallelModel",
    "Sd3Pipeline",
    "StableDiffusionPipeline",
    "WanVideoPipeline",
    "WorkflowCache",
    "WorkflowError",
    "available_devices",
    "default_device",
    "derive_pipeline_spec",
    "get_device",
    "parallelize",
    "run_workflow",
    "wrap_module",
]
