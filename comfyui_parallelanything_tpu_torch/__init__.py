"""PyTorch/CUDA port of ``comfyui_parallelanything_tpu`` for NVIDIA Hopper GPUs.

The JAX package is the reference; this package mirrors its layout (``devices/``,
``ops/``, ``models/``, ``parallel/``, ``sampling/``, ``serving/``, ``utils/``) and
its public names (each subpackage's ``__all__`` holds the JAX one's, less what
``NOT_EXPORTED`` lists with its reason), and keeps its public tensor layouts (NHWC
latents, BSHD attention); its node layer and graph host (``nodes.py``, ``host.py``)
run the JAX package's ComfyUI API-format graphs under the same node names. Its
hand-written CUDA kernels live in ``csrc/`` and build at first use
(``ops/kernels/build.py``). Entry points run on ``cuda:0`` unless the caller
passes a CPU device.
"""

from .version import __version__

from .devices.discovery import available_devices, default_device, device_platform, get_device
from .devices.memory import free_memory_bytes, total_memory_bytes
from .host import WorkflowCache, WorkflowError, run_workflow
from .nodes import NODE_CLASS_MAPPINGS, NODE_DISPLAY_NAME_MAPPINGS
from .parallel.chain import DeviceChain, DeviceLink
from .parallel.orchestrator import ParallelConfig, ParallelModel, parallelize
from .parallel.split import (
    batch_size_of,
    blend_memory_weights,
    blend_speed_weights,
    block_ranges,
    concat_results,
    largest_remainder_split,
    normalize_weights,
    split_kwargs,
    split_tree,
    weighted_batch_split,
)
from .models.generic import derive_pipeline_spec, wrap_module
from .pipelines import FluxPipeline, Sd3Pipeline, StableDiffusionPipeline, WanVideoPipeline
from .utils.metrics import StepTimer, trace

_ITEM_7 = "ROADMAP Queue 1 item 7 (fsdp / tp, sequence parallelism, multihost)"

# Names of a JAX package's ``__all__`` that the port's counterpart does not export,
# by subpackage ("" is the top level), each with its reason. Nothing here is
# defined by the port under the JAX name (``ops.attention`` is a module).
NOT_EXPORTED: dict[str, dict[str, str]] = {
    "": {
        "build_mesh": _ITEM_7,
        "mesh_axis_names": _ITEM_7,
        "sequence_parallel_attention": _ITEM_7,
        "wrap_flax_module": "wraps a flax module; the port's counterpart for an "
                            "nn.Module is wrap_module",
    },
    "parallel": {
        "build_mesh": _ITEM_7,
        "mesh_axis_names": _ITEM_7,
        "fsdp_spec": _ITEM_7,
        "place_params": _ITEM_7,
        "place_params_fsdp": _ITEM_7,
        "sequence_parallel_attention": _ITEM_7,
        "initialize_distributed": _ITEM_7,
        "is_multihost": _ITEM_7,
        "hybrid_mesh": _ITEM_7,
        "host_local_batch": _ITEM_7,
    },
    "ops": {
        "attention": "the name is the port's ops.attention module, which its callers "
                     "import as a module; the function is ops.attention.attention",
    },
    "utils": {
        "retry": "ROADMAP Queue 1 item 9d",
        "enable_compilation_cache": "not ported: the kernels compile once, in the "
                                    "nvcc build cached by source (ops/kernels/build.py)",
        "aggressive_cleanup": "not ported: ParallelModel's _release_memory does its work",
    },
    "models": {
        "wrap_flax_module": "wraps a flax module; the port's counterpart for an "
                            "nn.Module is wrap_module",
        "QuantTensor": "a JAX pytree leaf; an int8 weight of the port is a Dequantize "
                       "parametrization holding the payload and its scales "
                       "(models/quantize.py)",
        "quantize_params": "quantizes a parameter pytree; the port quantizes a module's "
                           "weights in place with quantize_module (or quantize_model)",
        "dequantize_params": "the port dequantizes on every read of a quantized weight, "
                             "inside the forward (the parametrization); there is no "
                             "pytree to map",
        "flux_abstract_params": "a jax.eval_shape pytree; the port builds FLUX without "
                                "allocating on the meta device: build_flux(cfg, "
                                "device=\"meta\", generator=g)",
    },
}

# JAX subpackages with no counterpart yet.
NOT_PORTED_SUBPACKAGES = {
    "fleet": "journal, registry, roles, router, scoreboard, twin: ROADMAP Queue 1 item 9d",
}

__all__ = [
    "__version__",
    "NODE_CLASS_MAPPINGS",
    "NODE_DISPLAY_NAME_MAPPINGS",
    "available_devices",
    "get_device",
    "device_platform",
    "default_device",
    "free_memory_bytes",
    "total_memory_bytes",
    "DeviceLink",
    "DeviceChain",
    "normalize_weights",
    "largest_remainder_split",
    "weighted_batch_split",
    "blend_memory_weights",
    "blend_speed_weights",
    "block_ranges",
    "batch_size_of",
    "split_tree",
    "split_kwargs",
    "concat_results",
    "parallelize",
    "ParallelConfig",
    "ParallelModel",
    "StableDiffusionPipeline",
    "FluxPipeline",
    "WanVideoPipeline",
    "Sd3Pipeline",
    "derive_pipeline_spec",
    "wrap_module",
    "run_workflow",
    "WorkflowCache",
    "WorkflowError",
    "StepTimer",
    "trace",
]
