from .chain import DeviceChain, DeviceLink
from .split import (
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
from .mesh import build_mesh, fsdp_spec, mesh_axis_names, place_params, place_params_fsdp
from .sequence import sequence_parallel_attention
from .pipeline import PipelineRunner, build_pipeline_runner
from .streaming import StreamingRunner, build_streaming_runner
from .multihost import host_local_batch, hybrid_mesh, initialize_distributed, is_multihost

__all__ = [
    "sequence_parallel_attention",
    "PipelineRunner",
    "build_pipeline_runner",
    "StreamingRunner",
    "build_streaming_runner",
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
    "fsdp_spec",
    "place_params",
    "place_params_fsdp",
    "initialize_distributed",
    "is_multihost",
    "hybrid_mesh",
    "host_local_batch",
    "build_mesh",
    "mesh_axis_names",
]
