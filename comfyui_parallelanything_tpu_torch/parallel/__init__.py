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
from .pipeline import PipelineRunner, build_pipeline_runner
from .streaming import StreamingRunner, build_streaming_runner

# The JAX package's mesh, sequence-parallel and multihost names wait for ROADMAP
# Queue 1 item 7 (``NOT_EXPORTED`` in the package's ``__init__``).
__all__ = [
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
]
