"""The model handle the orchestrator consumes (counterpart of
``comfyui_parallelanything_tpu/models/api.py``): an ``nn.Module`` plus the
metadata the parallel layers need. ``PipelineSpec``/``PipelineSegment`` describe
a model's staged decomposition as plain data; the runner that places stages on
devices is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch


@dataclasses.dataclass(frozen=True)
class PipelineSegment:
    """One pipeline-schedulable unit of the forward pass, usually one block.

    ``param_keys`` names the top-level submodules this segment reads;
    ``fn(module, carry) -> carry`` runs it on the flat dict of tensors that carries
    activations between segments.
    """

    param_keys: tuple[str, ...]
    fn: Callable[[Any, dict], dict]
    label: str = ""


@dataclasses.dataclass(frozen=True)
class PipelineSpec:
    """A model's pipeline decomposition: prepare (lead) → segments → finalize (lead)."""

    prepare_keys: tuple[str, ...]
    prepare: Callable[..., dict]  # (module, x, t, context, **kwargs) -> carry
    segments: tuple[PipelineSegment, ...]
    finalize_keys: tuple[str, ...]
    # (module, carry, out_shape) -> output; out_shape is the input's shape tuple.
    finalize: Callable[[Any, dict, tuple], Any]


@dataclasses.dataclass
class DiffusionModel:
    """A diffusion network: the module holding its weights, plus metadata."""

    module: torch.nn.Module
    name: str = "model"
    config: Any = None
    # Block-list name -> number of blocks, in execution order.
    block_lists: dict[str, int] | None = None
    # Staged decomposition for batch==1 pipeline placement; None → cannot pipeline.
    pipeline_spec: PipelineSpec | None = None
    # Sampling defaults set by patch nodes (RescaleCFG's cfg_rescale, the
    # ModelSampling* shift); an explicit widget value wins.
    sampler_prefs: dict | None = None
    # Loader provenance ({"path", "family", ...}) the LoraLoader shims re-bake
    # from; a field, so every patch's dataclasses.replace carries it.
    source: dict | None = None
    # Serving delegation for a ControlNet composition (models/controlnet.
    # apply_control): {"base", "ctrl_apply", "ctrl_params", "hint", "strength",
    # "start", "end"}. The continuous-batching scheduler buckets such a model on its
    # BASE and carries the control net as per-lane state, so ControlNet traffic
    # co-batches with plain lanes. None: served as an opaque model.
    control_delegate: dict | None = None
    # Serving delegation for a baked-LoRA model (the LoraLoader shims): {"base",
    # "factors"}, the unpatched model (the loader's cached output, so its identity
    # matches plain prompts) and the factor map the bake recovers to. The sampler
    # nodes submit (base, factors), so per-request LoRA rides as per-lane state;
    # inline runs keep this model's baked weights. None: bake only.
    lora_delegate: dict | None = None

    def __call__(self, x, timesteps, context=None, **kwargs):
        """Inference forward ``module(x, timesteps, context, **kwargs)``."""
        with torch.no_grad():
            return self.module(x, timesteps, context, **kwargs)

    def n_params(self) -> int:
        return sum(p.numel() for p in self.module.parameters())
