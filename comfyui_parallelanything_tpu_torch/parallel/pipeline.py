"""Pipeline (batch==1) block placement (counterpart of
``comfyui_parallelanything_tpu/parallel/pipeline.py``).

A model declares a ``PipelineSpec`` (``models/api.py``): prepare → one segment
per block → finalize. The runner carves the segments into contiguous stage
ranges proportional to the chain's weights (``split.block_ranges``; a device
whose range is empty holds no stage) and runs each stage's segments back to back
on its device, the activation carry (image and text streams, ``vec``, the rope
tables) hopping from stage to stage; prepare and finalize run on the lead
device, as the reference runs its non-block layers there.

Placement happens once, when the runner is built, and each stage holds only
its own segments' submodules: a stage's module is a shallow view of the model
whose named submodules are those placed on the stage's device, every other
entry a reference to the source (never read by the stage's segments). A
submodule that already lives on the stage's device, in the source module or
in a replica the orchestrator placed there, is used as it is, so a stage on
the model's own device copies nothing.

Hops: device → host is a blocking copy, so a host stage never reads its inputs
before they have landed; host → device and device → device are issued
``non_blocking`` (a pageable host source is staged before the call returns).

Like the JAX runner, a call inside an active ``sequence_parallel`` context
(``ops/attention.sequence_ctx_key``) raises ``ValueError``: a stage holds one
device, the context's attention a mesh.
"""

from __future__ import annotations

import copy
import dataclasses
import logging
from collections.abc import Sequence
from typing import Any, Callable

import torch

from ..models.api import PipelineSpec
from .orchestrator import _module_on, _place, _to
from .split import block_ranges

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class _Stage:
    device: torch.device
    module: torch.nn.Module  # a view holding this stage's submodules on ``device``
    fns: tuple[Callable[[Any, dict], dict], ...]
    labels: tuple[str, ...]
    range: tuple[int, int]


def _shallow(module: torch.nn.Module) -> torch.nn.Module:
    """A copy of ``module`` that shares its tensors and its children but owns the
    dict naming its children, so a child can be swapped without touching the
    source."""
    view = copy.copy(module)
    view._modules = dict(module._modules)
    return view


def _resolve(module: torch.nn.Module, key: str) -> torch.nn.Module | None:
    """The submodule a dotted ``key`` names, or None."""
    for part in key.split("."):
        module = module._modules.get(part) if module is not None else None
    return module


def _placed(sources: Sequence[torch.nn.Module], key: str, device: torch.device):
    """``key``'s submodule on ``device``: one of ``sources`` that already holds it
    there, else a copy of the first source's."""
    subs = [_resolve(m, key) for m in sources]
    held = [sub for sub in subs if sub is not None and _module_on(sub, device)]
    return held[0] if held else _place(subs[0], device)


def _view_with(root: torch.nn.Module, keys: Sequence[str],
                make: Callable[[str], torch.nn.Module]) -> torch.nn.Module:
    """A shallow view of ``root`` whose submodule named by each of ``keys`` is
    ``make(key)``; raises KeyError for a key the model does not have (as the JAX
    runner's ``subset`` does). The weight-streaming runner builds its stage views
    with the same walk."""
    missing = [k for k in keys if _resolve(root, k) is None]
    if missing:
        raise KeyError(f"pipeline spec references submodules not in the model: {missing}")
    view = _shallow(root)
    for key in keys:
        *path, leaf = key.split(".")
        node = view
        for part in path:
            node._modules[part] = _shallow(node._modules[part])
            node = node._modules[part]
        node._modules[leaf] = make(key)
    return view


def _stage_view(sources: Sequence[torch.nn.Module], keys: Sequence[str],
                device: torch.device) -> torch.nn.Module:
    """A view of ``sources[0]`` with every submodule ``keys`` names placed on
    ``device``."""
    return _view_with(sources[0], keys, lambda key: _placed(sources, key, device))


class PipelineRunner:
    """Callable ``(x, timesteps, context=None, **kwargs) -> output`` running the
    staged forward across devices. Built once per (spec, devices, weights).

    ``module`` is the model's module; ``residents`` are replicas of it already
    placed on some devices, whose submodules a stage on such a device reuses. The
    carve is the weight-proportional one (the JAX runner's ``ranges`` override
    carries the planner's carve, which is not ported)."""

    def __init__(self, spec: PipelineSpec, module: torch.nn.Module,
                 devices: Sequence[torch.device], weights: Sequence[float],
                 residents: Sequence[torch.nn.Module] = ()):
        self.lead = devices[0]
        self._spec = spec
        self.ranges = block_ranges(len(spec.segments), weights)
        sources = [module, *residents]
        self._prepare = _stage_view(sources, spec.prepare_keys, self.lead)
        self._finalize = _stage_view(sources, spec.finalize_keys, self.lead)
        self.stages: list[_Stage] = []
        for (s, e), dev in zip(self.ranges, devices):
            if s == e:
                continue  # a zero-weight device holds no stage
            keys: list[str] = []
            for seg in spec.segments[s:e]:
                keys.extend(k for k in seg.param_keys if k not in keys)
            self.stages.append(_Stage(
                device=dev, module=_stage_view(sources, keys, dev),
                fns=tuple(seg.fn for seg in spec.segments[s:e]),
                labels=tuple(seg.label for seg in spec.segments[s:e]), range=(s, e)))
            logger.info("pipeline stage on %s: segments [%d, %d) (%d blocks)", dev, s, e, e - s)

    @property
    def n_stages(self) -> int:
        return len(self.stages)

    @staticmethod
    def _hop(carry: dict, device: torch.device) -> dict:
        """Move the carry to ``device``: blocking into host memory, so a host stage
        starts only once its inputs have landed; issued asynchronously otherwise."""
        if device.type == "cpu":
            return _to(carry, device)
        return {k: v.to(device, non_blocking=True) if isinstance(v, torch.Tensor) else v
                for k, v in carry.items()}

    def __call__(self, x, timesteps, context=None, **kwargs):
        from ..ops.attention import sequence_ctx_key

        if sequence_ctx_key() is not None:
            # A stage holds one device; the context's attention holds a mesh. The
            # orchestrator runs batch 1 single-device under a context: reaching
            # here means the runner was called directly.
            raise ValueError(
                "pipeline block placement does not compose with an active "
                "sequence_parallel context; run the model through the "
                "orchestrator (which falls back to single-device) or exit "
                "the context"
            )
        lead = self.lead
        with torch.no_grad():
            carry = self._spec.prepare(self._prepare, _to(x, lead), _to(timesteps, lead),
                                       _to(context, lead), **_to(kwargs, lead))
            for stage in self.stages:
                carry = self._hop(carry, stage.device)
                for fn in stage.fns:
                    carry = fn(stage.module, carry)
            carry = self._hop(carry, lead)  # the last block's output returns to the lead
            return self._spec.finalize(self._finalize, carry, tuple(x.shape))


def build_pipeline_runner(spec: PipelineSpec | None, module: torch.nn.Module,
                          devices: Sequence[torch.device], weights: Sequence[float],
                          residents: Sequence[torch.nn.Module] = ()) -> PipelineRunner | None:
    """The batch==1 runner, or None when the model declares no spec (or one without
    segments) or the chain has a single device: the orchestrator then runs the call
    on the lead device, as the reference does when it finds no block list."""
    if spec is None or not spec.segments or len(devices) <= 1:
        return None
    return PipelineRunner(spec, module, devices, weights, residents=residents)
