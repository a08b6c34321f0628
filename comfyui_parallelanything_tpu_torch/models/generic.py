"""Wrap-anything genericity: pipeline specs for models the port has never seen
(counterpart of ``comfyui_parallelanything_tpu/models/generic.py``).

The reference wraps any torch module and discovers its pipeline block lists by
name, ``['double_blocks', 'single_blocks', 'transformer_blocks', 'layers']``
(any_device_parallel.py:1156), falling back to plain data parallelism when none is
found. The port's model zoo declares hand-written ``PipelineSpec``s; this module
serves a user's own ``nn.Module``:

- ``derive_pipeline_spec(module)`` — a spec derived from a module that keeps its
  blocks in ``nn.ModuleList``s under one of those names, each block ``carry ->
  carry``, and has ``prepare(x, t, context=None, **kw) -> carry`` and
  ``finalize(carry, out_shape)`` methods (the non-block layers, which run on the
  lead device).
- ``wrap_module(module)`` — one call from such a module to a ``DiffusionModel``
  that ``parallelize`` takes, the spec derived where the module follows the
  convention. It is the JAX package's ``wrap_flax_module`` for an ``nn.Module``,
  whose parameters live in the module rather than beside it.
"""

from __future__ import annotations

from typing import Any

from torch import nn

from .api import DiffusionModel, PipelineSegment, PipelineSpec

# The reference's discovery list, in its walk order (1156).
BLOCK_LIST_NAMES = ("double_blocks", "single_blocks", "transformer_blocks", "layers")


def _block_groups(module: nn.Module) -> list[tuple[str, int]]:
    """(list name, count) for every reference-named, non-empty ``nn.ModuleList``
    child of ``module``, in the discovery order."""
    return [(name, len(getattr(module, name))) for name in BLOCK_LIST_NAMES
            if isinstance(getattr(module, name, None), nn.ModuleList)
            and len(getattr(module, name))]


def derive_pipeline_spec(module: nn.Module) -> PipelineSpec | None:
    """A batch==1 pipeline decomposition of ``module``, or None where it does not
    follow the convention (the model still runs data-parallel, the reference's own
    fallback when no known block list is found)."""
    if not (isinstance(module, nn.Module) and callable(getattr(module, "prepare", None))
            and callable(getattr(module, "finalize", None))):
        return None
    groups = _block_groups(module)
    if not groups:
        return None

    def make_seg(name: str, i: int):
        return lambda m, carry: getattr(m, name)[i](carry)

    segments = tuple(PipelineSegment((f"{name}.{i}",), make_seg(name, i), f"{name}[{i}]")
                     for name, count in groups for i in range(count))
    lists = {name for name, _ in groups}
    # prepare and finalize both run on the lead device: the non-block children
    # serve both.
    rest = tuple(name for name, _ in module.named_children() if name not in lists)
    return PipelineSpec(
        prepare_keys=rest,
        prepare=lambda m, x, t, context=None, **kw: m.prepare(x, t, context, **kw),
        segments=segments,
        finalize_keys=rest,
        finalize=lambda m, carry, out_shape: m.finalize(carry, out_shape),
    )


def wrap_module(module: nn.Module, name: str = "model", config: Any = None) -> DiffusionModel:
    """A user's ``nn.Module`` with the diffusion forward ``forward(x, timesteps,
    context=None, **kwargs)`` as an orchestrator-ready ``DiffusionModel``: the
    batch==1 pipeline spec derived where the module follows the block-list
    convention, else None (data parallel only)."""
    return DiffusionModel(module=module, name=name, config=config,
                          block_lists=dict(_block_groups(module)) or None,
                          pipeline_spec=derive_pipeline_spec(module))
