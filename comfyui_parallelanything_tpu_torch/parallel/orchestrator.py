"""The orchestrator: wrap a diffusion model once, run every step over the chain.

Counterpart of ``comfyui_parallelanything_tpu/parallel/orchestrator.py`` for one
homogeneous group of devices (GPUs, or ``cpu``/``cpu:i`` links). ``parallelize``
places one replica of the model per device — a device that already holds the
module reuses it, so a one-GPU chain never copies the weights — and
``ParallelModel`` routes each call by the JAX package's hand ladder (its
``PA_PLANNER=0`` routing):

- ``batch == 1`` on more than one device → pipeline block placement (not ported
  yet; a model without a pipeline spec runs single-device);
- no ``workload_split``, one device, or ``batch < devices`` without
  ``pad_small_batches`` → single device (the lead replica);
- otherwise → data parallel: the batch is padded to a multiple of the device
  count by repeating its last row, one equal chunk runs on each replica, and the
  outputs are gathered on the lead device;
- ``torch.cuda.OutOfMemoryError`` during a step → drop the other replicas and
  run single-device from then on. Any other error propagates.

Not ported yet, each raising ``NotImplementedError`` that names its ROADMAP
item: the auto-parallel planner, heterogeneous chains, ``weight_sharding`` other
than ``"replicate"`` (fsdp, weight streaming), ``tensor_parallel > 1``,
``pipeline_microbatches``, and batch==1 pipeline placement.
"""

from __future__ import annotations

import copy
import dataclasses
import gc
import logging
import os
from collections.abc import Mapping, Sequence
from typing import Any

import torch

from ..devices.discovery import device_platform
from ..devices.memory import free_memory_bytes, total_memory_bytes
from .chain import DeviceChain, DeviceLink
from .split import (
    batch_size_of,
    blend_memory_weights,
    pad_leaf,
    slice_padded,
    tree_map,
    concat_results,
)

logger = logging.getLogger(__name__)

_TODO_PIPELINE = "batch==1 pipeline placement (ROADMAP Queue 1, Pipeline placement)"


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to PyTorch yet")


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """The orchestrator's knobs, as in the JAX package.

    ``workload_split``      — enable batch splitting / pipeline mode
    ``auto_memory_balance`` — blend user weights with free device memory
    ``purge_cache``         — return cached CUDA memory at teardown
    ``pad_small_batches``   — pad 1 < batch < devices up to the device count
        instead of running single-device
    ``weight_sharding``, ``tensor_parallel``, ``pipeline_microbatches``,
    ``hbm_budget_bytes`` — only their defaults are ported; other values raise
    ``NotImplementedError`` (``hbm_budget_bytes`` is the budget a replica must fit
    before weight streaming would take over).
    """

    workload_split: bool = True
    auto_memory_balance: bool = True
    purge_cache: bool = True
    pad_small_batches: bool = True
    weight_sharding: str = "replicate"
    tensor_parallel: int = 1
    pipeline_microbatches: int = 0
    hbm_budget_bytes: int | None = None


def _module_on(module: torch.nn.Module, device: torch.device) -> bool:
    return all(p.device == device for p in module.parameters())


def _place(module: torch.nn.Module, device: torch.device) -> torch.nn.Module:
    """The module itself when it already lives on ``device``, else a copy there."""
    if _module_on(module, device):
        return module
    return copy.deepcopy(module).to(device)


def _chunk_tree(v, batch: int, padded: int, n: int) -> list:
    """n per-device trees: every tensor leaf with dim0 == ``batch`` is padded to
    ``padded`` rows (repeating its last row) and cut in n equal chunks; every other
    leaf is shared by all n."""
    if isinstance(v, torch.Tensor) and v.ndim > 0 and v.shape[0] == batch:
        return list(pad_leaf(v, padded - batch).chunk(n))
    if isinstance(v, Mapping):
        per = {k: _chunk_tree(x, batch, padded, n) for k, x in v.items()}
        return [{k: c[i] for k, c in per.items()} for i in range(n)]
    if isinstance(v, (list, tuple)):
        per = [_chunk_tree(x, batch, padded, n) for x in v]
        return [type(v)(c[i] for c in per) for i in range(n)]
    return [v] * n


def _to(tree, device: torch.device):
    return tree_map(lambda l: l.to(device) if isinstance(l, torch.Tensor) else l, tree)


class ParallelModel:
    """The wrapped model: call it like the model's forward,
    ``model(x, timesteps, context=None, **kwargs)``, batch on dim0."""

    def __init__(self, module, chain: DeviceChain, config: ParallelConfig,
                 devices: list[torch.device], replicas: list[torch.nn.Module],
                 weights: tuple[float, ...], pipeline_spec: Any = None,
                 model_config: Any = None):
        self._module = module
        self.chain = chain
        self.config = config
        self._devices = devices
        self._replicas = replicas
        self.weights = weights
        self._pipeline_spec = pipeline_spec
        # The wrapped model's own config (FluxConfig, ...), distinct from ``config``.
        self.model_config = model_config
        self.active = True
        self._cleaned = False

    @property
    def devices(self) -> tuple[str, ...]:
        return self.chain.devices

    @property
    def lead_device(self) -> torch.device:
        return self._devices[0]

    @property
    def n_devices(self) -> int:
        return len(self._devices)

    def __call__(self, x, timesteps, context=None, **kwargs):
        if not self.active:
            return self.single(x, timesteps, context, **kwargs)
        batch = batch_size_of(x)
        n = self.n_devices
        try:
            if batch == 1 and self.config.workload_split and n > 1:
                if self._pipeline_spec is not None:
                    raise _not_ported(_TODO_PIPELINE)
                return self.single(x, timesteps, context, **kwargs)
            if not self.config.workload_split or n <= 1:
                return self.single(x, timesteps, context, **kwargs)
            if batch < n and not self.config.pad_small_batches:
                return self.single(x, timesteps, context, **kwargs)
            return self._data_parallel(batch, x, timesteps, context, kwargs)
        except torch.cuda.OutOfMemoryError as e:
            logger.warning("step-oom: %s; freeing replicas, demoting to single-device", e)
            self._demote()
            return self.single(x, timesteps, context, **kwargs)

    def single(self, x, timesteps, context=None, **kwargs):
        """The whole batch on the lead device's replica."""
        lead = self.lead_device
        if not self._replicas:  # after cleanup(): place the lead replica again
            self._replicas = [_place(self._module, lead)]
        module = self._replicas[0]
        with torch.no_grad():
            return module(_to(x, lead), _to(timesteps, lead), _to(context, lead),
                          **_to(kwargs, lead))

    def _data_parallel(self, batch, x, timesteps, context, kwargs):
        """The JAX ``_data_parallel``/``_dp_on_group`` pair for one homogeneous group:
        pad the batch to a multiple of the device count, run one equal chunk per
        replica (launches are asynchronous, so GPUs overlap), gather on the lead."""
        n = self.n_devices
        padded = batch + ((-batch) % n)
        xs, ts, cs, kws = (_chunk_tree(v, batch, padded, n)
                           for v in (x, timesteps, context, dict(kwargs)))
        outs = []
        with torch.no_grad():
            for dev, module, xi, ti, ci, ki in zip(self._devices, self._replicas, xs, ts, cs, kws):
                outs.append(module(_to(xi, dev), _to(ti, dev), _to(ci, dev), **_to(ki, dev)))
        out = concat_results([_to(o, self.lead_device) for o in outs])
        return slice_padded(out, batch, padded)

    def _demote(self) -> None:
        self.active = False
        self._replicas = self._replicas[:1]
        self._release()

    def _release(self) -> None:
        gc.collect()
        if self.config.purge_cache and torch.cuda.is_available():
            torch.cuda.empty_cache()

    def cleanup(self) -> None:
        """Teardown: drop the placed replicas (and the cached CUDA blocks when
        ``purge_cache``). Idempotent; a later call runs single-device again."""
        if self._cleaned:
            return
        self._cleaned = True
        self.active = False
        self._replicas = []
        self._release()
        logger.info("parallel teardown complete")


def _planner_requested() -> bool:
    return os.environ.get("PA_PLANNER", "").strip().lower() in ("1", "true", "on", "shadow")


def parallelize(model, chain: DeviceChain | Sequence[tuple[str, float]],
                config: ParallelConfig | None = None, *, pipeline_spec: Any = None,
                plan_hints=None) -> ParallelModel | Any:
    """Wrap ``model`` (a ``DiffusionModel``, or a ``ParallelModel`` to re-wrap) for
    execution over ``chain``. Returns ``model`` unchanged on an unusable chain
    (empty, or total percentage <= 0)."""
    config = config or ParallelConfig()
    if plan_hints is not None or _planner_requested():
        raise _not_ported("the auto-parallel planner (ROADMAP Queue 1, Planner)")
    if config.weight_sharding != "replicate":
        raise _not_ported(
            f"weight_sharding={config.weight_sharding!r} (ROADMAP Queue 1, "
            "Weight streaming / fsdp)"
        )
    if config.tensor_parallel > 1:
        raise _not_ported("tensor_parallel > 1 (ROADMAP Queue 1, fsdp / tp)")
    if config.pipeline_microbatches > 1:
        raise _not_ported("pipeline_microbatches (ROADMAP Queue 1, Pipeline placement)")
    if not isinstance(chain, DeviceChain):
        chain = DeviceChain.from_pairs(chain)
    if isinstance(model, ParallelModel):
        module, wrapped_config = model._module, model.model_config
        if pipeline_spec is None:
            pipeline_spec = model._pipeline_spec
        model.cleanup()
    else:
        module, wrapped_config = getattr(model, "module", model), getattr(model, "config", None)
        if not isinstance(module, torch.nn.Module):
            raise TypeError(f"model must be a DiffusionModel or an nn.Module, got {type(model).__name__}")
        if pipeline_spec is None:
            pipeline_spec = getattr(model, "pipeline_spec", None)

    chain = chain.validated().deduplicated()
    weights = chain.normalized_weights()
    if not chain or weights is None:
        logger.warning("unusable device chain; returning model unchanged")
        return model
    if not chain.is_homogeneous:
        raise _not_ported(
            f"a heterogeneous chain {chain.platforms} (ROADMAP Queue 1, Heterogeneous chains)"
        )
    devices = list(chain.torch_devices())
    if config.auto_memory_balance:
        weights = blend_memory_weights(weights, [free_memory_bytes(d) for d in devices])

    budget = config.hbm_budget_bytes or int(0.9 * total_memory_bytes(devices[0]))
    nbytes = sum(p.numel() * p.element_size() for p in module.parameters())
    if budget and nbytes > budget:
        raise _not_ported(
            f"weight streaming for {nbytes / 2**30:.2f} GiB of weights over a "
            f"{budget / 2**30:.2f} GiB budget (ROADMAP Queue 1, Weight streaming)"
        )

    replicas = [_place(module, d) for d in devices]
    chain = DeviceChain(tuple(DeviceLink(s, w * 100.0) for s, w in zip(chain.devices, weights)))
    logger.info("parallel setup: %s (%s)", chain.devices, device_platform(chain.devices[0]))
    return ParallelModel(module, chain, config, devices, replicas, weights,
                         pipeline_spec=pipeline_spec, model_config=wrapped_config)
