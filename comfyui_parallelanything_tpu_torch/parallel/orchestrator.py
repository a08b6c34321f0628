"""The orchestrator: wrap a diffusion model once, run every step over the chain.

Counterpart of ``comfyui_parallelanything_tpu/parallel/orchestrator.py``.
``parallelize`` groups the chain's consecutive links by platform (GPUs, or the
host's ``cpu``/``cpu:i`` links) and places one replica of the model per device — a
device that already holds the module reuses it, so a one-GPU chain never copies
the weights. ``ParallelModel`` routes each call by the JAX package's hand ladder
(its ``PA_PLANNER=0`` routing):

- ``pipeline_microbatches = k > 1`` and ``batch >= k`` on more than one device,
  for a model with a pipeline spec → the batch padded to k equal microbatches,
  each run through the pipeline runner, the padding sliced off;
- ``batch == 1`` on more than one device → pipeline block placement
  (``parallel/pipeline.py``, built on the first such call over every device in
  chain order with the chain's blended weights); a model without a pipeline spec
  runs single-device;
- no ``workload_split``, one device, or ``batch < devices`` without
  ``pad_small_batches`` → single device (the lead replica);
- otherwise → data parallel. Within a platform group the batch is padded to a
  multiple of the group's device count by repeating its last row and one equal
  chunk runs on each replica. A heterogeneous chain (``cuda:0`` + ``cpu``) first
  scatters the batch over its groups by their weights (largest remainder; a group
  whose share is 0 sits the call out); every group's inputs reach its devices
  before any forward is issued, the GPU groups' forwards are issued before the
  host computes its share, and the outputs are gathered on the lead device in
  chain order;
- an out-of-memory error during a step (``is_out_of_memory``: a CUDA OOM, or the
  host allocator's failure on a ``cpu`` link) → drop every replica but the lead
  and run single-device until ``reactivate()``/``rebalance()``, or for
  ``reactivate_after`` steps. Any other error propagates.

Set-up as in the JAX package: the user's weights are blended with free device
memory (``auto_memory_balance``) and then with each device's nominal step time
from the roofline platform specs (``auto_speed_balance``; a no-op on a chain of
equal devices), 0.7 user to 0.3 measure each time. An OOM while placing a replica
drops the last device of the last group, then that group, then raises; the
survivors' weights are renormalised.

``traceable()`` is the whole-loop compiled sampler's handle
(``sampling/compiled.py``): ``None`` for a heterogeneous chain, whose host-side
scatter cannot live in one captured graph. A homogeneous chain's captured loop
runs data parallel at every batch, batch 1 included, as the JAX ``traceable()``
gives it; a chain with a host stage runs the eager loop, which takes the pipeline.

Not ported yet, each raising ``NotImplementedError`` that names its ROADMAP
item: the auto-parallel planner (so the stage carve is always the
weight-proportional one), ``weight_sharding`` other than ``"replicate"`` (fsdp,
weight streaming) and ``tensor_parallel > 1``.
"""

from __future__ import annotations

import copy
import dataclasses
import gc
import itertools
import logging
import os
from collections.abc import Mapping, Sequence
from typing import Any

import torch

from ..devices.discovery import device_kind, device_platform
from ..devices.memory import free_memory_bytes, usable_hbm_bytes
from ..utils import roofline
from .chain import DeviceChain, DeviceLink
from .split import (
    batch_size_of,
    blend_memory_weights,
    blend_speed_weights,
    concat_results,
    largest_remainder_split,
    normalize_weights,
    pad_leaf,
    slice_padded,
    split_kwargs,
    split_tree,
    tree_map,
)

logger = logging.getLogger(__name__)

# The host allocator's message for a failed allocation: torch raises it as a plain
# RuntimeError, not as torch.cuda.OutOfMemoryError.
HOST_OOM_MESSAGE = "DefaultCPUAllocator: can't allocate memory"


def is_out_of_memory(err: BaseException) -> bool:
    """True for an out-of-memory error on any device of a chain: a CUDA OOM, or the
    CPU allocator's ``RuntimeError`` (counterpart of the JAX package's
    ``_is_resource_exhausted``, which tests the message on every platform). Any
    other ``RuntimeError`` is not one."""
    if isinstance(err, torch.cuda.OutOfMemoryError):
        return True
    return isinstance(err, RuntimeError) and HOST_OOM_MESSAGE in str(err)


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to PyTorch yet")


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """The orchestrator's knobs, as in the JAX package.

    ``workload_split``      — enable batch splitting / pipeline mode
    ``auto_memory_balance`` — blend user weights with free device memory
    ``auto_speed_balance``  — blend them with each device's nominal step time
        (``utils/roofline.py``), so a GPU + CPU chain gives the CPU the share its
        speed earns; a no-op on a chain of equal devices
    ``purge_cache``         — return cached CUDA memory at teardown
    ``pad_small_batches``   — pad 1 < batch < devices up to the device count
        instead of running single-device
    ``reactivate_after``    — after a step-OOM demotion, try the parallel path
        again once this many single-device steps have run (None: stay demoted
        until ``reactivate()`` or ``rebalance()``)
    ``pipeline_microbatches`` — k > 1 streams a batch >= k through the pipeline
        stages as k microbatches (0 or 1: off)
    ``weight_sharding``, ``tensor_parallel``, ``hbm_budget_bytes`` — only their
    defaults are ported; other values raise ``NotImplementedError``
    (``hbm_budget_bytes`` is the budget a replica must fit before weight streaming
    would take over; None reads ``devices.memory.usable_hbm_bytes``).
    """

    workload_split: bool = True
    auto_memory_balance: bool = True
    auto_speed_balance: bool = True
    purge_cache: bool = True
    pad_small_batches: bool = True
    reactivate_after: int | None = None
    weight_sharding: str = "replicate"
    tensor_parallel: int = 1
    pipeline_microbatches: int = 0
    hbm_budget_bytes: int | None = None


@dataclasses.dataclass
class _PlatformGroup:
    """Consecutive chain links on one platform, with one replica per device.

    ``device_strs``, ``device_weights`` and ``user_weights`` (the pre-blend
    weights ``rebalance`` re-blends from) stay index-aligned with ``devices``, so
    dropping a device on a placement OOM also drops its share. ``replicas`` holds
    the placed replicas of the first ``len(replicas)`` devices."""

    platform: str
    devices: list[torch.device]
    device_strs: list[str]
    device_weights: list[float]
    user_weights: list[float] = dataclasses.field(default_factory=list)
    replicas: list[torch.nn.Module] = dataclasses.field(default_factory=list)

    @property
    def weight(self) -> float:
        return float(sum(self.device_weights))

    def drop_last_device(self) -> str:
        self.devices.pop()
        self.device_weights.pop()
        if self.user_weights:
            self.user_weights.pop()
        del self.replicas[len(self.devices):]
        return self.device_strs.pop()

    def place(self, module: torch.nn.Module) -> None:
        """Place a replica on every device of the group that has none yet."""
        while len(self.replicas) < len(self.devices):
            self.replicas.append(_place(module, self.devices[len(self.replicas)]))


def _module_on(module: torch.nn.Module, device: torch.device) -> bool:
    return all(p.device == device for p in module.parameters())


def _place(module: torch.nn.Module, device: torch.device) -> torch.nn.Module:
    """The module itself when it already lives on ``device``, else a copy there.
    The copy's tensors are made on ``device`` directly, so a GPU-resident module
    is never duplicated on its own GPU on its way to the host."""
    if _module_on(module, device):
        return module
    memo: dict[int, Any] = {}
    for p in module.parameters():
        memo[id(p)] = torch.nn.Parameter(p.detach().to(device), requires_grad=p.requires_grad)
    for b in module.buffers():
        memo[id(b)] = b.detach().to(device)
    return copy.deepcopy(module, memo)


def _device_step_times(devices: Sequence[torch.device]) -> list[float]:
    """Each device's nominal step time from the roofline platform specs, the speed
    signal ``blend_speed_weights`` folds into the weights. Reads static tables
    only: no device work."""
    return [roofline.nominal_step_time_s(device_kind(d), d.type) for d in devices]


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


def _split_inputs(batch, sizes, x, timesteps, context, kwargs) -> list[tuple]:
    """Per-group (x, timesteps, context, kwargs): a value splits on dim0 by
    ``sizes`` when it carries the batch, else every group gets it whole."""
    n = len(sizes)
    xs = split_tree(x, sizes)
    ts = split_tree(timesteps, sizes) if batch_size_of(timesteps) == batch else [timesteps] * n
    cs = (split_tree(context, sizes)
          if context is not None and batch_size_of(context) == batch else [context] * n)
    return list(zip(xs, ts, cs, split_kwargs(kwargs, batch, sizes)))


def _to(tree, device: torch.device):
    return tree_map(lambda l: l.to(device) if isinstance(l, torch.Tensor) else l, tree)


def _release_memory(purge_cache: bool) -> None:
    gc.collect()
    if purge_cache and torch.cuda.is_available():
        torch.cuda.empty_cache()


class ParallelModel:
    """The wrapped model: call it like the model's forward,
    ``model(x, timesteps, context=None, **kwargs)``, batch on dim0."""

    def __init__(self, module, chain: DeviceChain, config: ParallelConfig,
                 groups: list[_PlatformGroup], weights: tuple[float, ...],
                 pipeline_spec: Any = None, model_config: Any = None,
                 sampler_prefs: dict | None = None):
        self._module = module
        self.chain = chain
        self.config = config
        self._groups = groups
        self.weights = weights
        self._pipeline_spec = pipeline_spec
        self._pipeline_runner = None  # built on the first pipeline call
        # The wrapped model's own config (FluxConfig, ...), distinct from ``config``.
        self.model_config = model_config
        # The wrapped model's sampling defaults (patch nodes), read by the samplers.
        self.sampler_prefs = sampler_prefs
        self.active = True
        self._demoted = False  # inactive after a step-OOM (reactivatable)
        self._steps_demoted = 0  # single-device steps since the demotion
        self._cleaned = False  # inactive after cleanup() (terminal)

    @property
    def devices(self) -> tuple[str, ...]:
        return tuple(s for g in self._groups for s in g.device_strs)

    @property
    def lead_device(self) -> torch.device:
        return self._groups[0].devices[0]

    @property
    def n_devices(self) -> int:
        return sum(len(g.devices) for g in self._groups)

    @property
    def _replicas(self) -> list[torch.nn.Module]:
        """Every placed replica, in chain order."""
        return [r for g in self._groups for r in g.replicas]

    def __call__(self, x, timesteps, context=None, **kwargs):
        if not self.active:
            ra = self.config.reactivate_after
            if self._demoted and not self._cleaned and ra is not None \
                    and self._steps_demoted >= ra:
                ran = self._steps_demoted
                try:
                    self.reactivate()
                    logger.warning("reactivate: parallel execution resumed after %d "
                                   "single-device step(s)", ran)
                except Exception as e:
                    if not is_out_of_memory(e):
                        raise
                    self._steps_demoted = 0  # still too tight: retry in another N
            if not self.active:
                self._steps_demoted += 1
                return self.single(x, timesteps, context, **kwargs)
        batch = batch_size_of(x)
        n = self.n_devices
        try:
            mb = self.config.pipeline_microbatches
            if mb > 1 and self.config.workload_split and batch >= mb and n > 1:
                runner = self._get_pipeline_runner()
                if runner is not None:
                    return self._pipeline_microbatch(runner, mb, batch, x, timesteps,
                                                     context, kwargs)
            if batch == 1 and self.config.workload_split and n > 1:
                # Pipeline block placement (reference 1295-1305); a model with no
                # stages runs single-device (1156-1166).
                runner = self._get_pipeline_runner()
                if runner is not None:
                    return runner(x, timesteps, context, **kwargs)
                return self.single(x, timesteps, context, **kwargs)
            if not self.config.workload_split or n <= 1:
                return self.single(x, timesteps, context, **kwargs)
            if batch < n and not self.config.pad_small_batches:
                return self.single(x, timesteps, context, **kwargs)
            return self._data_parallel(batch, x, timesteps, context, kwargs)
        except Exception as e:
            if not is_out_of_memory(e):
                raise
            logger.warning("step-oom: %s; freeing replicas, demoting to single-device", e)
            self._demote()
            return self.single(x, timesteps, context, **kwargs)

    def _lead_replica(self) -> torch.nn.Module:
        """The lead device's replica, placed again after ``cleanup()``."""
        g = self._groups[0]
        if not g.replicas:
            g.replicas.append(_place(self._module, g.devices[0]))
        return g.replicas[0]

    def single(self, x, timesteps, context=None, **kwargs):
        """The whole batch on the lead device's replica."""
        lead = self.lead_device
        module = self._lead_replica()
        with torch.no_grad():
            return module(_to(x, lead), _to(timesteps, lead), _to(context, lead),
                          **_to(kwargs, lead))

    @staticmethod
    def _shard(g: _PlatformGroup, batch, x, timesteps, context, kwargs):
        """One group's share, padded to a multiple of its device count and cut into
        one equal chunk per replica, each already on its device. Returns the
        per-replica (module, x, t, context, kwargs) and the padded size."""
        n = len(g.devices)
        padded = batch + ((-batch) % n)
        xs, ts, cs, kws = (_chunk_tree(v, batch, padded, n)
                           for v in (x, timesteps, context, dict(kwargs)))
        work = [(m, _to(xi, d), _to(ti, d), _to(ci, d), _to(ki, d))
                for d, m, xi, ti, ci, ki in zip(g.devices, g.replicas, xs, ts, cs, kws)]
        return work, padded

    def _data_parallel(self, batch, x, timesteps, context, kwargs):
        """The JAX ``_data_parallel``/``_dp_on_group`` pair: one group takes the
        whole batch; several take weighted shares (sizes by largest remainder)."""
        if len(self._groups) == 1:
            parts = [(self._groups[0], batch, x, timesteps, context, kwargs)]
        else:
            gweights = normalize_weights([g.weight for g in self._groups])
            sizes = largest_remainder_split(batch, gweights)
            parts = [(g, size, *chunk) for g, size, chunk in zip(
                self._groups, sizes, _split_inputs(batch, sizes, x, timesteps, context, kwargs))
                if size]
        shards = [self._shard(*part) for part in parts]
        # GPU launches return at once, so issuing the GPU groups first lets the host
        # compute its share while the cards run theirs.
        order = sorted(range(len(parts)), key=lambda i: parts[i][0].platform == "cpu")
        outs: list[Any] = [None] * len(parts)
        lead = self.lead_device
        with torch.no_grad():
            for i in order:
                work, padded = shards[i]
                out = concat_results([_to(m(xi, ti, ci, **ki), lead)
                                      for m, xi, ti, ci, ki in work])
                outs[i] = slice_padded(out, parts[i][1], padded)
        return outs[0] if len(outs) == 1 else concat_results(outs)

    def _pipeline_microbatch(self, runner, mb, batch, x, timesteps, context, kwargs):
        """The batch through the stage chain as ``mb`` microbatches of one shape:
        padded to ``mb * ceil(batch / mb)`` rows (repeating the last row), split
        evenly, the padding sliced off the concatenated output."""
        padded = -(-batch // mb) * mb
        chunks = zip(*(_chunk_tree(v, batch, padded, mb)
                       for v in (x, timesteps, context, dict(kwargs))))
        outs = [runner(xi, ti, ci, **ki) for xi, ti, ci, ki in chunks]
        return slice_padded(concat_results(outs), batch, padded)

    def _get_pipeline_runner(self):
        """Build the stage-placement runner on the first pipeline call, over every
        device in chain order with the chain's weights (the planner's byte-balanced
        carve is not ported). A stage reuses what the placed
        replicas already hold on its device. A model that cannot pipeline is
        remembered, so later calls do not retry."""
        if self._pipeline_runner is None and self._pipeline_spec is not None:
            from .pipeline import build_pipeline_runner

            devices = [d for g in self._groups for d in g.devices]
            self._pipeline_runner = build_pipeline_runner(
                self._pipeline_spec, self._module, devices, list(self.weights),
                residents=self._replicas)
            if self._pipeline_runner is None:
                self._pipeline_spec = None
        return self._pipeline_runner

    # -- whole-loop compilation handle (sampling/compiled.py) ---------------------

    def traceable(self):
        """A ``TraceSpec`` for the whole-loop compiled sampler, or None for a
        heterogeneous chain (its host-side scatter cannot live in one captured
        graph). An active data-parallel group gives every replica; a single device,
        or a demoted chain, the lead replica. The captured loop calls the replicas
        directly and so gives up step-OOM demotion."""
        from ..sampling.compiled import TraceSpec

        if len(self._groups) != 1:
            return None
        g = self._groups[0]
        if self.active and self.config.workload_split and len(g.devices) > 1 \
                and len(g.replicas) == len(g.devices):
            return TraceSpec(tuple(g.replicas), tuple(g.devices))
        return TraceSpec((self._lead_replica(),), (self.lead_device,))

    # -- degradation ---------------------------------------------------------------

    def _demote(self) -> None:
        from ..sampling.compiled import clear_compiled_loops

        self.active = False
        self._demoted = True
        self._steps_demoted = 0
        self._pipeline_runner = None
        lead = self._groups[0].replicas[:1]
        for g in self._groups:
            g.replicas = []
        self._groups[0].replicas = lead
        clear_compiled_loops()  # the captured loops hold the dropped replicas
        _release_memory(self.config.purge_cache)

    def reactivate(self) -> None:
        """Place the replicas again and resume parallel execution after a
        demotion. Called by hand, by ``rebalance()``, or after
        ``config.reactivate_after`` single-device steps. All or nothing: a
        placement failure drops the replicas this attempt placed, then raises."""
        self._steps_demoted = 0
        before = [len(g.replicas) for g in self._groups]
        try:
            for g in self._groups:
                g.place(self._module)
        except Exception:
            for g, n in zip(self._groups, before):
                del g.replicas[n:]
            raise
        self.active = True
        self._demoted = False

    def rebalance(self) -> tuple[float, ...]:
        """Re-read free device memory and re-blend the weights from the user's
        original ones (a second call with the same readings is a fixed point), with
        the speed blend on top; returns the new normalised weights. On a demoted
        chain it first tries ``reactivate()``. A no-op when both balances are off."""
        if self._demoted and not self._cleaned:
            try:
                self.reactivate()
            except Exception as e:
                if not is_out_of_memory(e):
                    raise
        if not self.config.auto_memory_balance and not self.config.auto_speed_balance:
            return self.weights
        base = normalize_weights([w for g in self._groups for w in g.user_weights])
        if base is None:
            return self.weights
        devs = [d for g in self._groups for d in g.devices]
        new = base
        if self.config.auto_memory_balance:
            new = blend_memory_weights(new, [free_memory_bytes(d) for d in devs])
        if self.config.auto_speed_balance:
            new = blend_speed_weights(new, _device_step_times(devs))
        it = iter(new)
        for g in self._groups:
            g.device_weights = [next(it) for _ in g.device_weights]
        self.weights = tuple(new)
        self._pipeline_runner = None  # stage ranges follow the weights: rebuild lazily
        return self.weights

    def cleanup(self) -> None:
        """Teardown: drop the placed replicas and every captured sampler loop (they
        hold replicas), and the cached CUDA blocks when ``purge_cache``. Idempotent;
        a later call runs single-device again."""
        from ..sampling.compiled import clear_compiled_loops

        if self._cleaned:
            return
        self._cleaned = True
        self.active = False
        for g in self._groups:
            g.replicas = []
        self._pipeline_runner = None
        clear_compiled_loops()
        _release_memory(self.config.purge_cache)
        logger.info("parallel teardown complete")


def _planner_requested() -> bool:
    return os.environ.get("PA_PLANNER", "").strip().lower() in ("1", "true", "on", "shadow")


def _group_links(chain: DeviceChain, devices, weights, user_weights) -> list[_PlatformGroup]:
    """Consecutive links on one platform form one group."""
    groups: list[_PlatformGroup] = []
    for plat, links in itertools.groupby(
            zip(chain.devices, devices, weights, user_weights),
            key=lambda link: device_platform(link[0])):
        strs, devs, ws, uws = (list(c) for c in zip(*links))
        groups.append(_PlatformGroup(plat, devs, strs, ws, uws))
    return groups


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
    if not isinstance(chain, DeviceChain):
        chain = DeviceChain.from_pairs(chain)
    # Patch nodes come before ParallelAnything (stock's order): their sampling
    # defaults survive the wrap.
    sampler_prefs = getattr(model, "sampler_prefs", None)
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
    devices = list(chain.torch_devices())
    user_weights = weights
    if config.auto_memory_balance:
        weights = blend_memory_weights(weights, [free_memory_bytes(d) for d in devices])
    if config.auto_speed_balance:
        weights = blend_speed_weights(weights, _device_step_times(devices))
    groups = _group_links(chain, devices, weights, user_weights)

    budget = config.hbm_budget_bytes or usable_hbm_bytes(devices[0])
    nbytes = sum(p.numel() * p.element_size() for p in module.parameters())
    if budget and nbytes > budget:
        raise _not_ported(
            f"weight streaming for {nbytes / 2**30:.2f} GiB of weights over a "
            f"{budget / 2**30:.2f} GiB budget (ROADMAP Queue 1, Weight streaming)"
        )

    while True:
        try:
            for g in groups:
                g.place(module)
            break
        except Exception as e:
            if not is_out_of_memory(e):
                raise
            g = groups[-1]
            if len(g.devices) > 1:
                logger.warning("setup-oom: dropped %s, retrying", g.drop_last_device())
            elif len(groups) > 1:
                groups.pop()
                logger.warning("setup-oom: dropped platform group %s, retrying", g.platform)
            else:
                raise
            _release_memory(True)

    # The chain and the weights describe the survivors, renormalised.
    surviving = [(s, w) for g in groups for s, w in zip(g.device_strs, g.device_weights)]
    final = normalize_weights([w for _, w in surviving])
    chain = DeviceChain(tuple(DeviceLink(s, w * 100.0) for (s, _), w in zip(surviving, final)))
    logger.info("parallel setup: %s (%s)", chain.devices,
                "hybrid" if len(groups) > 1 else groups[0].platform)
    return ParallelModel(module, chain, config, groups, final,
                         pipeline_spec=pipeline_spec, model_config=wrapped_config,
                         sampler_prefs=sampler_prefs)


def model_config_of(model) -> Any:
    """The wrapped model's own config (``UNetConfig``, ``FluxConfig``, ...), whether
    ``model`` is a ``DiffusionModel`` or a ``ParallelModel`` (whose ``config`` is the
    ``ParallelConfig`` and whose ``model_config`` is the model's)."""
    cfg = getattr(model, "model_config", None)
    return cfg if cfg is not None else getattr(model, "config", None)
