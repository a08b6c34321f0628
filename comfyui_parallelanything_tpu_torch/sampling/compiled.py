"""Whole-loop compiled sampling: the entire denoise loop captured once as a CUDA
graph and replayed (counterpart of ``comfyui_parallelanything_tpu/sampling/compiled.py``).

The eager samplers re-enter Python for every step: a SDXL step issues a few
thousand kernels from the host, and the device waits on it. Here
``run_sampler(..., compile_loop=True)`` runs the eager sampler itself (the same
``k_samplers.SAMPLERS``/``FLOW_VARIANTS`` step functions, ``ddim_sample``,
``flow_euler_sample``; schedule walk, CFG batching, model forwards, latent updates
and the inpaint mask blend) once under ``torch.cuda.graph`` and then replays the
recorded kernels, so captured and eager compute the same thing by construction.
Where the JAX package scans one XLA program, this module records one CUDA graph.

- **What is baked in.** The samplers read the schedule as 0-d CPU tensors and
  branch on it, and the lms / UniPC coefficients come from numpy: their values
  are part of the graph, so the schedule's bytes key the cache. So do the kind,
  the sampler, the replicas, every input's shape, dtype and device, which optional
  inputs are present, ``cfg_scale``, ``cfg_rescale``, the prediction, guidance,
  the non-tensor kwargs, the attention backend and the TF32 switches.
- **What is read on every replay.** Static buffers hold x, the contexts, the
  tensor kwargs, the mask, the kept init and noise, and the per-step noise; a call
  copies its inputs in, replays, and clones the output out. The buffers are the
  graph's own allocations and never alias the caller's noise or mask references.
- **Noise.** Every step's draw is made before the loop with
  ``k_samplers.step_noise`` (the counterpart of JAX's ``step_keys``) into one
  table, which the samplers read through ``k_samplers.noise_table``; so captured
  noise equals eager noise, per step and seed.
- **Capture.** A first call warms up on the device's side stream (the loop body
  with one real model forward, reused for every step, so cuBLAS/cuDNN workspaces,
  K1's library and its first attribute calls happen outside the capture), then
  captures the loop under ``torch.no_grad()`` on that stream, then replays.
  K1's launch counters are Python and count at capture: each cached loop records
  K1's launches by variant taken during its capture, and its replays
  (``loop_records``): a replay repeats the captured launches.
- **Data parallel.** A graph belongs to one device: a spec with several replicas
  pads the batch to a multiple of their count once, at loop entry (``_prep``),
  captures one graph per replica over its share and gathers the outputs on the
  lead device. Nothing crosses devices inside the loop: every step is per sample.
- **Capture failure: the compile-eager rung.** A loop whose capture breaks (a
  host read of a device value, a pageable host copy, a generator made inside the
  loop) raises ``CaptureError`` naming the sampler and the line whose operation
  broke it (``_culprit``). The runner records the ``compile-eager`` rung
  (``utils/degrade.py``) and runs the eager loop for that call, as the JAX
  runner's ``_compile_eager_rung`` does for a compile failure. The failed loop
  leaves the cache; the allocator stops placing the capture stream's allocations in
  the broken graph's private pool and releases that pool (``_abandon``: a capture
  that broke before it ended leaves both undone, and every later capture on the
  stream would fill the dead pool); the device is synchronised before the eager run
  so it starts on a clean stream.
  An out-of-memory error during capture or replay is not a capture failure and
  raises (like the JAX program, the loop gives up step-OOM demotion); neither is a
  kernel that fails to build, load or launch (``KernelError``), which raises as it
  is. The eager loop is also taken where the runner decides before the loop, from
  the caller's inputs: a user callback, combined conditioning, a weight-streaming
  model (whose ``traceable()`` is None), a heterogeneous chain.
- **On the CPU** (tensors on the host, as in the tests) the same loop body runs
  without capture, as JAX runs its scan on the CPU backend.

The cache holds at most ``_LOOP_CACHE_MAX`` loops and keeps their replicas alive;
``clear_compiled_loops`` (reached from ``ParallelModel.cleanup()``) drops them and
their graphs' memory pools.

The other half of the module is the serving layer's per-lane step
(``lane_step_program``): ONE batched model eval that advances a fixed-width batch
of lanes, each at its own sigma in its own schedule with its own sampler, the unit
``serving/bucket.py`` dispatches. It runs eager, so it has no capture to fail:
the JAX scheduler's ``compile-eager`` branch for its lane program has no
counterpart here. Capturing it per bucket as a CUDA graph is a later
optimisation (ROADMAP, held for the perf queues).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import threading
import time
import traceback
from collections.abc import Mapping
from typing import Any, Callable

import torch

from ..parallel.split import concat_results, pad_leaf, partition_kwargs, slice_padded
from ..parallel.split import static_kwargs_key, tree_map
from . import k_samplers
from .cfg import rescale_guidance
from .ddim import ddim_sample
from .flow import flow_euler_sample


class CaptureError(RuntimeError):
    """A loop's CUDA-graph capture broke; the message names the sampler, the device
    and the line whose operation broke it. ``run_sampler`` falls back to the eager
    loop for the call (the ``compile-eager`` rung)."""

__all__ = [
    "CaptureError",
    "TraceSpec",
    "trace_spec_of",
    "clear_compiled_loops",
    "compiled_k_sample",
    "compiled_ddim_sample",
    "compiled_flow_sample",
    "lane_step_program",
    "loop_records",
]


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """A model reduced to what a captured loop needs: the forward of each replica,
    ``(x, t, context, **kwargs)``, and the device it runs on (None: the input's).
    The first replica is the lead; several shard the batch evenly over them, as
    the JAX spec's mesh does."""

    replicas: tuple[Callable[..., Any], ...]
    devices: tuple[torch.device | None, ...]


def trace_spec_of(model) -> TraceSpec | None:
    """A TraceSpec for ``model``, or None when it cannot run as one captured loop.
    A ``ParallelModel`` answers through ``traceable()`` (None for a heterogeneous
    chain); a ``DiffusionModel`` or ``nn.Module`` runs on its parameters' device; a
    bare callable on the input's device, and is assumed capturable, the documented
    contract of ``compile_loop=True``."""
    traceable = getattr(model, "traceable", None)
    if callable(traceable):
        return traceable()
    module = getattr(model, "module", model)
    if isinstance(module, torch.nn.Module):
        return TraceSpec((module,), (next((p.device for p in module.parameters()), None),))
    if callable(model):
        return TraceSpec((model,), (None,))
    return None


# ---------------------------------------------------------------------------
# placement: pad the batch to the replica count and shard it, once at loop entry
# (the orchestrator does the same per step)
# ---------------------------------------------------------------------------


def _place_batch(tree, batch: int, padded: int, devices) -> list:
    """One tree per replica: every tensor leaf with dim0 == ``batch`` padded to
    ``padded`` rows (repeating the last) and cut into one equal chunk per replica,
    every other tensor leaf whole; each on its replica's device."""
    n = len(devices)
    if isinstance(tree, torch.Tensor):
        parts = (pad_leaf(tree, padded - batch).chunk(n)
                 if tree.ndim and tree.shape[0] == batch else [tree] * n)
        return [p if d is None else p.to(d) for p, d in zip(parts, devices)]
    if isinstance(tree, Mapping):
        per = {k: _place_batch(v, batch, padded, devices) for k, v in tree.items()}
        return [{k: v[i] for k, v in per.items()} for i in range(n)]
    if isinstance(tree, (list, tuple)):
        per = [_place_batch(v, batch, padded, devices) for v in tree]
        return [type(tree)(p[i] for p in per) for i in range(n)]
    return [tree] * n


def _prep(spec: TraceSpec, batch: int, inputs: dict) -> tuple[list, int]:
    """Pad the batch to the replica count and place every input; returns the
    per-replica input trees and the padded size."""
    n = len(spec.replicas)
    padded = batch + ((-batch) % n)
    return _place_batch(inputs, batch, padded, spec.devices), padded


def _mask_blend(x, mask, keep):
    return x * mask + keep * (1.0 - mask)


def _post_from(mask, keep_at):
    """The inpaint step hook: re-pin the keep region to ``keep_at(i)`` after step
    i, as the eager runner's mask callback does; None without a mask."""
    if mask is None:
        return None
    return lambda i, x: _mask_blend(x, mask, keep_at(i))


def _draw_noise(rng, steps: int, parts: int, x: torch.Tensor) -> torch.Tensor:
    """Every step's ``step_noise`` draw, batch first: (B, steps, parts, *rest)."""
    return torch.stack([torch.stack([k_samplers.step_noise(rng, i, x.shape, x, part)
                                     for part in range(parts)], dim=1)
                        for i in range(steps)], dim=1)


def _noise_of(t: dict):
    """The loop's noise table as the samplers index it, (steps, parts, B, *rest)."""
    return None if t["noise"] is None else t["noise"].movedim(0, 2)


# ---------------------------------------------------------------------------
# the cache of captured loops
# ---------------------------------------------------------------------------

_loops: "collections.OrderedDict[tuple, _Loop]" = collections.OrderedDict()
# Each entry holds its replicas and a graph's memory pool; the oldest goes first.
_LOOP_CACHE_MAX = 32
# One side stream per device for every warm-up and capture: libraries keep
# per-stream state (cuBLAS a workspace per stream, never freed), so a new stream
# per capture would leave that memory behind for each loop ever captured.
_side_streams: dict[torch.device, torch.cuda.Stream] = {}


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    if device not in _side_streams:
        _side_streams[device] = torch.cuda.Stream(device)
    return _side_streams[device]


# Captures run one at a time: every warm-up and capture on a device shares its
# side stream.
_capture_lock = threading.Lock()


@contextlib.contextmanager
def _capture_guard():
    """Hold for a loop's warm-up and capture: one capture at a time, and no
    serving dispatch meanwhile. With a scheduler installed (``server.py`` with
    several workers) a ``compile_loop=True`` prompt captures on its worker thread
    while the dispatcher thread runs lanes; the guard takes the scheduler's
    dispatch lock, so the capture waits for the round in flight and the next
    waits for the capture. Replays need neither."""
    from ..serving.scheduler import get_scheduler

    sched = get_scheduler()
    with _capture_lock, (sched.dispatch_lock if sched is not None
                         else contextlib.nullcontext()):
        yield


def clear_compiled_loops() -> None:
    """Drop every cached loop, its graph and its memory pool (reached from
    ``ParallelModel.cleanup()``, and from a step-OOM demotion)."""
    _loops.clear()


def _culprit(e: BaseException) -> str:
    """Where a failed capture broke: the innermost frame outside torch of the
    first error in the chain (closing a broken capture raises a second one)."""
    while e.__context__ is not None:
        e = e.__context__
    torch_dir = os.path.dirname(torch.__file__)
    frames = [f for f in traceback.extract_tb(e.__traceback__)
              if not f.filename.startswith(torch_dir)]
    if not frames:
        return f"{type(e).__name__}: {e}"
    f = frames[-1]
    return f"{os.path.basename(f.filename)}:{f.lineno} `{f.line}` ({type(e).__name__}: {e})"


def _abandon(pool, device: torch.device) -> None:
    """Undo what a capture that broke before it ended leaves in the caching
    allocator: the capture stream's allocations still routed into the graph's private
    ``pool`` (every later capture on that stream, and no ``empty_cache`` while it
    lasts), and the pool held, since a graph's destructor releases only the pool of a
    capture that ended (and ``CUDAGraph.pool()`` answers only then, so the caller
    names the pool it made). A torch build without these allocator calls keeps the
    pool: the fallback still runs."""
    end = getattr(torch._C, "_cuda_endAllocateToPool", None)
    release = getattr(torch._C, "_cuda_releasePool", None)
    if end is None or release is None:
        return
    try:
        end(device.index, pool)
    except RuntimeError:
        return  # the capture ended: the graph's destructor releases its pool
    release(device.index, pool)


class _Loop:
    """One cached loop for one replica. On a CUDA device: its graph, the static
    input buffers it reads and the output it writes; ``captured`` is K1's
    launches by variant recorded at capture, which every replay repeats. On the
    CPU the body itself runs each time. ``replays`` counts runs."""

    def __init__(self, label: str, body, replica, device: torch.device):
        self.label = label
        self.body = body
        self.replica = replica
        self.device = device
        self.graph: torch.cuda.CUDAGraph | None = None
        self.static = None
        self.out = None
        self.captured: dict[str, int] = {}
        self.capture_s: float | None = None
        self.replays = 0

    def run(self, inputs: dict):
        if self.device.type != "cuda":
            with torch.no_grad():
                out = self.body(self.replica, inputs)
            self.replays += 1
            return out
        with torch.cuda.device(self.device):
            if self.graph is None:
                self._capture(inputs)
            else:
                _copy_into(self.static, inputs)
            self.graph.replay()
            self.replays += 1
            return self.out.clone()

    def _warm_up(self) -> None:
        """The loop body on a side stream with one real forward, reused for every
        step: the first cuBLAS/cuDNN calls, K1's library load and its first
        attribute calls at the loop's shapes happen before the capture."""
        first: list = []

        def forward_once(*args, **kwargs):
            if not first:
                first.append(self.replica(*args, **kwargs))
            return first[0]

        side = _side_stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side), torch.no_grad():
            self.body(forward_once, self.static)
        torch.cuda.current_stream(self.device).wait_stream(side)

    def _capture(self, inputs: dict) -> None:
        with _capture_guard():
            self._capture_alone(inputs)

    def _capture_alone(self, inputs: dict) -> None:
        from ..ops.kernels import flash_attention as fa
        from ..utils.degrade import never_degrades

        start = time.perf_counter()
        # The graph's own buffers: never the caller's tensors.
        self.static = tree_map(lambda l: l.clone() if isinstance(l, torch.Tensor) else l,
                               inputs)
        self._warm_up()
        torch.cuda.synchronize(self.device)
        before = dict(fa.launches_by_variant)
        graph = torch.cuda.CUDAGraph()
        pool = torch.cuda.graph_pool_handle()
        try:
            # The outer stream context gives the caller its stream back even when
            # closing a broken capture raises before the graph's own context does.
            # "thread_local": what other threads do meanwhile (a prompt worker's
            # eager sampler, a decode, an allocation) cannot break this capture.
            with torch.cuda.stream(torch.cuda.current_stream(self.device)), \
                    torch.cuda.graph(graph, pool=pool, stream=_side_stream(self.device),
                                     capture_error_mode="thread_local"), torch.no_grad():
                out = self.body(self.replica, self.static)
        except Exception as e:
            _abandon(pool, self.device)
            if never_degrades(e):
                raise  # an OOM or a kernel that failed: not the fallback's to hide
            raise CaptureError(f"compile_loop: capturing the {self.label} loop as a CUDA "
                               f"graph on {self.device} failed at {_culprit(e)}") from e
        self.captured = {v: n - before[v] for v, n in fa.launches_by_variant.items()
                         if n != before[v]}
        self.graph, self.out = graph, out
        self.capture_s = time.perf_counter() - start


def _copy_into(static, new) -> None:
    if isinstance(static, torch.Tensor):
        static.copy_(new)
    elif isinstance(static, Mapping):
        for k in static:
            _copy_into(static[k], new[k])
    elif isinstance(static, (list, tuple)):
        for s, n in zip(static, new):
            _copy_into(s, n)


def _signature(tree):
    """Shape, dtype and device of every tensor leaf; None where an input is absent."""
    if isinstance(tree, torch.Tensor):
        return tuple(tree.shape), tree.dtype, tree.device
    if isinstance(tree, Mapping):
        return tuple((k, _signature(v)) for k, v in sorted(tree.items()))
    if isinstance(tree, (list, tuple)):
        return tuple(_signature(v) for v in tree)
    return static_kwargs_key({"": tree})


def _bytes(t) -> tuple | None:
    """A schedule tensor's value as a cache key."""
    if t is None:
        return None
    t = torch.as_tensor(t).cpu()
    return tuple(t.shape), str(t.dtype), t.numpy().tobytes()


def _numerics_state() -> tuple:
    from ..ops.attention import get_attention_backend

    return (get_attention_backend(), torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


def _run(kind: str, label: str, spec: TraceSpec, meta: tuple, body, batch: int,
         inputs: dict, static: dict):
    """Place the inputs, run (capture on first use, else replay) each replica's
    loop, gather on the lead device and drop the padding."""
    key = (kind, meta, spec.replicas, spec.devices, _signature(inputs),
           static_kwargs_key(static), _numerics_state())
    shards, padded = _prep(spec, batch, inputs)
    outs = []
    for r, (replica, shard) in enumerate(zip(spec.replicas, shards)):
        loop = _loops.get(key + (r,))
        if loop is None:
            while len(_loops) >= _LOOP_CACHE_MAX:
                _loops.popitem(last=False)
            loop = _loops[key + (r,)] = _Loop(label, body, replica, shard["x"].device)
        try:
            outs.append(loop.run(shard))
        except CaptureError:
            # No replica's loop for this call stays cached (the eager fallback runs
            # every replica, and a later call would capture the broken one again),
            # nor a half-captured graph's memory pool; the eager fallback starts on
            # clean streams.
            for i, s in enumerate(shards):
                _loops.pop(key + (i,), None)
                if s["x"].device.type == "cuda":
                    torch.cuda.synchronize(s["x"].device)
            raise
    lead = outs[0].device
    return slice_padded(concat_results([o.to(lead) for o in outs]), batch, padded)


def loop_records() -> list[dict]:
    """One record per cached loop: its sampler, device, K1's launches by variant
    recorded at its capture, its runs and its capture's seconds."""
    return [{"sampler": loop.label, "device": str(loop.device), "captured": dict(loop.captured),
             "replays": loop.replays, "capture_s": loop.capture_s} for loop in _loops.values()]


# ---------------------------------------------------------------------------
# entry points (called by sampling.runner when compile_loop=True)
# ---------------------------------------------------------------------------


def _loop_inputs(x, context, uncond_context, model_kwargs, uncond_kwargs, mask,
                 mask_init, mask_noise, noise=None) -> tuple[dict, dict]:
    """The loop's tensor inputs and its non-tensor kwargs (baked into the graph).
    Non-tensor uncond kwargs are dropped: CFG swaps only batch tensors into the
    uncond half."""
    traced, static = partition_kwargs(model_kwargs or {})
    u_traced, _ = partition_kwargs(uncond_kwargs or {})
    return dict(x=x, context=context, uncond_context=uncond_context, kwargs=traced,
                uncond_kwargs=u_traced or None, mask=mask, mask_init=mask_init,
                mask_noise=mask_noise, noise=noise), static


def compiled_k_sample(
    spec: TraceSpec, sampler: str, x, sigmas, context, *,
    cfg_scale, uncond_context, uncond_kwargs, acp, prediction, cfg_rescale,
    rng=None, mask=None, mask_init=None, mask_noise=None, model_kwargs=None,
):
    """The k-sampler family's loop: ``k_samplers.SAMPLERS[sampler]`` (its
    rectified-flow form for ``prediction="flow"``) over ``sigmas`` with an
    ``EpsDenoiser``; ``rng`` seeds the stochastic samplers' per-step draws."""
    steps = len(sigmas) - 1
    noise = None
    if sampler in k_samplers.RNG_SAMPLERS:
        noise = _draw_noise(rng, steps, 2 if sampler == "dpmpp_sde" else 1, x)
    inputs, static = _loop_inputs(x, context, uncond_context, model_kwargs, uncond_kwargs,
                                  mask, mask_init, mask_noise, noise)
    step_fn = k_samplers.SAMPLERS[sampler]
    if prediction == "flow":
        step_fn = k_samplers.FLOW_VARIANTS.get(sampler, step_fn)

    def body(model, t):
        denoise = k_samplers.EpsDenoiser(
            model, t["context"], cfg_scale=cfg_scale, uncond_context=t["uncond_context"],
            uncond_kwargs=t["uncond_kwargs"], alphas_cumprod=acp, prediction=prediction,
            cfg_rescale=cfg_rescale, **t["kwargs"], **static)
        if prediction == "flow":
            post = _post_from(t["mask"], lambda i: (1.0 - sigmas[i + 1]) * t["mask_init"]
                              + sigmas[i + 1] * t["mask_noise"])
        else:
            post = _post_from(t["mask"], lambda i: t["mask_init"] + t["mask_noise"] * sigmas[i + 1])
        with k_samplers.noise_table(_noise_of(t)):
            if sampler in k_samplers.RNG_SAMPLERS:
                return step_fn(denoise, t["x"], sigmas, None, callback=post)
            return step_fn(denoise, t["x"], sigmas, callback=post)

    meta = (sampler, float(cfg_scale), float(cfg_rescale), prediction, _bytes(sigmas),
            _bytes(acp))
    return _run("k", sampler, spec, meta, body, x.shape[0], inputs, static)


def compiled_ddim_sample(
    spec: TraceSpec, x, ts, acp, context, *,
    cfg_scale, uncond_context, uncond_kwargs, prediction, cfg_rescale,
    mask=None, mask_init=None, mask_noise=None, model_kwargs=None,
):
    """DDIM's loop (``ddim_sample``) over the timesteps ``ts`` of ``acp``."""
    inputs, static = _loop_inputs(x, context, uncond_context, model_kwargs, uncond_kwargs,
                                  mask, mask_init, mask_noise)
    ts_list = [int(t) for t in ts]

    def keep_at(t, i):
        a = acp[ts_list[i + 1]] if i + 1 < len(ts_list) else torch.tensor(1.0)
        return torch.sqrt(a) * t["mask_init"] + torch.sqrt(1.0 - a) * t["mask_noise"]

    def body(model, t):
        return ddim_sample(
            model, t["x"], t["context"], steps=len(ts_list), cfg_scale=cfg_scale,
            uncond_context=t["uncond_context"], uncond_kwargs=t["uncond_kwargs"],
            alphas_cumprod=acp, callback=_post_from(t["mask"], lambda i: keep_at(t, i)),
            ts=ts, prediction=prediction, cfg_rescale=cfg_rescale, **t["kwargs"], **static)

    meta = (float(cfg_scale), float(cfg_rescale), prediction, _bytes(ts), _bytes(acp))
    return _run("ddim", "ddim", spec, meta, body, x.shape[0], inputs, static)


def compiled_flow_sample(
    spec: TraceSpec, x, ts, context, *,
    cfg_scale, uncond_context, uncond_kwargs, guidance, cfg_rescale,
    mask=None, mask_init=None, mask_noise=None, model_kwargs=None,
):
    """The rectified-flow Euler loop (``flow_euler_sample``) over the flow times
    ``ts``; ``guidance`` feeds FLUX-dev's distilled guidance."""
    inputs, static = _loop_inputs(x, context, uncond_context, model_kwargs, uncond_kwargs,
                                  mask, mask_init, mask_noise)

    def body(model, t):
        post = _post_from(t["mask"], lambda i: (1.0 - ts[i + 1]) * t["mask_init"]
                          + ts[i + 1] * t["mask_noise"])
        return flow_euler_sample(
            model, t["x"], t["context"], steps=len(ts) - 1, guidance=guidance,
            cfg_scale=cfg_scale, uncond_context=t["uncond_context"],
            uncond_kwargs=t["uncond_kwargs"], callback=post, ts=ts,
            cfg_rescale=cfg_rescale, **t["kwargs"], **static)

    meta = (float(cfg_scale), float(cfg_rescale), None if guidance is None else float(guidance),
            _bytes(ts))
    return _run("flow", "flow_euler", spec, meta, body, x.shape[0], inputs, static)


# ---------------------------------------------------------------------------
# per-lane batched step (serving/): ONE model eval advances a fixed-width batch of
# lanes, each carrying its OWN (sigma, state, sampler); each lane's sampler update
# is the host-computed linear combination its LaneStepSpec plan emitted
# (sampling/lane_specs.py), so lanes running different samplers share the eval.
# Padded and retired lanes are masked with torch.where, a select: a pad lane's
# value, NaN included, never reaches a live lane.
# ---------------------------------------------------------------------------


def _lane_scalars(sigmas, active, prediction: str, log_sigmas=None):
    """Per-lane model-input scalars, on the host: ``(s, t, scale)`` as float32 CPU
    tensors ``[W]``. ``s`` is the lane's sigma (pinned to 1 where ``active`` is
    false, so a pad lane divides by nothing small); ``t`` the model timestep (flow:
    ``s`` itself; eps/v: the log-sigma interpolation into ``log_sigmas``); ``scale``
    the eps/v input scale ``1/√(s²+1)`` (None for flow). Each lane's scalars are
    computed one 0-d tensor at a time with ``EpsDenoiser``'s own operations, so a
    lane's timestep and input scale equal the inline sampler's bit for bit."""
    ss, ts, scales = [], [], []
    for sigma, live in zip(sigmas, active):
        s = k_samplers._f32(float(sigma) if live else 1.0)
        ss.append(s)
        if prediction == "flow":
            ts.append(s)
        else:
            ts.append(k_samplers.interp(torch.log(s), log_sigmas,
                                        torch.arange(len(log_sigmas), dtype=torch.float32)))
            scales.append(1.0 / torch.sqrt(s**2 + 1.0))
    stack = lambda v: torch.stack(v).reshape(-1)  # noqa: E731
    return stack(ss), stack(ts), (stack(scales) if scales else None)


def lane_step_program(model, *, prediction: str, use_cfg: bool, cfg_rescale: float,
                      static_kwargs: dict, broadcast_cond: bool = False,
                      broadcast_kwargs: bool = False):
    """The per-step program of one serving bucket (W lanes of per-request batch b):

    ``fn(x[W,b,...], xe, h1, h2, sigma_eval[W] (host floats), active[W] (host
    bools), cfg_scale[W] (host floats), coef[W,4,6], noise[W,b,...] | None,
    context[W,b,L,D] | [b,L,D] | None, uncond_context, kwargs, u_kwargs,
    log_sigmas | None, mask[W,b,...] | None, mask_init, mask_noise,
    mask_mix[W,3] | None) -> (x', xe', h1', h2')``

    One batched model eval at per-lane ``(xe, sigma_eval)``: the σ→timestep
    log-interpolation and the 1/√(σ²+1) input scale (``_lane_scalars``, host
    scalars moved to the device before the forward), cond ‖ uncond in one forward and the
    CFG mix with a per-lane ``cfg_scale``, then the denoised estimate ``x0``. Each
    state slot then becomes its ``coef``-weighted combination of
    ``(x, xe, x0, h1, h2, noise)``: ``noise`` holds each drawing lane's own
    pre-drawn ``step_noise`` row (zeros for the rest; None when no lane draws), so
    a stochastic lane is the same alone or co-batched. The sampler never appears
    in the program. Inactive lanes get sigma 1, and a ``torch.where`` select keeps
    their state as it was.

    ``broadcast_cond`` / ``broadcast_kwargs``: ``context`` / ``uncond_context``
    and the traced kwargs trees arrive as ONE per-request ``[b, ...]`` value shared
    by every lane and are expanded over the lane axis here (the sibling-seed
    fan-out of one prompt holds one cond), giving the same ``[W·b, ...]`` values
    the stacked variant reshapes to.

    Denoise masks (img2img, inpaint): ``mask_mix[W, 3]`` is ``(gate, keep_a,
    keep_b)`` per lane; where the gate is on (a masked lane completing its
    σ-interval), x' and xe' re-pin the keep region to ``keep_a·mask_init +
    keep_b·mask_noise``, the inline sampler's mask callback; histories are left
    alone, as the callback never sees them. ``mask`` None skips the blend (no
    masked lane in the bucket).

    Rounding follows the inline ``EpsDenoiser``: the guidance product and σ·eps
    are taken in float32 and rounded to the model's output dtype before they meet
    the float32 latent, as PyTorch rounds a reduced-precision tensor times a
    Python scalar."""
    def fn(x, xe, h1, h2, sigma_eval, active, cfg_scale, coef, noise, context,
           uncond_context, kwargs, u_kwargs, log_sigmas, mask, mask_init, mask_noise,
           mask_mix):
        W, b = x.shape[0], x.shape[1]
        n = W * b
        dev = x.device

        def flatten(t):
            return t.reshape((n,) + tuple(t.shape[2:]))

        def expand(t):
            return t[None].expand((W,) + tuple(t.shape))

        def col(v, ndim):
            return v.reshape(v.shape + (1,) * (ndim - 1))

        if broadcast_cond:
            context = None if context is None else expand(context)
            uncond_context = None if uncond_context is None else expand(uncond_context)
        if broadcast_kwargs:
            kwargs = {k: expand(v) for k, v in (kwargs or {}).items()}
            u_kwargs = {k: expand(v) for k, v in (u_kwargs or {}).items()}
        s, t, scale = _lane_scalars(sigma_eval, active, prediction, log_sigmas)
        scalars = torch.stack([s, t] + ([scale] if scale is not None else []) +
                              [torch.as_tensor(cfg_scale, dtype=torch.float32)])
        # Every host value moves before the model call: a copy after it would hold
        # the host until the forward's kernels finish.
        scalars = scalars.to(dev).repeat_interleave(b, dim=1)
        s_flat, t_flat = scalars[0], scalars[1]
        scale_flat = scalars[2] if scale is not None else None
        cfg_flat = scalars[-1]
        coef = coef.to(dev)
        live = torch.as_tensor(list(active), dtype=torch.bool).to(dev)
        mix_rows = None if mask is None else mask_mix.to(dev)
        flat = flatten(xe)
        x_in = flat if scale_flat is None else flat * col(scale_flat, flat.ndim)
        ctx = None if context is None else flatten(context)
        kw = {k: flatten(v) for k, v in (kwargs or {}).items()}
        if use_cfg:
            u_kw = {k: flatten(v) for k, v in (u_kwargs or {}).items()}
            extra_keys = set(u_kw) - set(kw)
            if extra_keys:
                raise ValueError(f"uncond kwargs carry keys absent from cond kwargs: "
                                 f"{sorted(extra_keys)}")
            out = model(torch.cat([x_in, x_in]), torch.cat([t_flat, t_flat]),
                        None if ctx is None else torch.cat([ctx, flatten(uncond_context)]),
                        **{k: torch.cat([v, u_kw.get(k, v)]) for k, v in kw.items()},
                        **static_kwargs)
            eps_c, eps_u = out.chunk(2, dim=0)
            guided = (eps_c - eps_u).float() * col(cfg_flat, eps_c.ndim)
            eps = eps_u + guided.to(eps_c.dtype)
            eps = rescale_guidance(eps, eps_c, float(cfg_rescale))
        else:
            eps = model(x_in, t_flat, ctx, **kw, **static_kwargs)
        dt = eps.dtype
        s_col = col(s_flat, eps.ndim)
        if prediction == "v":
            v_term = ((eps.float() * s_col).to(dt).float()
                      * col(scale_flat, eps.ndim)).to(dt)
            x0_flat = flat / (s_col**2 + 1.0) - v_term
        else:
            # eps: x0 = x − σ·eps. flow: x0 = x − σ·v, the same expression.
            x0_flat = flat - (eps.float() * s_col).to(dt)
        x0 = x0_flat.reshape(x.shape)
        basis = (x, xe, x0, h1, h2, noise)

        def mix(j):
            acc = None
            for k, term in enumerate(basis):
                if term is None:
                    continue
                part = col(coef[:, j, k], x.ndim) * term
                acc = part if acc is None else acc + part
            return acc.to(x.dtype)

        live = col(live, x.ndim)
        new = [torch.where(live, mix(j), old) for j, old in enumerate((x, xe, h1, h2))]
        if mix_rows is not None:
            gate = col(mix_rows[:, 0] > 0, x.ndim)
            keep = (col(mix_rows[:, 1], x.ndim) * mask_init
                    + col(mix_rows[:, 2], x.ndim) * mask_noise)
            for j in (0, 1):
                blend = _mask_blend(new[j], mask, keep).to(x.dtype)
                new[j] = torch.where(gate, blend, new[j])
        return tuple(new)

    return fn
