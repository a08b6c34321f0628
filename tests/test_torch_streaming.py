"""Weight streaming in the PyTorch port (``parallel/streaming.py``, the carve helpers of
``models/loader.py``, ``devices.memory.ResidencyTracker`` and the orchestrator's
stream route) against the JAX package, on the CPU.

The contract of ``tests/test_streaming.py`` and of the JAX ``parallel/streaming.py``
docstring, on the JAX test's tiny FLUX (``TINY_FLUX``: 2 double + 4 single blocks),
the tiny SD1.5-like UNet of ``test_torch_unet.py`` and an int8 FLUX, the same numpy
weights on both sides (the port's through ``convert_jax``):
- byte counts and stage carves equal to the JAX ``params_nbytes``,
  ``segment_nbytes`` and ``carve_stages`` (f32, bf16 and int8 FLUX, the UNet); the
  JAX bf16 tree is cast leaf by leaf to the dtype the port stores (the modulation
  and final linears and the q/k norm scales stay f32, as in both models);
- the streamed forward bitwise equal to the port's resident forward, and within
  rtol/atol 2e-4 of the JAX resident ``apply``;
- at most two stages of weights live at once, none between calls;
- an out-of-memory error re-carves finer and gives the same output; any other
  error propagates; the carve bottoms out and refuses a carve without progress;
- the routing guards, and the sampler eager and with ``compile_loop=True``.
The JAX package's own stream tests are partly red here (the CPU backend's
``pinned_host`` memory kind), so the port is held to the JAX resident forward and
the JAX carve arithmetic, not to them.
"""

import functools
import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from comfyui_parallelanything_tpu.models import flux as jflux  # noqa: E402
from comfyui_parallelanything_tpu.models import loader as jloader  # noqa: E402
from comfyui_parallelanything_tpu.models import quantize as jq  # noqa: E402
from comfyui_parallelanything_tpu.ops.attention import sequence_ctx_key  # noqa: E402
from comfyui_parallelanything_tpu.sampling.runner import (  # noqa: E402
    run_sampler as jax_run_sampler,
)
from comfyui_parallelanything_tpu_torch import ParallelConfig, parallelize  # noqa: E402
from comfyui_parallelanything_tpu_torch.models import flux as pflux  # noqa: E402
from comfyui_parallelanything_tpu_torch.models import loader as ploader  # noqa: E402
from comfyui_parallelanything_tpu_torch.models import quantize as pq  # noqa: E402
from comfyui_parallelanything_tpu_torch.models.api import (  # noqa: E402
    DiffusionModel,
    PipelineSegment,
    PipelineSpec,
)
from comfyui_parallelanything_tpu_torch.models.convert_jax import from_jax_params  # noqa: E402
from comfyui_parallelanything_tpu_torch.parallel import (  # noqa: E402
    StreamingRunner,
    build_streaming_runner,
)
from comfyui_parallelanything_tpu_torch.parallel.orchestrator import HOST_OOM_MESSAGE  # noqa: E402
from comfyui_parallelanything_tpu_torch.sampling.runner import run_sampler  # noqa: E402

import test_torch_unet as tu  # noqa: E402
from test_streaming import TINY_FLUX  # noqa: E402
from test_torch_flux import TXT, _numpy_params  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
MIN_SIZE = 256  # int8 threshold low enough for the tiny weights
FLUX_FIELDS = ("in_channels", "hidden_size", "num_heads", "depth", "depth_single_blocks",
               "mlp_ratio", "context_in_dim", "vec_in_dim", "axes_dim", "guidance_embed")
F32_LEAVES = ("img_mod", "txt_mod", "modulation", "final_mod", "final_proj", "query_norm",
              "key_norm")  # stored in f32 by both models whatever the compute dtype
CPU = torch.device("cpu")
T = torch.from_numpy
# The JAX references run each program once or a few times, and XLA's CPU backend spends
# most of a tiny model's compile in LLVM's optimiser: compile them unoptimised.
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(autouse=True)
def _hermetic(monkeypatch, tmp_path):
    monkeypatch.setenv("PA_PLANNER", "0")
    monkeypatch.setenv("PA_LEDGER_DIR", str(tmp_path / "ledger"))
    monkeypatch.setenv("PA_EVIDENCE_DIR", str(tmp_path / "evidence"))


@functools.cache
def _tree():
    return _numpy_params(TINY_FLUX, seed=5)


def _port_flux(dtype=torch.float32):
    cfg = pflux.FluxConfig(**{f: getattr(TINY_FLUX, f) for f in FLUX_FIELDS}, dtype=dtype)
    return pflux.build_flux(cfg, device="cpu", state_dict=from_jax_params(_tree()))


def _fast_compile(jm):
    """``jm``'s jitted forward, which its ``__call__`` (and so the JAX sampler) uses,
    compiled with ``FAST_COMPILE``."""
    jm._jit_cache = {sequence_ctx_key(): jax.jit(jm.apply, compiler_options=FAST_COMPILE)}
    return jm


@functools.cache
def _flux():
    """(JAX model, port model) of ``TINY_FLUX`` in f32, one numpy tree."""
    jm = jflux.build_flux(TINY_FLUX, params=jax.tree.map(jnp.asarray, _tree()))
    return _fast_compile(jm), _port_flux()


@functools.cache
def _int8():
    """(JAX int8 params as shapes and dtypes, which is all a byte count reads; port
    int8 model) of the same tree, ``min_size`` 256."""
    jparams = jax.eval_shape(lambda p: jq.quantize_params(p, min_size=MIN_SIZE), _tree())
    return jparams, pq.quantize_model(_port_flux(), min_size=MIN_SIZE)


def _carve_pair(kind):
    """(JAX spec, JAX params, port model) for the byte and carve comparisons."""
    if kind == "unet":
        jm, pm, _ = tu._pair("sd15_like")
        return jm.pipeline_spec, jm.params, pm
    jm, pm = _flux()
    if kind == "f32":
        return jm.pipeline_spec, jm.params, pm
    if kind == "int8":
        jparams, qm = _int8()
        return jm.pipeline_spec, jparams, qm

    def cast(path, a):
        keep = any(getattr(p, "key", None) in F32_LEAVES for p in path)
        return a if keep else a.astype(jnp.bfloat16)

    return (jm.pipeline_spec, jax.tree_util.tree_map_with_path(cast, _tree()),
            _port_flux(torch.bfloat16))


def _inputs(batch, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(batch, 8, 8, 4)).astype(np.float32),
            rng.uniform(0.1, 1.0, size=(batch,)).astype(np.float32),
            rng.normal(size=(batch, TXT, TINY_FLUX.context_in_dim)).astype(np.float32),
            {"y": rng.normal(size=(batch, TINY_FLUX.vec_in_dim)).astype(np.float32)})


def _jax_call(jm, x, t, ctx, kw):
    return np.asarray(jm(jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
                         **{k: jnp.asarray(v) for k, v in kw.items()}))


@functools.cache
def _jax_flux_batch2():
    return _jax_call(_flux()[0], *_inputs(2))


def _port_call(fn, x, t, ctx, kw):
    return fn(T(x), T(t), T(ctx), **{k: T(v) for k, v in kw.items()}).numpy()


def _stream(model, budget_frac=3, **cfg):
    budget = ploader.params_nbytes(model.module) // budget_frac
    return parallelize(model, [("cpu", 100)],
                       ParallelConfig(weight_sharding="stream", hbm_budget_bytes=budget, **cfg))


class _Chain(torch.nn.Module):
    """A model of one large segment and two tiny ones: a cap at the large one's
    size packs the tiny ones into one stage, and halving it changes nothing."""

    def __init__(self):
        super().__init__()
        self.big = torch.nn.Linear(16, 16)
        self.small = torch.nn.ModuleList([torch.nn.Linear(1, 1) for _ in range(2)])

    def forward(self, x, t, context=None, **kw):
        h = self.big(x)
        for m in self.small:
            h = h * m.weight.sum()
        return h


def _chain_model():
    torch.manual_seed(0)
    segments = (PipelineSegment(("big",), lambda m, c: {"h": m.big(c["h"])}, "big"),) + tuple(
        PipelineSegment((f"small.{i}",), lambda m, c, i=i: {"h": c["h"] * m.small[i].weight.sum()},
                        f"small[{i}]") for i in range(2))
    spec = PipelineSpec(prepare_keys=(), prepare=lambda m, x, t, context=None, **kw: {"h": x},
                        segments=segments, finalize_keys=(),
                        finalize=lambda m, carry, shape: carry["h"])
    return DiffusionModel(module=_Chain(), name="chain", pipeline_spec=spec)


CAPS = {"one": lambda sizes: dict(max_stage_bytes=1),
        "max_segment_minus_one": lambda sizes: dict(max_stage_bytes=max(sizes) - 1),
        "third": lambda sizes: dict(max_stage_bytes=sum(sizes) // 3),
        "n_stages": lambda sizes: dict(max_stage_bytes=None, n_stages=3)}


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8", "unet"])
def test_bytes_and_carve_equal_jax(kind, cap):
    jspec, jparams, pm = _carve_pair(kind)
    sizes = ploader.segment_nbytes(pm.pipeline_spec, pm.module)
    assert sizes == jloader.segment_nbytes(jspec, jparams)
    assert ploader.params_nbytes(pm.module) == jloader.params_nbytes(jparams)
    kw = CAPS[cap](sizes)
    got = ploader.carve_stages(pm.pipeline_spec, pm.module, **kw)
    assert got == jloader.carve_stages(jspec, jparams, **kw)
    assert got == ploader.carve_ranges(sizes, **kw) == jloader.carve_ranges(sizes, **kw)


@pytest.mark.parametrize("case", ["flux_batch2", "flux_batch1", "flux_overlap_off", "unet"])
def test_streamed_equals_port_resident_bitwise_and_jax_resident(case):
    if case == "unet":
        jm, pm, _ = tu._pair("sd15_like")
        x, t, ctx, kw = tu._inputs(0, jm.config, batch=2)
        want = np.asarray(jax.jit(jm.apply, compiler_options=FAST_COMPILE)(
            jm.params, *map(jnp.asarray, (x, t, ctx)), **{k: jnp.asarray(v) for k, v in kw.items()}))
    else:
        # One JAX program for FLUX: batch 1 is the first sample of the batch-2 call.
        jm, pm = _flux()
        x, t, ctx, kw = _inputs(2)
        want = _jax_flux_batch2()
        if case == "flux_batch1":
            x, t, ctx, kw, want = x[:1], t[:1], ctx[:1], {"y": kw["y"][:1]}, want[:1]
    sp = _stream(pm, stream_overlap=case != "flux_overlap_off")
    assert sp.is_streaming and sp._replicas == []
    got = _port_call(sp, x, t, ctx, kw)
    np.testing.assert_array_equal(got, _port_call(pm, x, t, ctx, kw))
    np.testing.assert_allclose(got, want, **TOL)
    runner = sp._stream_runner
    assert runner.n_stages >= 2 and runner.overlap == (case != "flux_overlap_off")
    assert sp._pipeline_runner is None  # batch 1 streams too
    assert [lb for st in runner.stages for lb in st.labels] == [
        seg.label for seg in pm.pipeline_spec.segments]


def test_int8_streams_its_payloads_and_scales_bitwise():
    _, qm = _int8()
    x, t, ctx, kw = _inputs(2, seed=3)
    sp = _stream(qm)
    np.testing.assert_array_equal(_port_call(sp, x, t, ctx, kw), _port_call(qm, x, t, ctx, kw))
    runner = sp._stream_runner
    stage = runner.stages[0]
    lin = stage.module.get_submodule(stage.keys[0]).img_attn_qkv
    slot = runner._ring[0]
    base = slot.data_ptr()
    for t_ in (lin.parametrizations.weight.original, lin.parametrizations.weight[0].scale):
        assert base <= t_.data_ptr() < base + slot.numel()  # payload and scales in the slot
    assert runner.streamed_nbytes + runner.tracker.resident_bytes == ploader.params_nbytes(qm.module)


def test_two_stage_bound_when_the_weights_exceed_the_budget():
    _, pm = _flux()
    total = ploader.params_nbytes(pm.module)
    sp = parallelize(pm, [("cpu", 100)], ParallelConfig(hbm_budget_bytes=total // 3))
    assert sp.is_streaming, "the weights-don't-fit route must engage"
    x, t, ctx, kw = _inputs(2)
    for _ in range(2):
        _port_call(sp, x, t, ctx, kw)
        runner = sp._stream_runner
        tracker = runner.tracker
        assert runner.streamed_nbytes > total // 3 and runner.n_stages >= 2
        assert tracker.peak_bytes <= 2 * runner.max_stage_nbytes
        assert tracker.live_bytes == 0 and not tracker.live_tags
        assert 0 < tracker.resident_bytes < runner.streamed_nbytes
    assert runner.max_stage_nbytes <= max(1, total // 3 * 2 // 5) or all(
        e - s == 1 for s, e in (st.range for st in runner.stages))


class TestRecarve:
    @pytest.mark.parametrize("error", [
        torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
        RuntimeError(f"{HOST_OOM_MESSAGE}: you tried to allocate 2147483648 bytes")])
    def test_oom_recarves_to_more_stages_with_the_same_output(self, monkeypatch, error):
        _, pm = _flux()
        sp = _stream(pm, budget_frac=1)  # a coarse carve, so halving has room
        first = sp._get_streaming_runner()
        n0, calls = first.n_stages, []
        orig = StreamingRunner.__call__

        def flaky(self, *a, **kw):
            if self is first and not calls:
                calls.append(1)
                raise error
            return orig(self, *a, **kw)

        monkeypatch.setattr(StreamingRunner, "__call__", flaky)
        x, t, ctx, kw = _inputs(2)
        got = _port_call(sp, x, t, ctx, kw)
        deeper = sp._stream_runner
        assert deeper is not first and deeper.n_stages > n0
        assert deeper._master is first._master  # the host copy is made once
        np.testing.assert_array_equal(got, _port_call(pm, x, t, ctx, kw))

    def test_other_errors_propagate(self, monkeypatch):
        _, pm = _flux()
        sp = _stream(pm)
        monkeypatch.setattr(StreamingRunner, "__call__", lambda self, *a, **kw: (
            _ for _ in ()).throw(RuntimeError("unrelated failure")))
        with pytest.raises(RuntimeError, match="unrelated"):
            _port_call(sp, *_inputs(2))

    def test_a_failed_call_releases_the_ring(self, monkeypatch):
        _, pm = _flux()
        sp = _stream(pm)
        x, t, ctx, kw = _inputs(2)
        _port_call(sp, x, t, ctx, kw)
        runner = sp._stream_runner
        seg = pm.pipeline_spec.segments[1]

        def boom(module, carry):
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")

        monkeypatch.setattr(runner.stages[1], "fns", (boom,) + runner.stages[1].fns[1:])
        with pytest.raises(torch.cuda.OutOfMemoryError):
            runner(T(x), T(t), T(ctx), **{k: T(v) for k, v in kw.items()})
        assert runner._ring is None and runner.tracker.live_bytes == 0
        monkeypatch.setattr(runner.stages[1], "fns", (seg.fn,) + runner.stages[1].fns[1:])
        np.testing.assert_array_equal(_port_call(runner, x, t, ctx, kw),
                                      _port_call(pm, x, t, ctx, kw))

    def test_recarve_bottoms_out_at_one_segment_per_stage(self):
        _, pm = _flux()
        runner = StreamingRunner(pm.pipeline_spec, pm.module, CPU, max_stage_bytes=1)
        assert runner.n_stages == len(pm.pipeline_spec.segments)
        assert runner.recarved() is None

    def test_recarve_refuses_a_carve_without_progress(self, monkeypatch):
        model = _chain_model()
        sizes = ploader.segment_nbytes(model.pipeline_spec, model.module)
        runner = StreamingRunner(model.pipeline_spec, model.module, CPU,
                                 max_stage_bytes=max(sizes))
        assert [st.range for st in runner.stages] == [(0, 1), (1, 3)]
        assert runner.recarved() is None  # halving the cap gives the same two stages
        sp = parallelize(model, [("cpu", 100)], ParallelConfig(
            weight_sharding="stream", hbm_budget_bytes=max(sizes) * 5 // 2))
        assert [st.range for st in sp._get_streaming_runner().stages] == [(0, 1), (1, 3)]

        def oom(self, *a, **kw):
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")

        monkeypatch.setattr(StreamingRunner, "__call__", oom)
        with pytest.raises(torch.cuda.OutOfMemoryError):  # the ladder is exhausted
            sp(torch.ones(2, 16), torch.zeros(2))


class TestRouting:
    def test_stream_requires_a_pipeline_spec(self):
        with pytest.raises(ValueError, match="PipelineSpec"):
            parallelize(_Chain(), [("cpu", 100)], ParallelConfig(weight_sharding="stream"))

    def test_stream_does_not_compose_with_tensor_parallel(self):
        with pytest.raises(ValueError, match="tensor_parallel"):
            parallelize(_chain_model(), [("cpu", 100)],
                        ParallelConfig(weight_sharding="stream", tensor_parallel=2))

    def test_a_model_that_fits_is_placed(self):
        _, pm = _flux()
        sp = parallelize(pm, [("cpu", 100)], ParallelConfig(
            hbm_budget_bytes=ploader.params_nbytes(pm.module) * 10))
        assert not sp.is_streaming and sp._replicas == [pm.module]

    def test_over_the_budget_without_a_spec_goes_to_placement(self):
        module = _Chain()
        sp = parallelize(module, [("cpu", 100)], ParallelConfig(hbm_budget_bytes=1))
        assert not sp.is_streaming and sp._replicas == [module]
        x = torch.ones(2, 16)
        torch.testing.assert_close(sp(x, torch.zeros(2)), module(x, None))

    def test_the_budget_counts_int8_scales_as_jax_does(self):
        jparams, qm = _int8()
        jax_count = jloader.params_nbytes(jparams)
        assert ploader.params_nbytes(qm.module) == jax_count
        params_only = sum(p.numel() * p.element_size() for p in qm.module.parameters())
        assert params_only < jax_count  # the Dequantize scales are buffers
        fits = parallelize(qm, [("cpu", 100)], ParallelConfig(hbm_budget_bytes=jax_count))
        over = parallelize(qm, [("cpu", 100)], ParallelConfig(hbm_budget_bytes=jax_count - 1))
        assert not fits.is_streaming and over.is_streaming

    def test_traceable_single_reactivate_and_cleanup(self):
        _, pm = _flux()
        sp = _stream(pm)
        assert sp.traceable() is None  # no captured loop may hold every weight
        x, t, ctx, kw = _inputs(2)
        np.testing.assert_array_equal(_port_call(sp.single, x, t, ctx, kw),
                                      _port_call(pm, x, t, ctx, kw))
        runner = sp._stream_runner
        assert runner is not None
        sp.reactivate()  # places nothing
        assert sp._replicas == [] and sp._stream_runner is runner and sp.is_streaming
        sp.cleanup()
        assert sp._stream_runner is None

    def test_build_streaming_runner_none_without_spec(self):
        assert build_streaming_runner(None, _Chain(), CPU) is None

    def test_planned_stage_count_wins_only_within_the_cap(self):
        _, pm = _flux()
        spec, sizes = pm.pipeline_spec, ploader.segment_nbytes(pm.pipeline_spec, pm.module)
        wide = build_streaming_runner(spec, pm.module, CPU, hbm_budget_bytes=sum(sizes) * 10,
                                      n_stages=2)
        assert [st.range for st in wide.stages] == jloader.carve_ranges(sizes, n_stages=2)
        budget = max(sizes) * 5 // 2  # a cap of one double block
        tight = build_streaming_runner(spec, pm.module, CPU, hbm_budget_bytes=budget, n_stages=2)
        assert [st.range for st in tight.stages] == jloader.carve_ranges(
            sizes, max_stage_bytes=budget * 2 // 5)
        assert tight.max_stage_nbytes <= max(sizes) < wide.max_stage_nbytes


def test_sampler_eager_and_compile_loop_stream_every_step(caplog):
    jm, pm = _flux()
    rng = np.random.default_rng(5)
    noise = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    _, _, ctx, kw = _inputs(2, seed=6)
    common = dict(sampler="dpmpp_2m", steps=3, prediction="flow")
    want = np.asarray(jax_run_sampler(jm, jnp.asarray(noise), jnp.asarray(ctx),
                                      y=jnp.asarray(kw["y"]), **common))
    sp = _stream(pm)
    eager = run_sampler(sp, T(noise), T(ctx), y=T(kw["y"]), **common).numpy()
    np.testing.assert_allclose(eager, want, **TOL)
    with caplog.at_level(logging.INFO, "comfyui_parallelanything_tpu_torch.sampling.runner"):
        captured = run_sampler(sp, T(noise), T(ctx), y=T(kw["y"]), compile_loop=True,
                               **common).numpy()
    assert "weight-streaming model" in caplog.text
    np.testing.assert_array_equal(captured, eager)
    runner = sp._stream_runner
    assert runner.tracker.peak_bytes <= 2 * runner.max_stage_nbytes
    assert runner.tracker.live_bytes == 0
