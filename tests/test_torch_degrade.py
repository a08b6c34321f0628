"""The degradation ladder of the PyTorch port (``utils/degrade.py`` and its rungs in
``sampling/runner.py``, ``sampling/compiled.py`` and ``parallel/orchestrator.py``)
against the JAX package on the CPU.

- The rung vocabulary is the JAX ``LADDER_RUNGS`` less ``attn-chunk-shrink`` (K1
  never materialises the logits, so no threshold is there to shrink), each rung
  recorded as a log line, a ``pa_degradation_total{rung=}`` count and an instant
  ``degradation`` span, as in the JAX module.
- ``compile-eager``: a capture failure simulated on the CPU (the loop's run raises
  the port's ``CaptureError``, what a broken CUDA-graph capture raises on the card)
  records the rung once and returns exactly the eager loop's latent, which equals
  the JAX eager loop's on the toy model of ``tests/test_compiled.py`` at that file's
  sampler tolerance (rtol 2e-4, atol 2e-5), for the k-sampler, ddim and flow
  branches; a stochastic sampler's fallback rewinds its generator, so it equals the
  eager loop with the same seed bitwise; the failed loop leaves the cache. An
  out-of-memory error and a kernel build or launch failure raise instead, whether
  raised alone or underneath a capture error.
- ``stream-recarve``: a streamed call's simulated OOM records the rung with
  ``stages_before`` and ``stages_after``; with no finer carve left the ladder is
  exhausted (``ladder_exhausted``) and the original error re-raises.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from comfyui_parallelanything_tpu.sampling import schedules as jax_schedules  # noqa: E402
from comfyui_parallelanything_tpu.sampling.runner import (  # noqa: E402
    run_sampler as jax_run_sampler,
)
from comfyui_parallelanything_tpu.utils import degrade as jdegrade  # noqa: E402
from comfyui_parallelanything_tpu_torch import ParallelConfig, parallelize  # noqa: E402
from comfyui_parallelanything_tpu_torch.models import flux as pflux  # noqa: E402
from comfyui_parallelanything_tpu_torch.models.loader import params_nbytes  # noqa: E402
from comfyui_parallelanything_tpu_torch.ops.kernels.build import KernelError  # noqa: E402
from comfyui_parallelanything_tpu_torch.parallel import StreamingRunner  # noqa: E402
from comfyui_parallelanything_tpu_torch.parallel.orchestrator import (  # noqa: E402
    HOST_OOM_MESSAGE,
)
from comfyui_parallelanything_tpu_torch.sampling import compiled  # noqa: E402
from comfyui_parallelanything_tpu_torch.sampling.runner import run_sampler  # noqa: E402
from comfyui_parallelanything_tpu_torch.utils import degrade, tracing  # noqa: E402
from comfyui_parallelanything_tpu_torch.utils.metrics import registry  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-5)
SHAPE = (2, 8, 8, 4)
ACP = np.array(jax_schedules.scaled_linear_schedule())
TINY_FLUX = dict(in_channels=16, hidden_size=64, num_heads=4, depth=2, depth_single_blocks=4,
                 context_in_dim=32, vec_in_dim=16, axes_dim=(4, 6, 6), guidance_embed=False)


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    monkeypatch.setenv("PA_PLANNER", "0")
    monkeypatch.setenv("PA_LEDGER_DIR", str(tmp_path / "ledger"))
    monkeypatch.setenv("PA_EVIDENCE_DIR", str(tmp_path / "evidence"))
    tracing.disable()
    tracing.tracer.clear()
    yield
    tracing.disable()
    tracing.tracer.clear()
    compiled.clear_compiled_loops()


def _rungs(rung: str, **labels) -> float:
    return registry.get("pa_degradation_total", {"rung": rung, **labels}) or 0.0


def ptoy(x, t, context=None, **kwargs):
    """``tests/test_compiled.py``'s ``_toy_model`` in torch."""
    return 0.12 * x * torch.cos(t)[:, None, None, None] + (
        0.01 * context.sum(dim=(1, 2))[:, None, None, None])


class PToy(torch.nn.Module):
    def forward(self, x, t, context=None, **kwargs):
        return ptoy(x, t, context)


def jtoy(x, t, context=None, **kwargs):
    return 0.12 * x * jnp.cos(t)[:, None, None, None] + (
        0.01 * context.sum(axis=(1, 2))[:, None, None, None])


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=SHAPE).astype(np.float32),
            rng.normal(size=(SHAPE[0], 6, 16)).astype(np.float32))


@pytest.fixture
def broken_capture(monkeypatch):
    """Every cached loop's run fails as a broken CUDA-graph capture does."""
    seen = []

    def run(self, inputs):
        seen.append(self.label)
        raise compiled.CaptureError(
            f"compile_loop: capturing the {self.label} loop as a CUDA graph on cuda:0 failed "
            "at model.py:12 `float(h.max())` (RuntimeError: operation not permitted when "
            "stream is capturing)")

    monkeypatch.setattr(compiled._Loop, "run", run)
    return seen


def test_rungs_are_the_jax_ladder_less_the_chunk_shrink():
    assert set(degrade.LADDER_RUNGS) == set(jdegrade.LADDER_RUNGS) - {"attn-chunk-shrink"}
    assert "attn-chunk-shrink" in degrade.__doc__
    with pytest.raises(ValueError):
        degrade.record_rung("attn-chunk-shrink", "not a port rung")


@pytest.mark.parametrize("sampler, extra", [
    ("dpmpp_2m", {}), ("heun", dict(cfg_scale=3.0)), ("ddim", {}),
    ("flow_euler", {})])
def test_capture_failure_runs_the_eager_loop_as_jax_does(sampler, extra, broken_capture):
    noise, ctx = _inputs()
    kw = dict(sampler=sampler, steps=4, **extra)
    if extra.get("cfg_scale"):
        kw["uncond_context"] = -ctx
    if sampler != "flow_euler":
        kw["alphas_cumprod"] = ACP
    pkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    before = _rungs("compile-eager")
    tracing.enable()
    got = run_sampler(ptoy, torch.from_numpy(noise), torch.from_numpy(ctx), compile_loop=True,
                      **pkw)
    assert broken_capture == [sampler] and _rungs("compile-eager") == before + 1
    [span] = [e for e in tracing.export()["traceEvents"] if e.get("name") == "degradation"]
    assert span["cat"] == "degrade" and span["args"]["rung"] == "compile-eager"
    assert span["args"]["sampler"] == sampler and "capturing" in span["args"]["detail"]
    assert compiled.loop_records() == []  # the failed loop left the cache
    eager = run_sampler(ptoy, torch.from_numpy(noise), torch.from_numpy(ctx), **pkw)
    np.testing.assert_array_equal(got.numpy(), eager.numpy())
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    want = jax_run_sampler(jtoy, jnp.asarray(noise), jnp.asarray(ctx), **jkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_a_stochastic_fallback_draws_the_eager_noise(broken_capture):
    noise, ctx = (torch.from_numpy(a) for a in _inputs(1))
    kw = dict(sampler="euler_ancestral", steps=3, alphas_cumprod=torch.from_numpy(ACP))
    got = run_sampler(ptoy, noise, ctx, compile_loop=True, rng=torch.Generator().manual_seed(4),
                      **kw)
    eager = run_sampler(ptoy, noise, ctx, rng=torch.Generator().manual_seed(4), **kw)
    np.testing.assert_array_equal(got.numpy(), eager.numpy())


def test_a_replica_that_fails_drops_every_replica_of_the_call(monkeypatch):
    # Two replicas: the first captures, the second breaks. Neither loop stays
    # cached, so the next call does not replay the first and break the second again.
    real_run, seen = compiled._Loop.run, []

    def run(self, inputs):
        seen.append(len(seen))
        if len(seen) == 2:
            raise compiled.CaptureError("capture failed on the second replica")
        return real_run(self, inputs)

    monkeypatch.setattr(compiled._Loop, "run", run)
    pm = parallelize(PToy(), [("cpu:0", 50), ("cpu:1", 50)])
    noise, ctx = (torch.from_numpy(a) for a in _inputs(2))
    kw = dict(sampler="euler", steps=3, alphas_cumprod=torch.from_numpy(ACP))
    before = _rungs("compile-eager")
    got = run_sampler(pm, noise, ctx, compile_loop=True, **kw)
    assert seen == [0, 1] and _rungs("compile-eager") == before + 1
    assert compiled.loop_records() == []
    np.testing.assert_array_equal(got.numpy(), run_sampler(pm, noise, ctx, **kw).numpy())


def test_abandon_without_the_allocator_calls_keeps_the_fallback(monkeypatch):
    # A torch build without the private allocator calls keeps the broken pool; the
    # capture error, and with it the eager fallback, still comes through.
    monkeypatch.delattr(torch._C, "_cuda_endAllocateToPool", raising=False)
    monkeypatch.delattr(torch._C, "_cuda_releasePool", raising=False)
    assert compiled._abandon((0, 1), torch.device("cuda", 0)) is None


@pytest.mark.parametrize("error", [
    torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
    RuntimeError(f"{HOST_OOM_MESSAGE}: you tried to allocate 2147483648 bytes"),
    KernelError("kernel build failed: flash_attention: nvcc exit 1"),
    "oom under a capture error", "kernel under a capture error"])
def test_oom_and_kernel_failures_still_raise(error, monkeypatch):
    if error == "oom under a capture error":
        error = compiled.CaptureError("capture failed")
        error.__cause__ = torch.cuda.OutOfMemoryError("CUDA out of memory")
    elif error == "kernel under a capture error":
        error = compiled.CaptureError("capture failed")
        error.__context__ = KernelError("flash_attention sm90 kernel launch failed")

    def run(self, inputs):
        raise error

    monkeypatch.setattr(compiled._Loop, "run", run)
    assert not degrade.is_compile_failure(error)
    before = _rungs("compile-eager")
    noise, ctx = (torch.from_numpy(a) for a in _inputs())
    with pytest.raises(type(error)):
        run_sampler(ptoy, noise, ctx, sampler="euler", steps=2, compile_loop=True)
    assert _rungs("compile-eager") == before


def test_only_capture_failures_classify_as_compile_failures():
    assert degrade.is_compile_failure(compiled.CaptureError("capture failed"))
    assert issubclass(compiled.CaptureError, RuntimeError)
    # Message matching, as the JAX classifier does, would take a build failure's
    # "compil" for a compile failure; the port classifies by type.
    assert not degrade.is_compile_failure(RuntimeError("compilation failed"))
    assert jdegrade.is_compile_failure(RuntimeError("compilation failed"))


@pytest.fixture(scope="module")
def tiny_flux():
    cfg = pflux.FluxConfig(**TINY_FLUX, dtype=torch.float32)
    return pflux.build_flux(cfg, device="cpu", generator=torch.Generator().manual_seed(5))


def _flux_inputs():
    g = torch.Generator().manual_seed(0)
    return (torch.randn((1, 8, 8, 4), generator=g), torch.ones((1,)),
            torch.randn((1, 16, 32), generator=g)), {"y": torch.randn((1, 16), generator=g)}


def test_stream_recarve_is_recorded_with_the_stage_counts(tiny_flux, monkeypatch):
    sp = parallelize(tiny_flux, [("cpu", 100)], ParallelConfig(
        weight_sharding="stream", hbm_budget_bytes=params_nbytes(tiny_flux.module)))
    first = sp._get_streaming_runner()
    orig, calls = StreamingRunner.__call__, []

    def flaky(self, *a, **kw):
        if self is first and not calls:
            calls.append(1)
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return orig(self, *a, **kw)

    monkeypatch.setattr(StreamingRunner, "__call__", flaky)
    before = _rungs("stream-recarve")
    tracing.enable()
    args, kw = _flux_inputs()
    out = sp(*args, **kw)
    deeper = sp._stream_runner
    assert deeper.n_stages > first.n_stages and _rungs("stream-recarve") == before + 1
    [span] = [e for e in tracing.export()["traceEvents"] if e.get("name") == "degradation"]
    assert span["args"]["rung"] == "stream-recarve"
    assert (span["args"]["stages_before"], span["args"]["stages_after"]) == (
        first.n_stages, deeper.n_stages)
    np.testing.assert_array_equal(out.numpy(), tiny_flux(*args, **kw).numpy())


def test_an_exhausted_stream_ladder_re_raises_the_original_error(tiny_flux, monkeypatch):
    sp = parallelize(tiny_flux, [("cpu", 100)], ParallelConfig(
        weight_sharding="stream", hbm_budget_bytes=params_nbytes(tiny_flux.module)))
    sp._get_streaming_runner()
    error = torch.cuda.OutOfMemoryError("CUDA out of memory at one segment a stage")
    monkeypatch.setattr(StreamingRunner, "__call__", lambda self, *a, **kw: (
        _ for _ in ()).throw(error))
    monkeypatch.setattr(StreamingRunner, "recarved", lambda self: None)
    before = _rungs("exhausted", ladder="stream-recarve")
    tracing.enable()
    args, kw = _flux_inputs()
    with pytest.raises(torch.cuda.OutOfMemoryError) as got:
        sp(*args, **kw)
    assert got.value is error
    assert _rungs("exhausted", ladder="stream-recarve") == before + 1
    [span] = [e for e in tracing.export()["traceEvents"] if e.get("name") == "degradation"]
    assert span["args"] == {**span["args"], "rung": "exhausted", "ladder": "stream-recarve"}
    assert degrade.ladder_exhausted("stream-recarve", error) is None
