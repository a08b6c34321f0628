"""Batch==1 pipeline placement and microbatched pipelining in the PyTorch port
(``parallel/pipeline.py``, the orchestrator's pipeline routes) against the JAX
package's ``PipelineRunner`` and ``_pipeline_microbatch``, on the CPU.

The ports of ``tests/test_pipeline.py`` and ``tests/test_pipeline_microbatch.py``:
a tiny FLUX (2 double + 3 single blocks), a tiny SD1.5-like UNet and a tiny
SD3-like MMDiT, each with the same numpy weights on both sides, over 2-4 ``cpu:i``
links with uneven weights. Stage ranges must equal JAX's, and outputs JAX's and
the monolithic forward's at f32 rtol/atol 2e-4. A stage's placement is checked on
the ``meta`` device, where a copy costs no memory.
"""

import functools
import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import comfyui_parallelanything_tpu as jpa  # noqa: E402
from comfyui_parallelanything_tpu.models import flux as jflux  # noqa: E402
from comfyui_parallelanything_tpu.parallel import pipeline as jpipe  # noqa: E402
from comfyui_parallelanything_tpu.parallel import split as jsplit  # noqa: E402
from comfyui_parallelanything_tpu_torch import ParallelConfig, parallelize  # noqa: E402
from comfyui_parallelanything_tpu_torch.models import flux as pflux  # noqa: E402
from comfyui_parallelanything_tpu_torch.models.convert_jax import from_jax_params  # noqa: E402
from comfyui_parallelanything_tpu_torch.parallel import chain as chain_mod  # noqa: E402
from comfyui_parallelanything_tpu_torch.parallel import pipeline as ppipe  # noqa: E402
from comfyui_parallelanything_tpu_torch.parallel import split as psplit  # noqa: E402
from comfyui_parallelanything_tpu_torch.sampling.runner import run_sampler  # noqa: E402

from test_torch_flux import LATENT, SMALL, TXT, _numpy_params  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
STAGED = dict(SMALL, depth=2, depth_single_blocks=3)  # 5 segments
T = torch.from_numpy


@pytest.fixture(autouse=True)
def _hermetic(monkeypatch, tmp_path):
    monkeypatch.setenv("PA_PLANNER", "0")
    monkeypatch.setenv("PA_LEDGER_DIR", str(tmp_path / "ledger"))
    monkeypatch.setenv("PA_EVIDENCE_DIR", str(tmp_path / "evidence"))


@functools.cache
def _flux():
    """(JAX model, port model) of the staged FLUX, the same numpy weights."""
    jcfg = jflux.flux_dev_config(**STAGED, dtype=jnp.float32)
    params = _numpy_params(jcfg, seed=3)
    jm = jflux.build_flux(jcfg, params=jax.tree.map(jnp.asarray, params))
    pm = pflux.build_flux(pflux.flux_dev_config(**STAGED, dtype=torch.float32), device="cpu",
                          state_dict=from_jax_params(params))
    return jm, pm


def _flux_inputs(batch, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(batch, *LATENT)).astype(np.float32),
            rng.uniform(0.1, 1.0, size=(batch,)).astype(np.float32),
            rng.normal(size=(batch, TXT, SMALL["context_in_dim"])).astype(np.float32),
            {"y": rng.normal(size=(batch, SMALL["vec_in_dim"])).astype(np.float32)})


def _family(name):
    """(JAX model, port model, inputs(batch, seed)) for one family."""
    if name == "flux":
        return (*_flux(), _flux_inputs)
    if name == "unet":
        import test_torch_unet as tu

        jm, pm, _ = tu._pair("sd15_like")
        return jm, pm, lambda batch, seed: tu._inputs(seed, jm.config, batch=batch)
    import test_torch_mmdit as tm

    jm, pm, _ = tm._pair("sd3_medium_like")

    def inputs(batch, seed):
        x, t, ctx, y = tm._inputs(seed, batch=batch)
        return x, t, ctx, {"y": y}

    return jm, pm, inputs


@functools.cache
def _jax_chain():
    """The staged FLUX on two JAX links with ``pipeline_microbatches=3``: batch 1
    takes its pipeline runner, a batch of 3 the microbatched route."""
    jm, _ = _flux()
    return jpa.parallelize(jm, jpa.DeviceChain.even(["cpu:0", "cpu:1"]),
                           jpa.ParallelConfig(pipeline_microbatches=3))


def _jax_call(fn, x, t, ctx, kw, **extra):
    return np.asarray(fn(jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
                         **{k: jnp.asarray(v) for k, v in kw.items()}, **extra))


def _port_call(fn, x, t, ctx, kw, **extra):
    out = fn(T(x), T(t), T(ctx), **{k: T(v) for k, v in kw.items()}, **extra)
    return out.numpy()


def _runners(name, n, weights):
    jm, pm, inputs = _family(name)
    cpu = torch.device("cpu")
    jr = jpipe.build_pipeline_runner(jm.pipeline_spec, jm.params, jax.devices("cpu")[:n],
                                     weights)
    pr = ppipe.build_pipeline_runner(pm.pipeline_spec, pm.module, [cpu] * n, weights)
    return jm, pm, inputs, jr, pr


class _Doubler(torch.nn.Module):
    """A model with no pipeline spec; records the batch of every call."""

    def __init__(self):
        super().__init__()
        self.s = torch.nn.Parameter(torch.tensor(2.0))
        self.batches = []

    def forward(self, x, t, context=None, **kw):
        self.batches.append(x.shape[0])
        return x * self.s


def _host_links(monkeypatch):
    """Resolve every link to the CPU, so ``cuda:0`` forms a cuda group on the host."""
    monkeypatch.setattr(chain_mod, "get_device", lambda s: torch.device("cpu"))


class TestPipelineRunner:
    def test_staged_flux_equals_jax_runner_and_monolithic(self):
        _, _, _, jr3, pr3 = _runners("flux", 3, [0.5, 0.3, 0.2])
        assert pr3.n_stages == jr3.n_stages == 3
        assert [s.labels for s in pr3.stages] == [s.labels for s in jr3.stages]
        jpm, pm = _jax_chain(), _flux()[1]
        x, t, ctx, kw = _flux_inputs(1, 4)
        want = _jax_call(jpm, x, t, ctx, kw)  # batch 1: JAX's pipeline runner
        jr = jpm._pipeline_runner
        pr = ppipe.build_pipeline_runner(pm.pipeline_spec, pm.module, [torch.device("cpu")] * 2,
                                         list(jpm.weights))
        assert [s.labels for s in pr.stages] == [s.labels for s in jr.stages]
        got = _port_call(pr, x, t, ctx, kw)
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(got, _port_call(pm, x, t, ctx, kw), **TOL)

    @pytest.mark.parametrize("name", ["unet", "mmdit"])
    def test_staged_equals_jax_and_monolithic(self, name):
        # The UNet's staged output is held against the JAX forward; the MMDiT's
        # against the port's monolithic forward, which test_torch_mmdit holds against
        # JAX's at the same tolerance (a second JAX MMDiT compile here buys nothing).
        jm, pm, inputs, jr, pr = _runners(name, 3, [0.2, 0.5, 0.3])
        assert [s.labels for s in pr.stages] == [s.labels for s in jr.stages]
        x, t, ctx, kw = inputs(1, 5)
        got = _port_call(pr, x, t, ctx, kw)
        if name == "unet":
            np.testing.assert_allclose(got, _jax_call(jm, x, t, ctx, kw), **TOL)
        np.testing.assert_allclose(got, _port_call(pm, x, t, ctx, kw), **TOL)

    def test_uneven_weights_place_proportionally(self):
        _, _, _, jr, pr = _runners("flux", 3, [0.5, 0.25, 0.25])
        # 5 segments at 50/25/25 → 3/1/1 by the largest remainder, as in JAX.
        assert [len(s.labels) for s in pr.stages] == [len(s.labels) for s in jr.stages] \
            == [3, 1, 1]
        assert pr.ranges == jsplit.block_ranges(5, [0.5, 0.25, 0.25]) \
            == psplit.block_ranges(5, [0.5, 0.25, 0.25])

    def test_zero_weight_device_holds_no_stage(self):
        _, _, _, jr, pr = _runners("flux", 3, [0.5, 0.0, 0.5])
        assert pr.n_stages == jr.n_stages == 2
        assert [s.range for s in pr.stages] == [(0, 3), (3, 5)]

    def test_single_device_or_no_spec_returns_none(self):
        _, pm = _flux()
        cpu = torch.device("cpu")
        assert ppipe.build_pipeline_runner(pm.pipeline_spec, pm.module, [cpu], [1.0]) is None
        assert ppipe.build_pipeline_runner(None, pm.module, [cpu, cpu], [0.5, 0.5]) is None
        assert jpipe.build_pipeline_runner(None, {}, jax.devices("cpu")[:2], [0.5, 0.5]) is None

    def test_each_stage_places_only_its_own_segments(self):
        # A stage on another device gets copies of its own blocks only; prepare,
        # finalize and a stage on the model's device reuse the model's submodules.
        _, pm = _flux()
        mod = pm.module
        cpu, meta = torch.device("cpu"), torch.device("meta")
        pr = ppipe.PipelineRunner(pm.pipeline_spec, mod, [cpu, meta], [0.6, 0.4])
        (s0, s1) = pr.stages
        assert s0.range == (0, 3) and s1.range == (3, 5)
        assert s0.module.double_blocks[0] is mod.double_blocks[0]
        assert s0.module.single_blocks[0] is mod.single_blocks[0]
        for i in (1, 2):
            assert all(p.device == meta for p in s1.module.single_blocks[i].parameters())
        assert s1.module.single_blocks[0] is mod.single_blocks[0]  # not the stage's: shared
        assert s1.module.img_in is mod.img_in
        assert all(p.device == cpu for p in mod.parameters())  # the source is untouched
        assert pr._prepare.img_in is mod.img_in and pr._finalize.final_proj is mod.final_proj
        with pytest.raises(KeyError, match="not in the model"):
            ppipe._stage_view([mod], ["nope.0"], cpu)


class TestRouterIntegration:
    def test_batch1_routes_through_pipeline(self):
        _, pm = _flux()
        ppm = parallelize(pm, [(f"cpu:{i}", 25) for i in range(4)])
        x, t, ctx, kw = _flux_inputs(1, 6)
        got = _port_call(ppm, x, t, ctx, kw)
        runner, calls = ppm._pipeline_runner, []
        assert runner is not None and runner.n_stages == 4
        ppm._pipeline_runner = lambda *a, **k: calls.append(a[0].shape[0]) or runner(*a, **k)
        again = _port_call(ppm, x, t, ctx, kw)
        assert calls == [1]
        np.testing.assert_allclose(got, _port_call(pm, x, t, ctx, kw), **TOL)
        np.testing.assert_array_equal(again, got)

    def test_workload_split_off_skips_pipeline(self):
        _, pm = _flux()
        ppm = parallelize(pm, [(f"cpu:{i}", 25) for i in range(4)],
                          ParallelConfig(workload_split=False))
        x, t, ctx, kw = _flux_inputs(1, 7)
        out = _port_call(ppm, x, t, ctx, kw)
        assert ppm._pipeline_runner is None and out.shape == x.shape

    def test_batch1_without_spec_runs_single_device(self):
        ppm = parallelize(_Doubler(), [(f"cpu:{i}", 25) for i in range(4)])
        out = ppm(torch.ones((1, 4)), torch.zeros((1,)))
        assert out.shape == (1, 4) and ppm._pipeline_runner is None
        assert ppm._pipeline_spec is None

    def test_pipeline_handles_static_kwargs(self):
        _, pm = _flux()
        ppm = parallelize(pm, [(f"cpu:{i}", 25) for i in range(4)])
        x, t, ctx, kw = _flux_inputs(1, 8)
        out = _port_call(ppm, x, t, ctx, kw, debug_tag="a-string")
        np.testing.assert_allclose(out, _port_call(pm, x, t, ctx, kw), **TOL)

    def test_step_oom_demotes_and_lifecycle_drops_the_runner(self, monkeypatch):
        _, pm = _flux()
        ppm = parallelize(pm, [("cpu:0", 50), ("cpu:1", 50)])
        x, t, ctx, kw = _flux_inputs(1, 9)
        want = _port_call(pm, x, t, ctx, kw)
        _port_call(ppm, x, t, ctx, kw)
        assert ppm._pipeline_runner is not None
        ppm.rebalance()
        assert ppm._pipeline_runner is None  # stage ranges follow the weights

        def oom(*a, **k):
            raise torch.cuda.OutOfMemoryError("stage out of memory")

        monkeypatch.setattr(ppipe.PipelineRunner, "__call__", oom)
        np.testing.assert_allclose(_port_call(ppm, x, t, ctx, kw), want, **TOL)
        assert not ppm.active and ppm._pipeline_runner is None
        ppm.cleanup()
        assert ppm._pipeline_runner is None

    def test_compile_loop_on_a_host_stage_chain_runs_the_eager_pipeline(self, monkeypatch,
                                                                       caplog):
        # cuda:0 + cpu: a heterogeneous chain has no single captured loop, so the
        # sampler runs eager and each batch-1 step takes the pipeline.
        _host_links(monkeypatch)
        _, pm = _flux()
        ppm = parallelize(pm, [("cuda:0", 60), ("cpu", 40)])
        x, _, ctx, kw = _flux_inputs(1, 10)
        with caplog.at_level(logging.INFO):
            got = run_sampler(ppm, T(x), T(ctx), sampler="flow_euler", steps=2, guidance=3.5,
                              compile_loop=True, y=T(kw["y"]))
        assert "heterogeneous chain" in caplog.text
        assert ppm._pipeline_runner is not None and ppm._pipeline_runner.n_stages == 2
        want = run_sampler(pm, T(x), T(ctx), sampler="flow_euler", steps=2, guidance=3.5,
                           y=T(kw["y"]))
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


class TestMicrobatchedPipeline:
    def _ppm(self, mb, n=4):
        _, pm = _flux()
        return pm, parallelize(pm, [(f"cpu:{i}", 100 / n) for i in range(n)],
                               ParallelConfig(pipeline_microbatches=mb))

    def test_matches_jax_and_single_device(self):
        # Batch 3 over 3 microbatches: JAX runs the chunks through the stage
        # programs its batch-1 call compiled.
        x, t, ctx, kw = _flux_inputs(3, 11)
        want = _jax_call(_jax_chain(), x, t, ctx, kw)
        pm, ppm = self._ppm(3, n=2)
        got = _port_call(ppm, x, t, ctx, kw)
        assert ppm._pipeline_runner is not None and ppm._pipeline_runner.n_stages == 2
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(got, _port_call(pm, x, t, ctx, kw), **TOL)

    def test_even_microbatches(self):
        pm, ppm = self._ppm(4)
        x, t, ctx, kw = _flux_inputs(8, 12)
        np.testing.assert_allclose(_port_call(ppm, x, t, ctx, kw),
                                   _port_call(pm, x, t, ctx, kw), **TOL)

    def test_uneven_batch_pads_to_uniform_chunks(self):
        pm, ppm = self._ppm(3)
        x, t, ctx, kw = _flux_inputs(7, 13)
        _port_call(ppm, x, t, ctx, kw)  # builds the runner
        orig, seen = ppm._pipeline_runner, []

        class Spy:
            n_stages = orig.n_stages

            def __call__(self, xi, ti, ci=None, **k):
                seen.append(xi.shape[0])
                return orig(xi, ti, ci, **k)

        ppm._pipeline_runner = Spy()
        got = _port_call(ppm, x, t, ctx, kw)
        assert seen == [3, 3, 3]  # 7 rows padded to 9
        np.testing.assert_allclose(got, _port_call(pm, x, t, ctx, kw), **TOL)

    def test_no_spec_falls_through_to_data_parallel(self):
        ppm = parallelize(_Doubler(), [(f"cpu:{i}", 25) for i in range(4)],
                          ParallelConfig(pipeline_microbatches=4))
        x = torch.ones((8, 4))
        np.testing.assert_allclose(ppm(x, torch.ones((8,))).numpy(), 2.0 * x.numpy())
        assert ppm._pipeline_runner is None and ppm._module.batches == [2, 2, 2, 2]

    def test_batch_below_microbatch_count_routes_normally(self):
        pm, ppm = self._ppm(8)
        x, t, ctx, kw = _flux_inputs(4, 14)
        got = _port_call(ppm, x, t, ctx, kw)
        assert ppm._pipeline_runner is None  # data parallel over the 4 links
        np.testing.assert_allclose(got, _port_call(pm, x, t, ctx, kw), **TOL)

    def test_default_config_unchanged_routing(self):
        _, pm = _flux()
        ppm = parallelize(pm, [(f"cpu:{i}", 25) for i in range(4)])
        x, t, ctx, kw = _flux_inputs(8, 15)
        got = _port_call(ppm, x, t, ctx, kw)
        assert ppm._pipeline_runner is None
        np.testing.assert_allclose(got, _port_call(pm, x, t, ctx, kw), **TOL)
