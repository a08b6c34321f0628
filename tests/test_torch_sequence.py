"""Sequence parallelism of the PyTorch port (``parallel/sequence.py``, the
``sequence_parallel`` context of ``ops/attention.py`` and its guards) against the
JAX package on the CPU.

Ring and Ulysses attention over 4 ``cpu:i`` shards against JAX
``sequence_parallel_attention`` on a 4-device ``seq`` mesh, the ring over 8 too, at
rtol/atol 2e-4; a tiny FLUX forward under the ring and a tiny Wan forward under
Ulysses against the JAX forwards under the same context, at ``test_torch_flux.py``'s
2e-4. Then the errors and the context's reach: it restores on exit; under it a
``ParallelModel`` has no captured loop (``traceable()`` is None, so
``compile_loop=True`` runs the eager loop), a serving width of 1, skips the batch-1
pipeline, and the pipeline and streaming runners raise. The same seeded numpy
inputs go to both sides; weights are carried by ``models/convert_jax.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_quick_jax import quick_jax_compiles  # noqa: E402,F401
from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from comfyui_parallelanything_tpu.models import flux as jflux  # noqa: E402
from comfyui_parallelanything_tpu.models import wan as jwan  # noqa: E402
from comfyui_parallelanything_tpu.ops.attention import (  # noqa: E402
    sequence_parallel as jax_sequence_parallel,
)
from comfyui_parallelanything_tpu.parallel import mesh as jmesh  # noqa: E402
from comfyui_parallelanything_tpu.parallel import sequence as jseq  # noqa: E402
from comfyui_parallelanything_tpu_torch import parallelize  # noqa: E402
from comfyui_parallelanything_tpu_torch.models import flux as pflux  # noqa: E402
from comfyui_parallelanything_tpu_torch.models import wan as pwan  # noqa: E402
from comfyui_parallelanything_tpu_torch.models.convert_jax import (  # noqa: E402
    from_jax_params,
    from_jax_wan_params,
)
from comfyui_parallelanything_tpu_torch.ops import attention as pattn  # noqa: E402
from comfyui_parallelanything_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from comfyui_parallelanything_tpu_torch.parallel import sequence as pseq  # noqa: E402
from comfyui_parallelanything_tpu_torch.parallel.orchestrator import (  # noqa: E402
    ParallelConfig,
)
from comfyui_parallelanything_tpu_torch.sampling import compiled  # noqa: E402
from comfyui_parallelanything_tpu_torch.sampling.runner import run_sampler  # noqa: E402

from test_torch_flux import _numpy_params  # noqa: E402
from test_torch_wan import _numpy_tree  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
FLUX = dict(in_channels=16, hidden_size=64, num_heads=4, depth=1, depth_single_blocks=1,
            mlp_ratio=2.0, context_in_dim=32, vec_in_dim=16, axes_dim=(4, 6, 6),
            guidance_embed=False)
WAN = dict(in_channels=4, out_channels=4, hidden_size=48, ffn_dim=96, num_heads=4, depth=1,
           text_dim=32, freq_dim=32)


@pytest.fixture(autouse=True)
def _hermetic(monkeypatch, tmp_path):
    monkeypatch.setenv("PA_PLANNER", "0")
    monkeypatch.setenv("PA_LEDGER_DIR", str(tmp_path / "ledger"))
    monkeypatch.setenv("PA_EVIDENCE_DIR", str(tmp_path / "evidence"))


@pytest.fixture(scope="module")
def meshes(cpu_devices):
    return {n: (jmesh.build_mesh(cpu_devices[:n], {"seq": n}),
                pmesh.build_mesh([f"cpu:{i}" for i in range(n)], {"seq": n})) for n in (4, 8)}


def _qkv(B=2, S=32, H=4, D=8, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(B, S, H, D)).astype(np.float32) for _ in range(3))


@pytest.mark.parametrize("method,n,shape", [("ring", 4, (2, 32, 4, 8)),
                                            ("ulysses", 4, (2, 32, 4, 8)),
                                            ("ring", 8, (1, 128, 2, 8))])
def test_attention_matches_jax(meshes, method, n, shape):
    q, k, v = _qkv(*shape, seed=n)
    jm, pm = meshes[n]
    want = np.asarray(jseq.sequence_parallel_attention(q, k, v, jm, method=method))
    got = pseq.sequence_parallel_attention(*(torch.from_numpy(a) for a in (q, k, v)), pm,
                                           method=method)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    plain = pattn.attention_local(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)


def test_errors_and_the_context_restores(meshes):
    pm = meshes[4][1]
    q = torch.zeros(2, 30, 4, 8)
    with pytest.raises(ValueError, match="not divisible"):
        pseq.sequence_parallel_attention(q, q, q, pm, method="ring")
    q = torch.zeros(2, 32, 3, 8)
    with pytest.raises(ValueError, match="divisible"):
        pseq.sequence_parallel_attention(q, q, q, pm, method="ulysses")
    with pytest.raises(ValueError, match="unknown"):
        pseq.sequence_parallel_attention(q, q, q, pm, method="spiral")
    assert pattn.sequence_ctx_key() is None
    with pattn.sequence_parallel(pm, method="ulysses"):
        assert pattn.sequence_ctx_key() == (pm, "seq", "ulysses")
        with pattn.sequence_parallel(pm):
            assert pattn.sequence_ctx_key()[2] == "ring"
        assert pattn.sequence_ctx_key()[2] == "ulysses"
    assert pattn.sequence_ctx_key() is None


@pytest.fixture(scope="module")
def flux_pair():
    jcfg = jflux.flux_dev_config(**FLUX, dtype=jnp.float32)
    tree = _numpy_params(jcfg, seed=21)
    jm = jflux.build_flux(jcfg, params=jax.tree.map(jnp.asarray, tree))
    pm = pflux.build_flux(pflux.flux_dev_config(**FLUX, dtype=torch.float32), device="cpu",
                          state_dict=from_jax_params(tree))
    return jm, pm


def _flux_inputs(seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(1, 8, 8, 4)).astype(np.float32), np.array([0.5], np.float32),
            rng.normal(size=(1, 16, 32)).astype(np.float32),
            rng.normal(size=(1, 16)).astype(np.float32))


def test_flux_forward_under_the_ring_matches_jax(flux_pair, meshes):
    jm, pm = flux_pair
    x, t, ctx, y = _flux_inputs()
    with jax_sequence_parallel(meshes[4][0], method="ring"):
        want = np.asarray(jm(x, t, ctx, y=y))
    calls = []
    with pattn.sequence_parallel(meshes[4][1], method="ring"):
        real = pseq._METHODS["ring"]
        pseq._METHODS["ring"] = lambda *a: calls.append(1) or real(*a)
        try:
            got = pm(*(torch.from_numpy(a) for a in (x, t, ctx)), y=torch.from_numpy(y))
        finally:
            pseq._METHODS["ring"] = real
    assert len(calls) == 2  # one double and one single block
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_wan_forward_under_ulysses_matches_jax(meshes):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(1, 2, 8, 8, 4)).astype(np.float32)  # 32 tokens
    t = np.array([0.5], np.float32)
    ctx = rng.normal(size=(1, 8, 32)).astype(np.float32)
    jcfg = jwan.WanConfig(**WAN, dtype=jnp.float32)
    abstract = jax.eval_shape(jwan.WanModel(jcfg).init, jax.random.key(0), x, t, ctx)["params"]
    tree = _numpy_tree(abstract, 5)
    jm = jwan.build_wan(jcfg, params=jax.tree.map(jnp.asarray, tree))
    pm = pwan.build_wan(pwan.WanConfig(**WAN, dtype=torch.float32), device="cpu",
                        state_dict=from_jax_wan_params(tree))
    with jax_sequence_parallel(meshes[4][0], method="ulysses"):
        want = np.asarray(jm(x, t, ctx))
    with pattn.sequence_parallel(meshes[4][1], method="ulysses"):
        got = pm(*(torch.from_numpy(a) for a in (x, t, ctx)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_a_parallel_model_under_the_context(flux_pair, meshes):
    model = flux_pair[1]
    x, t, ctx, y = (torch.from_numpy(a) for a in _flux_inputs())
    with torch.no_grad():
        plain = model.module(x, t, ctx, y=y)
    pm = parallelize(model, [("cpu:0", 50), ("cpu:1", 50)])
    seq = meshes[4][1]
    with pattn.sequence_parallel(seq, method="ulysses"):
        assert pm.traceable() is None and pm.serving_bucket_width(4) == 1
        got = pm(x, t, ctx, y=y)  # batch 1: single-device, not the pipeline
        assert pm._pipeline_runner is None
        compiled.clear_compiled_loops()
        loop = run_sampler(pm, x, ctx, sampler="flow_euler", steps=2, y=y, compile_loop=True)
        assert compiled.loop_records() == []
        eager = run_sampler(pm, x, ctx, sampler="flow_euler", steps=2, y=y)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
    torch.testing.assert_close(loop, eager, rtol=0, atol=0)
    assert pm.traceable() is not None and pm.serving_bucket_width(4) == 4
    runner = pm._get_pipeline_runner()
    torch.testing.assert_close(runner(x, t, ctx, y=y), plain, **TOL)
    with pattn.sequence_parallel(seq), pytest.raises(ValueError, match="pipeline block"):
        runner(x, t, ctx, y=y)
    streamed = parallelize(model, [("cpu", 100)],
                           ParallelConfig(weight_sharding="stream", hbm_budget_bytes=1 << 20))
    with pattn.sequence_parallel(seq), pytest.raises(ValueError, match="weight streaming"):
        streamed(x, t, ctx, y=y)
    pm.cleanup()
    streamed.cleanup()


@pytest.mark.parametrize("model,per_forward", [("flux", 57 * 4), ("wan", 60 * 4)])
def test_full_width_ulysses_launches_sm90_per_head_slice(monkeypatch, model, per_forward):
    # chip_smoke's parallel_axes phase on the meta device: FLUX-dev at 1024² and
    # Wan2.1-T2V-1.3B at 480×832×81 (CFG's batch 2) under 4-shard Ulysses make
    # every attention call four head-slice calls, each a strided view that K1's
    # sm90 variant takes. One block of each list stands for its depth.
    import dataclasses
    from collections import Counter

    from comfyui_parallelanything_tpu_torch.ops.kernels import flash_attention as fa

    seen = Counter()

    def spy(q, k, v, scale=None):
        assert not q.is_contiguous()
        seen[(fa.kernel_variant(q, k, v, scale), tuple(q.shape), tuple(k.shape))] += 1
        return torch.empty_like(q)

    monkeypatch.setattr(pattn, "attention_local", spy)
    meta = torch.device("meta")
    mesh = pmesh.build_mesh([meta] * 4, {"seq": 4})
    with torch.device(meta), pattn.sequence_parallel(mesh, method="ulysses"):
        if model == "flux":
            full = pflux.flux_dev_config()
            cfg = dataclasses.replace(full, depth=1, depth_single_blocks=1)
            m = pflux.FluxModel(cfg)
            out = m(torch.empty(1, 128, 128, 16), torch.empty(1),
                    torch.empty(1, 512, cfg.context_in_dim), y=torch.empty(1, cfg.vec_in_dim),
                    guidance=torch.empty(1))
            depth = full.depth + full.depth_single_blocks
            calls = {("sm90", (1, 4608, 6, 128), (1, 4608, 6, 128)): 2 * 4}
        else:
            full = pwan.wan_1_3b_config()
            m = pwan.WanModel(dataclasses.replace(full, depth=1))
            out = m(torch.empty(2, 21, 60, 104, 16), torch.empty(2), torch.empty(2, 512, 4096))
            depth = full.depth
            calls = {("sm90", (2, 32760, 3, 128), (2, 32760, 3, 128)): 4,
                     ("sm90", (2, 32760, 3, 128), (2, 512, 3, 128)): 4}
    assert out.is_meta and dict(seen) == calls
    assert sum(seen.values()) * depth // (2 if model == "flux" else 1) == per_forward
