"""The PyTorch port's continuous-batching serving with flow prediction, against the
JAX package on the CPU: a tiny FLUX-dev (numpy weights from a seed for the JAX
module's abstract tree, carried to the port by ``convert_jax``) served by both
packages' schedulers on the same seats (``auto=False``, every request seated before
the first dispatch): euler, dpmpp_2m and heun lanes with guidance and per-request
pooled vectors, in stacked cond and kwargs rows, f32, rtol/atol 2e-4 relative to
the latent's scale. Then, in the port alone, the same model streamed (a
weight-streaming ``ParallelModel``) runs its lanes in a width-1 eager bucket. The
helpers are ``tests/test_torch_serving.py``'s.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401
from test_torch_quick_jax import quick_jax_compiles  # noqa: E402,F401
from test_torch_serving import _close, _hermetic, _np, _tree, sched, serve  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from comfyui_parallelanything_tpu.models import flux as jflux  # noqa: E402
from comfyui_parallelanything_tpu.sampling.runner import run_sampler as jax_run_sampler  # noqa: E402
from comfyui_parallelanything_tpu.serving import (  # noqa: E402
    ContinuousBatchingScheduler as JaxScheduler,
)
from comfyui_parallelanything_tpu_torch import parallelize  # noqa: E402
from comfyui_parallelanything_tpu_torch.models import flux as pflux  # noqa: E402
from comfyui_parallelanything_tpu_torch.models import loader as ploader  # noqa: E402
from comfyui_parallelanything_tpu_torch.models.convert_jax import from_jax_params  # noqa: E402
from comfyui_parallelanything_tpu_torch.parallel.orchestrator import ParallelConfig  # noqa: E402
from comfyui_parallelanything_tpu_torch.sampling.runner import run_sampler  # noqa: E402

FLUX = dict(hidden_size=64, num_heads=2, depth=1, depth_single_blocks=1, mlp_ratio=2.0,
            context_in_dim=32, vec_in_dim=16, axes_dim=(8, 12, 12), in_channels=16)
FLUX_TXT = 6


@pytest.fixture(scope="module")
def flux_pair():
    jcfg = jflux.flux_dev_config(**FLUX, guidance_embed=True, dtype=jnp.float32)
    tree = _tree(jflux.flux_abstract_params(jcfg, sample_shape=(1, 8, 8, 4), txt_len=FLUX_TXT), 11)
    jm = jflux.build_flux(jcfg, params=jax.tree.map(jnp.asarray, tree))
    pm = pflux.build_flux(pflux.flux_dev_config(**FLUX, guidance_embed=True,
                                                dtype=torch.float32),
                          device="cpu", state_dict=from_jax_params(tree))
    return jm, pm


FLUX_SEATS = [(1, "euler", 3), (2, "dpmpp_2m", 4), (3, "heun", 2)]


def test_flow_prediction_lanes_with_guidance_match_jax(flux_pair, sched):
    jm, pm = flux_pair
    reqs = [dict(noise=_np(s, (1, 8, 8, 4)), ctx=_np(s + 10, (1, FLUX_TXT, 32)),
                 y=_np(s + 20, (1, 16)), sampler=sa, steps=n) for s, sa, n in FLUX_SEATS]

    def port_run(r):
        return run_sampler(pm, torch.from_numpy(r["noise"]), torch.from_numpy(r["ctx"]),
                           sampler=r["sampler"], steps=r["steps"], prediction="flow",
                           shift=3.0, guidance=3.5, y=torch.from_numpy(r["y"]))

    def modes(s):
        [bucket] = s.buckets.values()
        # Per-request conds, y and guidance: stacked rows.
        assert (bucket._cond_mode, bucket._kw_mode) == ("stacked", "stacked")

    got = serve(sched, [lambda r=r: port_run(r) for r in reqs], after_first_pump=modes)
    assert sched.total_dispatches() == 4
    sched.uninstall()

    def jax_run(r):
        return np.asarray(jax_run_sampler(
            jm, jnp.asarray(r["noise"]), jnp.asarray(r["ctx"]), sampler=r["sampler"],
            steps=r["steps"], prediction="flow", shift=3.0, guidance=3.5,
            y=jnp.asarray(r["y"])))

    jsched = JaxScheduler(max_width=4, auto=False).install()
    try:
        want = serve(jsched, [lambda r=r: jax_run(r) for r in reqs])
    finally:
        jsched.uninstall()
        jsched.shutdown()
    for g, w in zip(got, want):
        _close(g, w)


def test_a_streaming_model_runs_width_one_eager(flux_pair, sched):
    _, pm = flux_pair
    sp = parallelize(pm, [("cpu", 100)], ParallelConfig(
        weight_sharding="stream", hbm_budget_bytes=ploader.params_nbytes(pm.module) // 3))
    assert sp.is_streaming and sp.serving_bucket_width(4) == 1
    x = torch.from_numpy(_np(90, (1, 8, 8, 4)))
    ctx = torch.from_numpy(_np(91, (1, FLUX_TXT, 32)))
    y = torch.from_numpy(_np(92, (1, 16)))

    def run(sampler):
        return run_sampler(sp, x, ctx, sampler=sampler, steps=2, prediction="flow", shift=3.0,
                           guidance=3.5, y=y)

    got = serve(sched, [lambda: run("euler"), lambda: run("heun")])
    [bucket] = sched.buckets.values()
    assert bucket.width == 1 and bucket.spec is None and bucket.dispatch_count == 2 + 3
    sched.uninstall()
    _close(got[0], run("euler"))
    _close(got[1], run("heun"))
    sp.cleanup()
