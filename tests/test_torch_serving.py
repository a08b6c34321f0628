"""The PyTorch port's continuous-batching serving (``serving/``,
``sampling/compiled.lane_step_program``, the ``run_sampler`` seam) against the JAX
package on the CPU.

A tiny SD1.5-like UNet (numpy weights from a seed for the JAX module's abstract
tree, carried to the port by ``convert_jax``) served by both packages' schedulers on
the same seats, with ``auto=False`` and ``pump()``: a ragged concurrent batch of
mixed deterministic samplers with CFG lanes and a mid-flight join. Both sides in
f32, held to rtol/atol 2e-4 relative to the latent's scale (``_close``). The JAX
lane program compiles once (one bucket width, every request seated before the
first dispatch, so one cond mode), with XLA's optimisation passes off for the
module. Then, in the port on the converted UNet: every deterministic ``LANE_SPECS``
sampler co-batched against the same request alone in a bucket of the same width
(bitwise) and against the inline sampler (f32 tolerance); every stochastic one
against the inline ``run_sampler`` with the same generator (its noise is the inline
draws, made at seat time) and bitwise alone against co-batched.

Flow prediction and a streaming model: ``tests/test_torch_serving_flux.py``; the
port held to itself (masks, shared cond, cancel, policy, fallbacks, the OOM ladder,
the decode queue, many submitters): ``tests/test_torch_serving_lanes.py``. Both
share this file's helpers.
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401
from test_torch_quick_jax import quick_jax_compiles  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from comfyui_parallelanything_tpu.models import unet as ju  # noqa: E402
from comfyui_parallelanything_tpu.sampling.runner import run_sampler as jax_run_sampler  # noqa: E402
from comfyui_parallelanything_tpu.serving import (  # noqa: E402
    ContinuousBatchingScheduler as JaxScheduler,
)
from comfyui_parallelanything_tpu_torch.models import unet as pu  # noqa: E402
from comfyui_parallelanything_tpu_torch.models.convert_jax import (  # noqa: E402
    from_jax_unet_params,
)
from comfyui_parallelanything_tpu_torch.sampling import lane_specs as pls  # noqa: E402
from comfyui_parallelanything_tpu_torch.sampling.runner import run_sampler  # noqa: E402
from comfyui_parallelanything_tpu_torch.serving import (  # noqa: E402
    ContinuousBatchingScheduler,
    get_decode_queue,
    get_scheduler,
)
from comfyui_parallelanything_tpu_torch.utils.metrics import registry  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
UNET = dict(model_channels=16, channel_mult=(1, 2), num_res_blocks=1, attention_levels=(0,),
            transformer_depth=(1, 0), num_heads=2, context_dim=16, norm_groups=8)
LATENT = (1, 8, 8, 4)  # per request, NHWC
CTX = (1, 5, 16)
CFG = 5.0
DETERMINISTIC = [n for n, s in pls.LANE_SPECS.items() if not s.needs_rng]
STOCHASTIC = [n for n, s in pls.LANE_SPECS.items() if s.needs_rng]


@pytest.fixture(autouse=True)
def _hermetic(monkeypatch, tmp_path):
    monkeypatch.setenv("PA_PLANNER", "0")
    monkeypatch.setenv("PA_LEDGER_DIR", str(tmp_path / "ledger"))
    monkeypatch.setenv("PA_EVIDENCE_DIR", str(tmp_path / "evidence"))
    yield
    assert get_scheduler() is None and get_decode_queue() is None


def _tree(abstract, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(a.shape[:-1])) if a.ndim == 4 else (
                a.shape[0] * a.shape[1] if path[-2].key.endswith("_o") else a.shape[0])
            return (rng.normal(size=a.shape) / np.sqrt(fan_in)).astype(np.float32)
        base = 1.0 if name in ("scale",) or name.endswith("_norm") else 0.0
        return (base + 0.1 * rng.normal(size=a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, abstract)


@pytest.fixture(scope="module")
def unet_pair():
    jcfg = ju.UNetConfig(**UNET, dtype=jnp.float32)
    abstract = jax.eval_shape(ju.UNet2D(jcfg).init, jax.random.key(0), jnp.zeros(LATENT),
                              jnp.ones((1,)), jnp.zeros(CTX))["params"]
    tree = _tree(abstract, 3)
    jm = ju.build_unet(jcfg, params=jax.tree.map(jnp.asarray, tree))
    pm = pu.build_unet(pu.UNetConfig(**UNET, dtype=torch.float32), device="cpu",
                       state_dict=from_jax_unet_params(tree))
    return jm, pm


def _np(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def unet_request(seed, sampler, steps, **kw):
    """The numpy inputs of one CFG request: noise, cond, uncond."""
    return dict(noise=_np(seed, LATENT), ctx=_np(seed + 100, CTX), unc=_np(seed + 200, CTX),
                sampler=sampler, steps=steps, **kw)


def port_unet_run(pm, r, **extra):
    kw = dict(sampler=r["sampler"], steps=r["steps"], cfg_scale=CFG,
              uncond_context=torch.from_numpy(r["unc"]))
    if "gen_seed" in r:
        kw["rng"] = torch.Generator().manual_seed(r["gen_seed"])
    return run_sampler(pm, torch.from_numpy(r["noise"]), torch.from_numpy(r["ctx"]),
                       **kw, **extra)


def _bg(fn):
    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:  # noqa: BLE001 - re-raised by the caller
            box["err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, box


def _enqueued(sched) -> int:
    with sched._lock:
        return sum(len(b.queue) + len(b.active_lanes()) for b in sched.buckets.values())


def _wait_enqueued(sched, n, timeout=30.0):
    t0 = time.monotonic()
    while _enqueued(sched) < n:
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"never saw {n} requests")
        time.sleep(0.002)


def _join(jobs):
    out = []
    for t, box in jobs:
        t.join(30)
        if "err" in box:
            raise box["err"]
        out.append(box["out"])
    return out


def serve(sched, calls, later=(), pumps_before_later=2, after_first_pump=None):
    """Run ``calls`` (zero-argument callables) as concurrent submitters on a manual
    scheduler: all enqueued before the first dispatch, ``later`` submitted after
    ``pumps_before_later`` dispatches; then drain. ``after_first_pump(sched)`` looks
    at the buckets mid-run. Returns results in order."""
    jobs = [_bg(c) for c in calls]
    _wait_enqueued(sched, len(calls))
    if after_first_pump is not None:
        sched.pump()
        after_first_pump(sched)
    if later:
        for _ in range(pumps_before_later):
            sched.pump()
        seated = _enqueued(sched)
        jobs += [_bg(c) for c in later]
        _wait_enqueued(sched, seated + len(later))
    sched.drain()
    return _join(jobs)


@pytest.fixture
def sched():
    s = ContinuousBatchingScheduler(max_width=4, auto=False).install()
    try:
        yield s
    finally:
        s.shutdown()


def _counter(name: str) -> float:
    """A counter summed over its label sets."""
    return sum(float(line.rsplit(" ", 1)[1]) for line in registry.render().splitlines()
               if line.startswith(name + "{") or line.startswith(name + " "))


def _close(got, want):
    """rtol/atol 2e-4 relative to the latent's scale (its largest magnitude, at least
    1), as the graph parity files hold latents: a random UNet does not cancel the
    start noise, so its latents end near 90 and f32's last bits there are 1e-5."""
    g, w = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert g.shape == w.shape
    scale = max(1.0, float(np.abs(w).max()))
    np.testing.assert_allclose(g / scale, w / scale, **TOL)


# ---------------------------------------------------------------------------
# the port's scheduler against the JAX scheduler, on the same seats
# ---------------------------------------------------------------------------

UNET_SEATS = [(1, "euler", 3), (2, "dpmpp_2m", 5), (3, "heun", 3), (4, "euler", 2)]
UNET_JOIN = (5, "dpmpp_2m", 4)


def test_ragged_mixed_cfg_batch_with_a_mid_flight_join_matches_jax(unet_pair, sched):
    jm, pm = unet_pair
    reqs = [unet_request(*s) for s in UNET_SEATS]
    join = unet_request(*UNET_JOIN)
    got = serve(sched, [lambda r=r: port_unet_run(pm, r) for r in reqs],
                later=[lambda: port_unet_run(pm, join)])
    port_dispatches = sched.total_dispatches()
    sched.uninstall()

    def jax_run(r):
        return np.asarray(jax_run_sampler(
            jm, jnp.asarray(r["noise"]), jnp.asarray(r["ctx"]), sampler=r["sampler"],
            steps=r["steps"], cfg_scale=CFG, uncond_context=jnp.asarray(r["unc"])))

    jsched = JaxScheduler(max_width=4, auto=False).install()
    try:
        want = serve(jsched, [lambda r=r: jax_run(r) for r in reqs],
                     later=[lambda: jax_run(join)])
        assert jsched.total_dispatches() == port_dispatches
    finally:
        jsched.uninstall()
        jsched.shutdown()
    # heun 3 steps is 5 evals; the join seats when euler-2 retires and runs 4 more.
    assert port_dispatches == 6
    for g, w in zip(got, want):
        assert g.shape == LATENT
        _close(g, w)


# ---------------------------------------------------------------------------
# the port alone
# ---------------------------------------------------------------------------


def test_deterministic_lanes_bitwise_alone_and_cobatched_and_close_to_inline(unet_pair, sched):
    _, pm = unet_pair
    assert DETERMINISTIC == ["euler", "heun", "dpm_2", "dpmpp_2m"]
    reqs = [unet_request(10 + i, s, 3) for i, s in enumerate(DETERMINISTIC)]
    together = serve(sched, [lambda r=r: port_unet_run(pm, r) for r in reqs])
    alone = [serve(sched, [lambda r=r: port_unet_run(pm, r)])[0] for r in reqs]
    sched.uninstall()
    for r, t, a in zip(reqs, together, alone):
        assert torch.equal(t, a), r["sampler"]
        _close(t, port_unet_run(pm, r))


def test_stochastic_lanes_match_inline_and_are_bitwise_alone_and_cobatched(unet_pair, sched):
    _, pm = unet_pair
    assert set(STOCHASTIC) == {"euler_ancestral", "dpm_2_ancestral", "dpmpp_2s_ancestral",
                               "dpmpp_sde", "dpmpp_2m_sde", "dpmpp_3m_sde", "lcm", "ddpm"}
    reqs = [unet_request(30 + i, s, 3, gen_seed=30 + i) for i, s in enumerate(STOCHASTIC)]
    together = serve(sched, [lambda r=r: port_unet_run(pm, r) for r in reqs])
    alone = [serve(sched, [lambda r=r: port_unet_run(pm, r)])[0] for r in reqs[:2]]
    sched.uninstall()
    for r, t, a in zip(reqs, together, alone):
        assert torch.equal(t, a), r["sampler"]
    for r, t in zip(reqs, together):
        _close(t, port_unet_run(pm, r))
