"""The PyTorch port's numerics sentinel (``utils/numerics.py``) against the JAX
package's on the CPU, and its wiring into the port's serving lanes, loops and
streaming runner.

- ``digest`` / ``lane_digest`` / ``latent_fingerprint`` equal the JAX package's bit
  for bit on the same seeded numpy arrays: float32 and bf16 inputs, odd sizes,
  values on bf16 rounding edges (NaN digests are not compared: NaN payloads may
  differ between the packages' conversions).
- ``array_stats`` / ``lane_stats`` agree within 1e-6 relative with NaN and Inf
  planted.
- ``bisect_nonfinite`` names the same block as the JAX one for the tiny UNet of
  ``tests/test_torch_serving.py`` with one segment's weight poisoned (weights carried
  by ``convert_jax``; the JAX side's stage functions jitted so each compiles once).
- The quarantine: a ``lane-nan`` fault plan at lane 2 of a width-4 bucket gives that
  submitter ``NonFiniteLatent`` with the block ``lane-input``, the three survivors
  bitwise their uninjected runs, and exact ``pa_numerics_*`` and
  ``pa_fault_injected_total`` counters; each lane's per-eval digests end at
  ``digest()`` of its result.
- The loops: the captured loop's body (run uncaptured on the CPU) and the eager loop
  fingerprint the same latent alike; the sentinel flag is part of the loop key.
- The streaming runner counts each stage's non-finite elements; a poisoned stage is
  named.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401
from test_torch_quick_jax import quick_jax_compiles  # noqa: E402,F401
from test_torch_serving import (  # noqa: E402,F401
    CFG,
    CTX,
    LATENT,
    UNET,
    _bg,
    _hermetic,
    _np,
    _tree,
    _wait_enqueued,
    sched,
    unet_request,
)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from comfyui_parallelanything_tpu.models import unet as ju  # noqa: E402
from comfyui_parallelanything_tpu.sampling.k_samplers import model_sigmas as jax_model_sigmas  # noqa: E402
from comfyui_parallelanything_tpu.sampling.schedules import (  # noqa: E402
    scaled_linear_schedule as jax_schedule,
)
from comfyui_parallelanything_tpu.utils import numerics as jn  # noqa: E402
from comfyui_parallelanything_tpu_torch import ParallelConfig, parallelize  # noqa: E402
from comfyui_parallelanything_tpu_torch.models import loader as ploader  # noqa: E402
from comfyui_parallelanything_tpu_torch.models import unet as pu  # noqa: E402
from comfyui_parallelanything_tpu_torch.models.convert_jax import (  # noqa: E402
    from_jax_unet_params,
)
from comfyui_parallelanything_tpu_torch.sampling import compiled  # noqa: E402
from comfyui_parallelanything_tpu_torch.sampling.k_samplers import model_sigmas  # noqa: E402
from comfyui_parallelanything_tpu_torch.sampling.runner import run_sampler  # noqa: E402
from comfyui_parallelanything_tpu_torch.sampling.schedules import (  # noqa: E402
    scaled_linear_schedule,
)
from comfyui_parallelanything_tpu_torch.utils import faults  # noqa: E402
from comfyui_parallelanything_tpu_torch.utils import numerics as pn  # noqa: E402
from comfyui_parallelanything_tpu_torch.utils.metrics import registry  # noqa: E402


@pytest.fixture(autouse=True)
def _sentinel_off():
    pn.disable()
    pn.sentinel.reset()
    yield
    pn.disable()
    pn.sentinel.reset()
    faults.reload()


def _edges(shape, seed):
    """Seeded values with bf16 rounding edges planted: halfway between two bf16
    numbers (ties to even both ways), just off halfway, and subnormals."""
    a = (np.random.default_rng(seed).normal(size=shape) * 7).astype(np.float32)
    flat = a.reshape(-1)
    edges = np.asarray([1.0 + 2**-8, 1.0 + 3 * 2**-8, -(2.0 + 2**-7), 1.0 + 2**-8 + 2**-20,
                        3e-39, -1e-40, 65504.0, 0.0, -0.0], np.float32)
    flat[:min(len(edges), flat.size)] = edges[:flat.size]
    return a


SHAPES = [(1,), (7,), (3, 5, 7), (2, 8, 8, 4), (1, 33, 17, 3), (4, 1, 13)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_digests_equal_jax_bit_for_bit(shape, dtype):
    a = _edges(shape, len(shape) * 11 + shape[-1])
    t = torch.from_numpy(a)
    j = jnp.asarray(a)
    if dtype == "bfloat16":
        t, j = t.bfloat16(), j.astype(jnp.bfloat16)
    assert int(pn.digest(t)) == int(np.asarray(jn.digest(j)))
    assert pn.latent_fingerprint(t) == jn.latent_fingerprint(j)
    if len(shape) > 1:
        np.testing.assert_array_equal(pn.lane_digest(t).numpy(),
                                      np.asarray(jn.lane_digest(j)).astype(np.int64))
        # Lane-local positions: a lane's digest is its digest alone.
        assert int(pn.lane_digest(t)[-1]) == int(pn.digest(t[-1]))


@pytest.mark.parametrize("plant", ["clean", "nan", "inf", "both"])
def test_stats_agree_with_jax(plant):
    a = (np.random.default_rng(4).normal(size=(3, 6, 5, 4)) * 3).astype(np.float32)
    extra = np.random.default_rng(5).normal(size=(3, 6, 5, 4)).astype(np.float32)
    if plant in ("nan", "both"):
        a[1, 2, 3, 0] = np.nan
        extra[2, 0, 0, 1] = np.nan
    if plant in ("inf", "both"):
        a[0, 0, 0, 0] = np.inf
        a[2, 1, 1, 1] = -np.inf
    got = pn.array_stats(torch.from_numpy(a)).numpy()
    want = np.asarray(jn.array_stats(jnp.asarray(a)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    got = pn.lane_stats(torch.from_numpy(a), extra=torch.from_numpy(extra)).numpy()
    want = np.asarray(jn.lane_stats(jnp.asarray(a), extra=jnp.asarray(extra)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    got_d, want_d = pn.stats_to_dict(got[1]), jn.stats_to_dict(want[1])
    assert got_d.keys() == want_d.keys() and got_d["nonfinite"] == want_d["nonfinite"]
    np.testing.assert_allclose([got_d[k] for k in pn.STAT_FIELDS],
                               [want_d[k] for k in pn.STAT_FIELDS], rtol=1e-6)
    tree = {"a": torch.from_numpy(a), "b": [torch.from_numpy(extra), torch.ones(3)]}
    jtree = {"a": jnp.asarray(a), "b": [jnp.asarray(extra), jnp.ones(3)]}
    assert pn.tree_nonfinite(tree) == jn.tree_nonfinite(jtree)


def test_the_sentinel_records_and_reads(monkeypatch, tmp_path):
    before = (registry.get("pa_numerics_nonfinite_total", {"where": "unit"}) or 0.0,
              registry.get("pa_numerics_quarantined_total", {"bucket": "b"}) or 0.0)
    pn.enable()
    assert pn.on() and pn.sentinel.snapshot()["fingerprint_gate"] is None
    pn.sentinel.record_event("unit", nonfinite=3)
    pn.sentinel.record_quarantine(bucket="b", lane=1, step=2)
    snap = pn.sentinel.snapshot()
    assert snap["enabled"] and snap["nonfinite_events"] == 1 and snap["quarantined_lanes"] == 1
    assert snap["last_event"]["where"] == "unit" and snap["last_quarantine"]["lane"] == 1
    assert registry.get("pa_numerics_nonfinite_total", {"where": "unit"}) == before[0] + 1
    assert registry.get("pa_numerics_quarantined_total", {"bucket": "b"}) == before[1] + 1
    pn.sentinel.publish_gauges()
    assert registry.get("pa_numerics_sentinel_enabled") == 1.0
    assert registry.get("pa_numerics_quarantined_lanes") == 1.0
    (tmp_path / pn.GATE_FILENAME).write_text(json.dumps({"verdict": "pass"}))
    monkeypatch.setenv("PA_LEDGER_DIR", str(tmp_path))
    assert pn.gate_status() == {"verdict": "pass"}
    pn.sentinel.reset()
    assert pn.sentinel.snapshot()["nonfinite_events"] == 0
    pn.disable()
    assert not pn.on()


# -- bisection against the JAX package ---------------------------------------------


@pytest.fixture(scope="module")
def poisoned_pair():
    """The tiny UNet pair with the middle block's first convolution poisoned (one
    NaN), the JAX spec's stage functions jitted."""
    jcfg = ju.UNetConfig(**UNET, dtype=jnp.float32)
    abstract = jax.eval_shape(ju.UNet2D(jcfg).init, jax.random.key(0), jnp.zeros(LATENT),
                              jnp.ones((1,)), jnp.zeros(CTX))["params"]
    tree = _tree(abstract, 3)
    tree["mid_res1"]["Conv_0"]["kernel"] = tree["mid_res1"]["Conv_0"]["kernel"].copy()
    tree["mid_res1"]["Conv_0"]["kernel"][0, 0, 0, 0] = np.nan
    jm = ju.build_unet(jcfg, params=jax.tree.map(jnp.asarray, tree))
    spec = jm.pipeline_spec
    jm = dataclasses.replace(jm, pipeline_spec=dataclasses.replace(
        spec, prepare=jax.jit(spec.prepare), finalize=jax.jit(spec.finalize, static_argnums=2),
        segments=tuple(dataclasses.replace(s, fn=jax.jit(s.fn)) for s in spec.segments)))
    pm = pu.build_unet(pu.UNetConfig(**UNET, dtype=torch.float32), device="cpu",
                       state_dict=from_jax_unet_params(tree))
    return jm, pm


@pytest.mark.parametrize("case", ["poisoned-block", "lane-input"])
def test_bisection_names_the_jax_block(poisoned_pair, case):
    jm, pm = poisoned_pair
    xe = _np(7, LATENT)
    if case == "lane-input":
        xe[0, 1, 2, 3] = np.nan
    ctx = _np(8, CTX)
    jlog = jnp.log(jax_model_sigmas(jax_schedule()))
    want = jn.bisect_nonfinite(jm, jnp.asarray(xe), 3.5, "eps", jlog, jnp.asarray(ctx))
    got = pn.bisect_nonfinite(pm, torch.from_numpy(xe), 3.5, "eps",
                              torch.log(model_sigmas(scaled_linear_schedule())),
                              torch.from_numpy(ctx))
    assert got["block"] == want["block"] == ("lane-input" if case == "lane-input" else "middle")
    assert got.get("segment_index") == want.get("segment_index")
    assert got["sigma"] == want["sigma"]


# -- the quarantine in the port's serving lanes ----------------------------------


@pytest.fixture(scope="module")
def unet():
    return pu.build_unet(pu.UNetConfig(**UNET, dtype=torch.float32), device="cpu",
                         generator=torch.Generator().manual_seed(3))


def _lanes(s, model, n=4, steps=4):
    reqs = [unet_request(300 + i, "euler", steps) for i in range(n)]

    def call(r):
        return run_sampler(model, torch.from_numpy(r["noise"]), torch.from_numpy(r["ctx"]),
                           sampler="euler", steps=steps, cfg_scale=CFG,
                           uncond_context=torch.from_numpy(r["unc"]))

    jobs = []
    for i, r in enumerate(reqs):  # in order: request i sits in slot i every run
        jobs.append(_bg(lambda r=r: call(r)))
        _wait_enqueued(s, i + 1)
    s.drain()
    out = []
    for t, box in jobs:
        t.join(30)
        out.append(box.get("err", box.get("out")))
    return out


def _count(name, **labels):
    return registry.get(name, labels) or 0.0


def test_a_poisoned_lane_is_quarantined_and_its_neighbours_keep_their_bits(
        unet, sched, monkeypatch, tmp_path):
    clean = _lanes(sched, unet)
    assert pn.sentinel.recent_fingerprints() == []  # sentinel off: nothing recorded
    pn.enable()
    monkeypatch.setenv("PA_FAULT_PLAN", json.dumps([{"site": "lane-nan", "match": "2"}]))
    monkeypatch.setenv("PA_LEDGER_DIR", str(tmp_path))
    label = None
    before = {}

    def counts():
        return (_count("pa_numerics_nonfinite_total", where="serving-lane"),
                _count("pa_fault_injected_total", site="lane-nan"))

    before = counts()
    got = _lanes(sched, unet)
    assert isinstance(got[2], pn.NonFiniteLatent)
    for i in (0, 1, 3):
        assert torch.equal(got[i], clean[i]), i
    q = pn.sentinel.last_quarantine
    label = q["bucket"]
    assert q["lane"] == 2 and q["step"] == 0 and q["bundle"] is None
    assert q["first_nonfinite"]["block"] == "lane-input"
    assert q["stats"]["nonfinite"] >= 1
    assert counts() == (before[0] + 1, before[1] + 1)
    assert _count("pa_numerics_quarantined_total", bucket=label) == 1.0
    assert pn.sentinel.quarantined_count == 1
    # Each survivor's per-eval digests end at digest() of its own result.
    rings = [rec for rec in pn.sentinel.recent_fingerprints() if "rid" in rec]
    assert sorted(len(rec["digests"]) for rec in rings) == [1, 4, 4, 4]  # lane 2: one
    finals = sorted(rec["digests"][-1] for rec in rings if len(rec["digests"]) == 4)
    assert finals == sorted(int(pn.digest(got[i])) for i in (0, 1, 3))


def test_the_loops_fingerprint_their_latent_and_key_on_the_flag(unet):
    r = unet_request(400, "euler", 3)
    x, c, u = (torch.from_numpy(r[k]) for k in ("noise", "ctx", "unc"))
    kw = dict(sampler="euler", steps=3, cfg_scale=CFG, uncond_context=u)
    compiled.clear_compiled_loops()
    off = run_sampler(unet, x, c, compile_loop=True, **kw)
    loops = len(compiled.loop_records())
    pn.enable()
    on = run_sampler(unet, x, c, compile_loop=True, **kw)
    assert len(compiled.loop_records()) == loops + 1  # the flag keys a new loop
    eager = run_sampler(unet, x, c, **kw)
    assert torch.equal(on, off) and torch.equal(on, eager)
    ring = {rec["where"]: rec["digests"] for rec in pn.sentinel.recent_fingerprints()}
    assert ring["loop:k:euler"] == ring["eager:k:euler"] == [int(pn.digest(on))]
    compiled.clear_compiled_loops()


def test_the_streaming_runner_names_a_poisoned_stage(unet, monkeypatch):
    x, c = torch.from_numpy(_np(9, LATENT)), torch.from_numpy(_np(10, CTX))
    t = torch.tensor([500.0])
    sp = parallelize(unet, [("cpu", 100)], ParallelConfig(
        weight_sharding="stream", hbm_budget_bytes=ploader.params_nbytes(unet.module)))
    pn.enable()
    sp(x, t, c)
    runner = sp._stream_runner
    assert runner.last_stage_counts == [0] * (runner.n_stages + 1)
    assert pn.sentinel.event_count == 0
    # The same model with one weight of stage 1's first block poisoned.
    stage = runner.stages[1]
    poisoned = pu.build_unet(pu.UNetConfig(**UNET, dtype=torch.float32), device="cpu",
                             generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        next(poisoned.module.get_submodule(stage.keys[0]).parameters()).view(-1)[0] = \
            float("nan")
    sp2 = parallelize(poisoned, [("cpu", 100)], ParallelConfig(
        weight_sharding="stream", hbm_budget_bytes=ploader.params_nbytes(unet.module)))
    events = []
    record = pn.sentinel.record_event
    monkeypatch.setattr(pn.sentinel, "record_event",
                        lambda where, **info: events.append((where, info)) or record(where, **info))
    sp2(x, t, c)
    counts = sp2._stream_runner.last_stage_counts
    assert counts[0] == 0 and all(n > 0 for n in counts[1:])
    # Every stage from the poisoned one on, then the output (the JAX vocabulary).
    assert [(w, i["stage"]) for w, i in events] == [
        ("stream-stage", k) for k in range(1, runner.n_stages - 1)] + [
        ("stream-output", runner.n_stages - 1)]
    assert events[0][1]["blocks"] == ",".join(stage.labels)


def test_a_width_one_eager_lane_is_quarantined_too(unet, sched, monkeypatch, tmp_path):
    """A streaming model's bucket runs the width-1 eager mode: with the sentinel on,
    the lane-nan plan at lane 0 quarantines its one lane (``lane-input``, the
    denoiser's own log-sigma table) and a second request after it runs clean."""
    sp = parallelize(unet, [("cpu", 100)], ParallelConfig(
        weight_sharding="stream", hbm_budget_bytes=ploader.params_nbytes(unet.module)))
    pn.enable()
    monkeypatch.setenv("PA_FAULT_PLAN", json.dumps([{"site": "lane-nan", "match": "0"}]))
    monkeypatch.setenv("PA_LEDGER_DIR", str(tmp_path))
    got = _lanes(sched, sp, n=2, steps=2)
    [bucket] = sched.buckets.values()
    assert bucket.width == 1
    assert isinstance(got[0], pn.NonFiniteLatent) and torch.isfinite(got[1]).all()
    q = pn.sentinel.last_quarantine
    assert q["lane"] == 0 and q["first_nonfinite"]["block"] == "lane-input"
    rings = [r for r in pn.sentinel.recent_fingerprints() if "rid" in r]
    assert [len(r["digests"]) for r in rings] == [1, 2]
    assert rings[1]["digests"][-1] == int(pn.digest(got[1]))
