"""The PyTorch port's fault registry (``utils/faults.py``) against the JAX package's
on the CPU: the same plans parse to the same specs (and fail with the same
messages), the same plan fires at the same hits over the same calls (equal
``fired()`` dicts), the one arming rule, the legacy aliases; then the port's sites:
``stream-prefetch-oom`` takes the ``stream-recarve`` rung, ``compile-fail`` the
``compile-eager`` rung (each with an output bitwise the uninjected one), ``lane-nan``
through ``numerics.take_injection``, ``slow-host`` and ``backend-http`` in the
server.
"""

import dataclasses
import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

from comfyui_parallelanything_tpu.utils import faults as jf  # noqa: E402
from comfyui_parallelanything_tpu_torch import ParallelConfig, parallelize  # noqa: E402
from comfyui_parallelanything_tpu_torch.models import loader as ploader  # noqa: E402
from comfyui_parallelanything_tpu_torch.models import unet as pu  # noqa: E402
from comfyui_parallelanything_tpu_torch.parallel.orchestrator import is_out_of_memory  # noqa: E402
from comfyui_parallelanything_tpu_torch.sampling.runner import run_sampler  # noqa: E402
from comfyui_parallelanything_tpu_torch.utils import faults as pf  # noqa: E402
from comfyui_parallelanything_tpu_torch.utils import numerics  # noqa: E402
from comfyui_parallelanything_tpu_torch.utils.metrics import registry  # noqa: E402

UNET = dict(model_channels=16, channel_mult=(1, 2), num_res_blocks=1, attention_levels=(0,),
            transformer_depth=(1, 0), num_heads=2, context_dim=16, norm_groups=8)

PLANS = [
    [{"site": "lane-nan", "match": "2"}],
    {"seed": 7, "faults": [{"site": "backend-http", "match": "/prompt", "count": 2,
                            "mode": "5xx"},
                           {"site": "slow-host", "delay_s": 0.5, "nth": 3, "count": None},
                           {"site": "compile-fail"}]},
    json.dumps({"seed": 3, "faults": [{"site": "stream-prefetch-oom", "match": "1"},
                                      {"site": "journal-corrupt", "mode": "truncate"}]}),
]
BAD = ["{not json", 5, [{"match": "x"}], [{"site": "no-such-site"}]]


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ("PA_FAULT_PLAN", "PA_FAIL_INJECT", "PA_LEDGER_DIR", "PA_EVIDENCE_DIR"):
        monkeypatch.delenv(k, raising=False)
    yield
    monkeypatch.undo()
    pf.reload()
    numerics.sentinel.reset()


def _registry_value(name, **labels):
    return registry.get(name, labels) or 0.0


def test_the_site_vocabulary_is_the_jax_one():
    assert set(pf.FAULT_SITES) == set(jf.FAULT_SITES)


@pytest.mark.parametrize("plan", range(len(PLANS)))
def test_plans_parse_as_jax_parses_them(plan):
    raw = PLANS[plan]
    seed, specs = pf.parse_plan(raw)
    jseed, jspecs = jf.parse_plan(raw)
    assert seed == jseed
    assert [dataclasses.asdict(s) for s in specs] == [dataclasses.asdict(s) for s in jspecs]
    assert [s.resolved_nth(seed) for s in specs] == [s.resolved_nth(seed) for s in jspecs]


@pytest.mark.parametrize("bad", range(len(BAD)))
def test_bad_plans_fail_as_jax_fails(bad):
    with pytest.raises(pf.FaultPlanError) as got:
        pf.parse_plan(BAD[bad])
    with pytest.raises(jf.FaultPlanError) as want:
        jf.parse_plan(BAD[bad])
    assert str(got.value) == str(want.value)


def test_a_plan_fires_at_the_same_hits_as_jax():
    plan = {"seed": 11, "faults": [
        {"site": "backend-http", "match": "/prompt", "nth": 2, "count": 2, "mode": "drop"},
        {"site": "backend-http", "mode": "delay", "delay_s": 0.0},
        {"site": "slow-host", "count": None},
        {"site": "stream-prefetch-oom", "match": "3", "nth": 1},
    ]}
    calls = [("backend-http", "POST /prompt"), ("backend-http", "GET /queue"),
             ("backend-http", "POST /prompt"), ("slow-host", "p1"),
             ("backend-http", "POST /prompt"), ("backend-http", "POST /prompt"),
             ("stream-prefetch-oom", "1"), ("stream-prefetch-oom", "3"),
             ("stream-prefetch-oom", "3"), ("slow-host", "p2"), ("slow-host", "p3"),
             ("slow-host", "p4"), ("slow-host", "p5"), ("compile-fail", "euler")]
    seed, specs = pf.parse_plan(plan)
    port = pf.FaultRegistry(seed, specs)
    jseed, jspecs = jf.parse_plan(plan)
    ref = jf.FaultRegistry(jseed, jspecs)

    def trail(reg):
        out = []
        for site, key in calls:
            act = reg.check(site, key)
            out.append(None if act is None else (act.site, act.mode, act.key, act.hit))
        return out

    assert trail(port) == trail(ref)
    assert port.fired() == ref.fired() and sum(port.fired().values()) > 3
    port.reset()
    assert port.fired() == {}


def test_disarmed_without_a_redirect_and_armed_with_one(monkeypatch, tmp_path):
    monkeypatch.setenv("PA_FAULT_PLAN", json.dumps([{"site": "compile-fail", "nth": 1}]))
    for mod in (pf, jf):
        reg = mod.FaultRegistry.from_env()
        assert not reg.armed and reg.check("compile-fail", "k") is None
    monkeypatch.setenv("PA_LEDGER_DIR", str(tmp_path))
    for mod in (pf, jf):
        reg = mod.FaultRegistry.from_env()
        assert reg.armed and reg.check("compile-fail", "k").hit == 1


@pytest.mark.parametrize("value", ["nan:2", "nan:x", "oom"])
def test_legacy_aliases_as_jax(monkeypatch, tmp_path, value):
    monkeypatch.setenv("PA_FAIL_INJECT", value)
    monkeypatch.setenv("PA_EVIDENCE_DIR", str(tmp_path))
    port, ref = pf.FaultRegistry.from_env(), jf.FaultRegistry.from_env()
    assert [dataclasses.asdict(s) for s in port.specs] == \
        [dataclasses.asdict(s) for s in ref.specs]
    assert port.lane_nan_target() == ref.lane_nan_target()


def test_refresh_rereads_a_changed_environment(monkeypatch, tmp_path):
    assert not pf.refresh().armed
    monkeypatch.setenv("PA_FAIL_INJECT", "nan:1")
    monkeypatch.setenv("PA_LEDGER_DIR", str(tmp_path))
    reg = pf.refresh()
    assert reg.armed and reg is pf.registry and pf.refresh() is reg
    assert pf.active() and reg.lane_nan_target() == 1


def test_lane_nan_is_one_shot_and_attributed(monkeypatch, tmp_path):
    monkeypatch.setenv("PA_FAULT_PLAN", json.dumps([{"site": "lane-nan", "match": "2"}]))
    monkeypatch.setenv("PA_LEDGER_DIR", str(tmp_path))
    numerics.sentinel.reset()
    before = _registry_value("pa_fault_injected_total", site="lane-nan")
    assert numerics.take_injection([0, 1]) is None  # stays armed until lane 2 sits
    assert numerics.take_injection([0, 1, 2, 3]) == 2
    assert numerics.take_injection([2]) is None
    assert _registry_value("pa_fault_injected_total", site="lane-nan") == before + 1
    assert pf.fired() == {"lane-nan": 1}


def test_the_injected_oom_is_an_oom():
    act = pf.FaultAction(site="stream-prefetch-oom", mode=None, delay_s=0.0, key="1", hit=1,
                         spec=pf.FaultSpec(site="stream-prefetch-oom"))
    assert is_out_of_memory(pf.oom_error(act))


def _unet():
    return pu.build_unet(pu.UNetConfig(**UNET, dtype=torch.float32), device="cpu",
                         generator=torch.Generator().manual_seed(3))


def _inputs():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(1, 8, 8, 4)).astype(np.float32))
    ctx = torch.from_numpy(rng.normal(size=(1, 5, 16)).astype(np.float32))
    return x, ctx


def _arm(monkeypatch, tmp_path, *faults):
    monkeypatch.setenv("PA_FAULT_PLAN", json.dumps(list(faults)))
    monkeypatch.setenv("PA_LEDGER_DIR", str(tmp_path))
    return pf.reload()


def test_stream_prefetch_oom_takes_the_recarve_rung(monkeypatch, tmp_path):
    model = _unet()
    x, ctx = _inputs()
    t = torch.tensor([500.0])
    with torch.no_grad():
        want = model(x, t, ctx)
    budget = ploader.params_nbytes(model.module)
    sp = parallelize(model, [("cpu", 100)],
                     ParallelConfig(weight_sharding="stream", hbm_budget_bytes=budget))
    n0 = sp._get_streaming_runner().n_stages
    assert n0 >= 2
    rungs = _registry_value("pa_degradation_total", rung="stream-recarve")
    _arm(monkeypatch, tmp_path, {"site": "stream-prefetch-oom", "match": "1", "nth": 1})
    got = sp(x, t, ctx)
    assert sp._stream_runner.n_stages > n0
    assert _registry_value("pa_degradation_total", rung="stream-recarve") == rungs + 1
    assert pf.fired() == {"stream-prefetch-oom": 1}
    assert torch.equal(got, want)


def test_compile_fail_takes_the_compile_eager_rung(monkeypatch, tmp_path):
    model = _unet()
    x, ctx = _inputs()
    kw = dict(sampler="euler", steps=3, cfg_scale=3.0, uncond_context=torch.zeros_like(ctx))
    want = run_sampler(model, x, ctx, **kw)
    rungs = _registry_value("pa_degradation_total", rung="compile-eager")
    _arm(monkeypatch, tmp_path, {"site": "compile-fail", "nth": 1})
    got = run_sampler(model, x, ctx, compile_loop=True, **kw)
    assert _registry_value("pa_degradation_total", rung="compile-eager") == rungs + 1
    assert pf.fired() == {"compile-fail": 1}
    assert torch.equal(got, want)
    # One shot: the next call captures (on the CPU, runs the loop body).
    assert torch.equal(run_sampler(model, x, ctx, compile_loop=True, **kw), want)
    assert pf.fired() == {"compile-fail": 1}


def _http(url, method="GET", body=None):
    req = urllib.request.Request(url, method=method,
                                 data=None if body is None else json.dumps(body).encode())
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.loads(r.read() or b"null")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")


class _Noop:
    """An output node with no inputs: a prompt that runs in no time."""

    RETURN_TYPES = ()
    FUNCTION = "run"
    OUTPUT_NODE = True

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {}}

    def run(self):
        return ()


def test_slow_host_and_backend_http_sites(monkeypatch, tmp_path):
    import threading

    from comfyui_parallelanything_tpu_torch import server as pserver

    _arm(monkeypatch, tmp_path,
         {"site": "backend-http", "match": "GET /queue", "nth": 1, "mode": "5xx"},
         {"site": "backend-http", "match": "GET /history", "nth": 1, "mode": "drop"},
         {"site": "slow-host", "nth": 1, "delay_s": 0.4})
    srv, q = pserver.make_server(port=0, device="cpu", output_dir=str(tmp_path / "out"),
                                 class_mappings={"Noop": _Noop})
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        assert _http(f"{base}/queue")[0] == 500  # injected 5xx
        assert _http(f"{base}/queue")[0] == 200  # one shot
        with pytest.raises((urllib.error.URLError, ConnectionError, OSError)):
            urllib.request.urlopen(f"{base}/history", timeout=10).read()
        t0 = time.monotonic()
        status, doc = _http(f"{base}/prompt", "POST",
                            {"prompt": {"1": {"class_type": "Noop", "inputs": {}}}})
        assert status == 200
        pid = doc["prompt_id"]
        while pid not in _http(f"{base}/history")[1]:
            assert time.monotonic() - t0 < 30
            time.sleep(0.02)
        assert time.monotonic() - t0 >= 0.4
        assert pf.fired() == {"backend-http": 2, "slow-host": 1}
    finally:
        srv.shutdown()
        srv.server_close()
        q.shutdown()
