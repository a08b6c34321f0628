"""Span tracing in the PyTorch port (``utils/tracing.py`` and its instrumentation
sites) against the JAX package's ``utils/tracing.py`` on the CPU.

- The tracer: one script of ``span`` and ``record`` calls on two threads (nested
  spans, a cross-thread ``record`` with an explicit tid, two prompts, a ring that
  overflows, a retained prompt) drives a JAX ``Tracer`` and a port ``Tracer``; their
  exports are equal once ``ts``, ``dur``, span ids, tids and ``epoch_wall_s`` are
  normalised, whole and filtered by prompt. ``trace_aggregates`` and
  ``fleet_hop_p95_ms`` of one fixture agree to 1e-9, the traceparent helpers
  exactly. Off, ``span`` is the shared null object and no buffer is touched (the
  JAX ``TestTracerCore.test_disabled_is_noop`` contract), also through an eager
  sampler run.
- The instrumented paths, held to the vocabulary of the JAX sites: the eager
  sampler's ``sampler-run`` and ``step`` spans; two serving lanes seated through the
  scheduler with ``pump()``, whose ``lane-wait``, ``lane`` and ``step`` spans land on
  each submitter's timeline beside the dispatcher's ``serving-dispatch`` spans (JAX
  ``TestServingSpans``), with the ``lane_wait`` and ``decode_wait`` stages observed
  and the decode queue's ``decode-dispatch`` and per-waiter ``decode`` spans; a
  tiny streamed FLUX with one prefetch and one compute span per stage, the
  exposed-transfer waits apart from the computes and the overlap efficiency in
  [0, 1], and no span when tracing is off. The JAX streaming span test itself is
  red on this CPU backend ("Memory kind mismatch ... 'pinned_host'"), so the port is
  held to the names, nesting and one-span-per-stage of JAX
  ``parallel/streaming.py``, not to a JAX run.
- ``hardware_trace`` writes a ``torch.profiler`` Chrome trace whose ranges carry
  the span names; log records carry the span context's prompt and span ids.
- The server: ``GET /trace`` answers 200 with ``traceEvents``, ``enabled``,
  ``host_id``, ``role`` and ``epoch_wall_s`` and a prompt's timeline; ``PA_TRACE=1``
  and ``--trace`` turn tracing on instead of raising.
"""

import json
import logging
import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

from comfyui_parallelanything_tpu.utils import tracing as jtracing  # noqa: E402
from comfyui_parallelanything_tpu_torch import server as pserver  # noqa: E402
from comfyui_parallelanything_tpu_torch.models import flux as pflux  # noqa: E402
from comfyui_parallelanything_tpu_torch.models import unet as pu  # noqa: E402
from comfyui_parallelanything_tpu_torch.models import vae as pvae  # noqa: E402
from comfyui_parallelanything_tpu_torch.parallel import build_streaming_runner  # noqa: E402
from comfyui_parallelanything_tpu_torch.models.loader import params_nbytes  # noqa: E402
from comfyui_parallelanything_tpu_torch.sampling.runner import run_sampler  # noqa: E402
from comfyui_parallelanything_tpu_torch.serving import DecodeQueue  # noqa: E402
from comfyui_parallelanything_tpu_torch.utils import tracing  # noqa: E402
from comfyui_parallelanything_tpu_torch.utils.logging import ContextFilter  # noqa: E402
from comfyui_parallelanything_tpu_torch.utils.metrics import registry  # noqa: E402
from comfyui_parallelanything_tpu_torch.utils.progress import progress_scope  # noqa: E402

from test_torch_serving import (  # noqa: E402,F401
    UNET,
    _bg,
    _join,
    _wait_enqueued,
    port_unet_run,
    sched,
    unet_request,
)

# The JAX test's tiny FLUX (tests/test_streaming.py's TINY_FLUX) in the port.
TINY_FLUX = dict(in_channels=16, hidden_size=64, num_heads=4, depth=2, depth_single_blocks=4,
                 context_in_dim=32, vec_in_dim=16, axes_dim=(4, 6, 6), guidance_embed=False)


@pytest.fixture(autouse=True)
def _tracer_clean(monkeypatch, tmp_path):
    """Tracing is process-global: every test starts and ends off with empty buffers."""
    monkeypatch.setenv("PA_LEDGER_DIR", str(tmp_path / "ledger"))
    monkeypatch.setenv("PA_EVIDENCE_DIR", str(tmp_path / "evidence"))
    tracing.disable()
    tracing.tracer.clear()
    yield
    tracing.disable()
    tracing.tracer.clear()


def _x(export) -> list[dict]:
    return [e for e in export["traceEvents"] if e.get("ph") == "X"]


def _assert_nested_per_tid(events):
    """X events on one tid nest: each is inside or apart from the open span above
    it (1 µs of float-rounding slack), as the JAX test requires."""
    by_tid: dict[int, list] = {}
    for e in events:
        by_tid.setdefault(e["tid"], []).append(e)
    for tid, evs in by_tid.items():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack: list = []
        for e in evs:
            while stack and e["ts"] >= stack[-1]["ts"] + stack[-1]["dur"] - 1e-3:
                stack.pop()
            if stack:
                assert e["ts"] + e["dur"] <= stack[-1]["ts"] + stack[-1]["dur"] + 1.0, (
                    f"tid {tid}: span {e} escapes parent {stack[-1]}")
            stack.append(e)


# -- the tracer against the JAX tracer -------------------------------------------


def _script(mod, tr, other_tid):
    """The calls one tracer gets: spans on this thread, records onto another
    thread's tid, enough records to wrap an 8-slot ring, and a retained prompt."""
    with tr.span("prompt", cat="server", prompt_id="p1", host_id="h"):
        with tr.span("workflow-node", cat="graph", node="3", class_type="TPUKSampler"):
            with tr.span("sampler-run", cat="sampling", sampler="euler", steps=2):
                tr.record("step", mod.now_us(), 5.0, cat="sampling", step=1, of=2)
        with tr.span("workflow-node", cat="graph", node="4") as s:
            s.set(extra=1)
    tr.record("lane-wait", mod.now_us(), 7.0, cat="serving", tid=other_tid, prompt_id="p2",
              lane=0, bucket="b")
    for i in range(10):
        tr.record("tick", float(i), 1.0, cat="serving", prompt_id="p2", i=i)
    tr.retain_prompt("p1")
    with tr.trace_context(mod.format_traceparent("0af7651916cd43dd8448eb211c80319c", 7)):
        with tr.span("prompt", cat="server", prompt_id="p3"):
            pass


def _normalised(export) -> tuple:
    """An export with ts, dur, span ids, tids (by first appearance) and the wall
    anchor taken out, as a sorted tuple."""
    tids: dict[int, int] = {}
    for e in export["traceEvents"]:
        if "tid" in e:
            tids.setdefault(e["tid"], len(tids))
    rows = []
    for e in export["traceEvents"]:
        e = {k: v for k, v in e.items() if k not in ("ts", "dur", "pid")}
        if "tid" in e:
            e["tid"] = tids[e["tid"]]
        if e.get("name") == "thread_name":
            e["args"] = {"name": "thread"}
        args = {k: v for k, v in (e.get("args") or {}).items() if k != "span_id"}
        e["args"] = args
        rows.append(json.dumps(e, sort_keys=True))
    return tuple(sorted(rows)), export["displayTimeUnit"], set(export) - {"epoch_wall_s"}


def test_exports_equal_jax_on_one_script():
    jt, pt = jtracing.Tracer(), tracing.Tracer()
    jt.enable(capacity=8)
    pt.enable(capacity=8)
    main_tid = threading.get_ident()
    errors = []

    def other():
        try:
            for mod, tr in ((jtracing, jt), (tracing, pt)):
                with tr.span("decode", cat="serving", prompt_id="p2"):
                    tr.record("step", mod.now_us(), 3.0, cat="serving", tid=main_tid,
                              prompt_id="p1", lane=1)
        except Exception as e:  # noqa: BLE001 - raised below
            errors.append(e)

    t = threading.Thread(target=other, name="dispatcher")
    t.start()
    t.join()
    assert not errors
    for mod, tr in ((jtracing, jt), (tracing, pt)):
        _script(mod, tr, t.ident)
    assert _normalised(pt.export()) == _normalised(jt.export())
    for pid in ("p1", "p2", "p3", "nobody"):
        assert _normalised(pt.export(pid)) == _normalised(jt.export(pid)), pid
    # The ring held 8 spans of the main thread: the overflow is the same on both.
    assert len(_x(pt.export())) == len(_x(jt.export()))
    assert pt.dropped == jt.dropped
    ev = _x(pt.export("p3"))
    assert ev and ev[0]["args"]["trace_id"] == "0af7651916cd43dd8448eb211c80319c"


def test_disabled_is_noop():
    assert not tracing.on()
    s = tracing.span("anything", cat="x", foo=1)
    assert s is tracing._NULL
    assert tracing.span("other") is s
    with s as inner:
        assert inner is s
        inner.set(bar=2)
    tracing.record("x", 0.0, 1.0, foo="bar")
    tracing.defer(lambda at: pytest.fail("deferred while off"))
    assert tracing.tracer._buffers == {} and tracing.tracer._deferred == []
    assert _x(tracing.export()) == []
    assert tracing.current_span_id() is None
    # An eager sampler run with tracing off touches no buffer either.
    run_sampler(lambda x, t, context=None, **kw: x * 0.9, torch.ones((1, 4, 4, 4)),
                torch.ones((1, 3, 8)), sampler="euler", steps=2)
    assert tracing.tracer._buffers == {}


def test_aggregates_and_traceparent_equal_jax():
    events = []
    for r, (t0, dur) in enumerate([(0.0, 1000.0), (2000.0, 500.0)]):
        events.append({"ph": "X", "name": "stream-run", "ts": t0, "dur": dur, "tid": 1})
        events += [{"ph": "X", "name": "stream-stage-compute", "ts": t0 + 10 + 100 * i,
                    "dur": 60.0 + r, "tid": 1} for i in range(4)]
    events += [{"ph": "X", "name": "lane-wait", "ts": 5.0 * i, "dur": 1000.0 * (i % 7),
                "tid": 2} for i in range(23)]
    events += [{"ph": "X", "name": "step", "ts": 100.0 * i + (i % 3), "dur": 40.0,
                "tid": 3 + i % 2} for i in range(9)]
    events += [{"ph": "X", "name": "fleet-hop", "ts": 0.0, "dur": 1500.0 * i, "tid": 9}
               for i in range(5)]
    for fn in ("stream_overlap_efficiency", "lane_wait_p95_s", "host_gap_ms",
               "fleet_hop_p95_ms"):
        got, want = getattr(tracing, fn)(events), getattr(jtracing, fn)(events)
        assert got == pytest.approx(want, abs=1e-9), fn
    assert tracing.trace_aggregates({"traceEvents": events}) == pytest.approx(
        jtracing.trace_aggregates({"traceEvents": events}), abs=1e-9)
    for header in ("00-0af7651916cd43dd8448eb211c80319c-00f067aa0ba902b7-01", "junk",
                   "00-" + "0" * 32 + "-00f067aa0ba902b7-01", None, "01-a-b-c"):
        assert tracing.parse_traceparent(header) == jtracing.parse_traceparent(header)
    for args in (("0af7651916cd43dd8448eb211c80319c", 5), ("prompt-7", 1 << 70, False)):
        assert tracing.format_traceparent(*args) == jtracing.format_traceparent(*args)


# -- the instrumented paths -------------------------------------------------------


def test_eager_sampler_records_sampler_run_and_steps():
    tracing.enable()
    with progress_scope(prompt_id="p-eager"):
        run_sampler(lambda x, t, context=None, **kw: x * 0.9, torch.ones((1, 4, 4, 4)),
                    torch.ones((1, 3, 8)), sampler="euler", steps=3)
    xs = _x(tracing.export("p-eager"))
    run = [e for e in xs if e["name"] == "sampler-run"]
    steps = [e for e in xs if e["name"] == "step"]
    assert len(run) == 1 and run[0]["cat"] == "sampling"
    assert run[0]["args"]["sampler"] == "euler" and run[0]["args"]["steps"] == 3
    assert [e["args"]["step"] for e in steps] == [1, 2, 3]
    assert all(e["args"]["of"] == 3 and e["cat"] == "sampling" for e in steps)
    _assert_nested_per_tid(xs)
    assert registry.get("pa_trace_span_seconds", {"name": "step", "cat": "sampling"})


@pytest.fixture(scope="module")
def unet():
    return pu.build_unet(pu.UNetConfig(**UNET, dtype=torch.float32), device="cpu",
                         generator=torch.Generator().manual_seed(3))


def _stage_count(stage: str) -> float:
    got = registry.get("pa_slo_stage_seconds", {"stage": stage})
    return 0.0 if got is None else got[1]


def test_lane_wait_step_lane_on_submitter_timeline(unet, sched):
    tracing.enable()
    waits0 = _stage_count("lane_wait")
    tids = {}

    def worker(seed, steps):
        def go():
            with tracing.span("prompt", prompt_id=f"p{seed}"):
                tids[seed] = threading.get_ident()
                return port_unet_run(unet, unet_request(seed, "euler", steps))
        return go

    jobs = [_bg(worker(1, 2)), _bg(worker(2, 3))]
    _wait_enqueued(sched, 2)
    sched.drain()
    _join(jobs)
    xs = _x(tracing.export())
    for seed, steps in [(1, 2), (2, 3)]:
        mine = [e for e in xs if e["args"].get("prompt_id") == f"p{seed}"]
        names = [e["name"] for e in mine]
        assert names.count("step") == steps, names
        assert "lane-wait" in names and "lane" in names and "sampler-run" in names
        # Every span of the prompt sits on the submitter's timeline, though the
        # pumping thread recorded the serving ones.
        assert {e["tid"] for e in mine} == {tids[seed]}
        _assert_nested_per_tid(mine)
        lane = next(e for e in mine if e["name"] == "lane")
        assert lane["args"]["steps_run"] == steps and lane["args"]["outcome"] == "completed"
    disp = [e for e in xs if e["name"] == "serving-dispatch"]
    assert len(disp) == 3 and all(
        e["args"]["occupancy"] + e["args"]["masked_lanes"] == e["args"]["width"]
        for e in disp)
    assert _stage_count("lane_wait") == waits0 + 2


def test_decode_spans_on_each_waiter_and_decode_wait_stage():
    tracing.enable()
    cfg = pvae.VAEConfig(z_channels=4, base_channels=8, channel_mult=(1, 2), num_res_blocks=1,
                         norm_groups=4, dtype=torch.float32)
    vae = pvae.build_vae(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    dq = DecodeQueue(width=2, auto=False)
    waits0 = _stage_count("decode_wait")
    tickets = {}

    def submit(pid, seed):
        with progress_scope(prompt_id=pid):
            z = torch.from_numpy(np.random.default_rng(seed).normal(
                size=(1, 4, 4, 4)).astype(np.float32))
            tickets[pid] = (dq.submit(vae, z), threading.get_ident())

    for i, pid in enumerate(("d1", "d2")):
        t = threading.Thread(target=submit, args=(pid, i))
        t.start()
        t.join()
    assert dq.pump(force=True)
    for pid, (ticket, _) in tickets.items():
        assert ticket.result(5).shape[0] == 1
    xs = _x(tracing.export())
    assert [e["args"]["occupancy"] for e in xs if e["name"] == "decode-dispatch"] == [2]
    for pid, (_, tid) in tickets.items():
        [mine] = [e for e in xs if e["args"].get("prompt_id") == pid]
        assert mine["name"] == "decode" and mine["tid"] == tid and mine["cat"] == "serving"
    assert _stage_count("decode_wait") == waits0 + 2
    dq.shutdown()


@pytest.fixture(scope="module")
def tiny_flux():
    cfg = pflux.FluxConfig(**TINY_FLUX, dtype=torch.float32)
    return pflux.build_flux(cfg, device="cpu", generator=torch.Generator().manual_seed(5))


def _stream_call(model, overlap=True):
    runner = build_streaming_runner(model.pipeline_spec, model.module, "cpu",
                                    hbm_budget_bytes=params_nbytes(model.module) // 3,
                                    overlap=overlap)
    g = torch.Generator().manual_seed(0)
    runner(torch.randn((1, 8, 8, 4), generator=g), torch.ones((1,)),
           torch.randn((1, 16, 32), generator=g), y=torch.randn((1, 16), generator=g))
    return runner


@pytest.mark.parametrize("overlap", [True, False])
def test_stream_stage_spans_and_overlap_efficiency(tiny_flux, overlap):
    tracing.enable()
    with progress_scope(prompt_id="p-stream"):
        runner = _stream_call(tiny_flux, overlap)
    xs = _x(tracing.export())
    n = runner.n_stages
    assert n >= 3
    names = [e["name"] for e in xs]
    assert names.count("stream-run") == 1 and names.count("stream-prepare") == 1
    assert names.count("stream-finalize") == 1
    computes = [e for e in xs if e["name"] == "stream-stage-compute"]
    prefetches = [e for e in xs if e["name"] == "stream-stage-prefetch"]
    waits = [e for e in xs if e["name"] == "stream-prefetch-wait"]
    for spans in (computes, prefetches, waits):
        assert sorted(e["args"]["stage"] for e in spans) == list(range(n))
    assert all(e["args"]["nbytes"] > 0 for e in prefetches + computes)
    assert all(e["args"]["blocking"] is (not overlap) for e in prefetches)
    assert all(e["cat"] == "stream" and e["args"]["prompt_id"] == "p-stream" for e in xs)
    # The exposed transfer is booked apart from every compute span.
    for w in waits:
        for c in computes:
            assert (w["ts"] + w["dur"] <= c["ts"] + 1.0
                    or w["ts"] >= c["ts"] + c["dur"] - 1.0), (w, c)
    eff = tracing.stream_overlap_efficiency(xs)
    assert eff is not None and 0.0 <= eff <= 1.0
    _assert_nested_per_tid(xs)
    run = next(e for e in xs if e["name"] == "stream-run")
    assert run["args"]["stages"] == n and run["args"]["overlap"] is overlap
    got = registry.get("pa_stream_overlap_efficiency", {"device": "cpu"})
    assert got is not None and 0.0 <= got <= 1.0


def test_no_stream_spans_when_disabled(tiny_flux):
    _stream_call(tiny_flux)
    assert tracing.tracer._buffers == {} and tracing.tracer._deferred == []


def test_hardware_trace_writes_profiler_ranges_named_by_spans(tmp_path):
    tracing.enable()
    with tracing.hardware_trace(str(tmp_path)) as log_dir:
        with tracing.span("serving-dispatch", cat="serving"):
            torch.ones(8).add_(1)
        with tracing.annotate("stream-stage-compute"):
            torch.ones(8).mul_(2)
    assert log_dir == str(tmp_path)
    path = tracing.tracer.hardware_traces[-1]
    assert os.path.dirname(path) == str(tmp_path)
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"serving-dispatch", "stream-stage-compute"} <= names
    hw = [e for e in _x(tracing.export()) if e["name"] == "hardware-trace"]
    assert len(hw) == 1 and hw[0]["cat"] == "profiler"
    assert hw[0]["args"]["log_dir"] == str(tmp_path)
    # Outside the window a span is not a profiler range.
    assert tracing.annotate("x") is tracing._NULL


def test_log_records_carry_the_span_context():
    tracing.enable()
    rec = logging.LogRecord("t", logging.INFO, __file__, 1, "m", (), None)
    with tracing.span("prompt", prompt_id="p-log") as s:
        ContextFilter().filter(rec)
        assert rec.prompt_id == "p-log" and rec.span_id == s.span_id
    with progress_scope(prompt_id="p-scope"):
        ContextFilter().filter(rec)
        assert rec.prompt_id == "p-scope" and rec.span_id == "-"


# -- the server -------------------------------------------------------------------


class _Sleep:
    """A one-node graph's node: a short sleep, no model."""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"seconds": ("FLOAT", {"default": 0.01})}}

    RETURN_TYPES = ("FLOAT",)
    FUNCTION = "go"

    def go(self, seconds):
        time.sleep(seconds)
        return (seconds,)


def _get(url):
    import urllib.request

    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, json.loads(r.read())


def test_trace_endpoint_serves_the_prompt_timeline(tmp_path):
    import urllib.request

    srv, q = pserver.make_server(port=0, device="cpu", output_dir=str(tmp_path),
                                 class_mappings={"SleepWork": _Sleep}, host_id="h1",
                                 trace=True)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        body = json.dumps({"prompt": {"1": {"class_type": "SleepWork",
                                            "inputs": {"seconds": 0.01}}}}).encode()
        req = urllib.request.Request(f"{base}/prompt", data=body, method="POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            pid = json.loads(r.read())["prompt_id"]
        t0 = time.monotonic()
        while pid not in _get(f"{base}/history")[1]:
            assert time.monotonic() - t0 < 30
            time.sleep(0.01)
        status, doc = _get(f"{base}/trace?prompt_id={pid}")
        assert status == 200
        assert doc["enabled"] is True and doc["host_id"] == "h1" and doc["role"] == "all"
        assert isinstance(doc["epoch_wall_s"], float) and doc["traceEvents"]
        xs = _x(doc)
        by = {e["name"]: e for e in xs}
        assert {"admission-wait", "prompt", "workflow-node"} <= set(by)
        assert by["prompt"]["args"]["host_id"] == "h1"
        assert by["workflow-node"]["args"]["class_type"] == "SleepWork"
        assert all(e["args"]["prompt_id"] == pid for e in xs)
        _assert_nested_per_tid([e for e in xs if e["name"] != "admission-wait"])
        assert _get(f"{base}/trace")[1]["enabled"] is True
        # Its residency fed the SLO request histogram.
        assert registry.get("pa_slo_request_seconds") is not None
    finally:
        srv.shutdown()
        srv.server_close()
        q.shutdown()


def test_pa_trace_and_the_trace_flag_turn_tracing_on(monkeypatch):
    monkeypatch.setenv("PA_TRACE", "1")
    q = pserver.PromptQueue(device="cpu", workers=1)
    q.shutdown()
    assert tracing.on()
    tracing.disable()
    monkeypatch.delenv("PA_TRACE")
    seen = {}

    class _Srv:
        server_address = ("127.0.0.1", 0)

        def serve_forever(self):
            raise KeyboardInterrupt

        def server_close(self):
            pass

    class _Q:
        workers = 1

        def shutdown(self):
            pass

    def fake_make_server(*args, **kwargs):
        seen.update(kwargs)
        return _Srv(), _Q()

    monkeypatch.setattr(pserver, "make_server", fake_make_server)
    pserver.main(["--trace", "--port", "0", "--device", "cpu"])
    assert seen["trace"] is True
