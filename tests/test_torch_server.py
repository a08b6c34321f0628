"""The PyTorch port's HTTP server (``server.py``) on ``127.0.0.1:0``, on the CPU,
over a tiny SD1.5 graph.

The synthetic world: the port's tiny SD1.5 UNet, VAE and CLIP-L from seeded
generators, written to a tmp dir in their public layouts
(``chip_smoke.write_sd15_files`` and ``write_clip_tables``); the port's preset
factories patched to the tiny configs for the module. The graph is the shipped
``workflow_sd15_txt2img`` with its paths, one ``cpu`` link, 3 steps, a 32² image at
batch 1 and the save node pointed into the tmp dir. Servers share one
``WorkflowCache``, so the loaders run once for the file; a ``StepGate`` node (a
test class passed through ``class_mappings``) reports progress step by step and
waits on an event between steps, which makes cancel and interrupt land at a known
step boundary. Runs the port only: the JAX server's parity is its own tests'.
"""

import base64
import json
import os
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

import chip_smoke  # noqa: E402
import comfyui_parallelanything_tpu_torch.models as pmodels  # noqa: E402
import comfyui_parallelanything_tpu_torch.models.text_encoders as pte  # noqa: E402
from comfyui_parallelanything_tpu_torch import host as phost  # noqa: E402
from comfyui_parallelanything_tpu_torch import server as pserver  # noqa: E402
from comfyui_parallelanything_tpu_torch.serving import get_decode_queue, get_scheduler  # noqa: E402
from comfyui_parallelanything_tpu_torch.utils.metrics import registry  # noqa: E402
from comfyui_parallelanything_tpu_torch.utils.progress import report_progress  # noqa: E402

UNET = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
            transformer_depth=(1, 0), attention_levels=(0,), num_heads=4, norm_groups=8)
VAE = dict(z_channels=4, base_channels=32, channel_mult=(1, 2), num_res_blocks=1,
           norm_groups=8)
CLIP = dict(vocab_size=49408, hidden_size=48, num_layers=2, num_heads=4, max_len=16,
            eos_id=49407)
STEPS = 3
TIMEOUT = 60.0


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The files, the port patched to the tiny configs, one shared cache."""
    tmp = str(tmp_path_factory.mktemp("server_world"))
    pcfg = pmodels.sd15_config(**UNET, context_dim=CLIP["hidden_size"], dtype=torch.float32)
    pv = pmodels.VAEConfig(**VAE, dtype=torch.float32)
    pclip = pte.CLIPTextConfig(**CLIP, dtype=torch.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pmodels, "sd15_config", lambda: pcfg)
        mp.setattr(pmodels, "sd_vae_config", lambda: pv)
        mp.setattr(pte, "clip_l_config", lambda: pclip)
        gen = torch.Generator().manual_seed(0)
        unet = pmodels.build_unet(pcfg, device="cpu", generator=gen)
        vae = pmodels.build_vae(pv, device="cpu", generator=gen)
        clip = pmodels.build_clip_text(pclip, device="cpu", generator=gen)
        paths = chip_smoke.write_sd15_files(tmp, unet, vae, clip)
        paths["vocab"], paths["merges"] = chip_smoke.write_clip_tables(tmp)
        paths["out"] = os.path.join(tmp, "out")
        paths["cache"] = phost.WorkflowCache()
        yield paths


def graph(world, seed=42, sampler="euler", steps=STEPS, prefix="img", text=None) -> dict:
    with open(os.path.join("examples", "workflow_sd15_txt2img.json")) as f:
        wf = json.load(f)
    wf["checkpoint"]["inputs"]["ckpt_path"] = world["ckpt"]
    clip = wf["clip"]["inputs"]
    clip.pop("tokenizer_json")
    clip.update(encoder_path=world["clip"], vocab_path=world["vocab"],
                merges_path=world["merges"], max_len=CLIP["max_len"])
    del wf["dev1"]
    wf["dev0"]["inputs"].update(device_id="cpu", percentage=100.0)
    wf["parallel"]["inputs"]["parallel_devices"] = ["dev0", 0]
    wf["latent"]["inputs"].update(width=32, height=32, batch_size=1)
    wf["sampler"]["inputs"].update(seed=seed, sampler_name=sampler, steps=steps)
    if text is not None:
        wf["positive"]["inputs"]["text"] = text
    wf["save"]["inputs"].update(output_dir=world["out"], filename_prefix=prefix)
    return wf


GATES: dict[str, threading.Event] = {}


class StepGate:
    """A test node: ``steps`` progress reports, each after its gate opens."""

    RETURN_TYPES = ("INT",)
    FUNCTION = "run"
    CATEGORY = "test"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"steps": ("INT", {}), "tag": ("STRING", {})}}

    def run(self, steps, tag):
        for i in range(steps):
            if not GATES[tag].wait(TIMEOUT):
                raise TimeoutError(f"gate {tag} never opened")
            GATES[tag].clear()
            report_progress(i + 1, steps)
        return (steps,)


def gate_graph(tag: str, steps: int = 3) -> dict:
    GATES[tag] = threading.Event()
    return {"g": {"class_type": "StepGate", "inputs": {"steps": steps, "tag": tag}}}


@pytest.fixture
def serve(world):
    """``serve(**make_server kwargs)`` → base URL; every server is shut down after."""
    made = []

    def start(**kw):
        kw.setdefault("workers", 1)
        srv, q = pserver.make_server(port=0, device="cpu", output_dir=world["out"],
                                     cache=world["cache"],
                                     class_mappings={"StepGate": StepGate}, **kw)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        made.append((srv, q))
        return f"http://127.0.0.1:{srv.server_address[1]}", q

    yield start
    for srv, q in made:
        for ev in GATES.values():
            ev.set()
        srv.shutdown()
        srv.server_close()
        q.shutdown()
    assert get_scheduler() is None and get_decode_queue() is None


def http(method: str, url: str, body=None, raw: bytes | None = None, headers=None):
    """(status, parsed JSON or raw bytes)."""
    data = raw if raw is not None else (None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(url, data=data, method=method, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            status, payload, ctype = r.status, r.read(), r.headers.get("Content-Type", "")
    except urllib.error.HTTPError as e:
        status, payload, ctype = e.code, e.read(), e.headers.get("Content-Type", "")
    return status, (json.loads(payload) if "json" in ctype else payload)


def post_prompt(base: str, wf: dict, **extra) -> str:
    status, body = http("POST", f"{base}/prompt",
                        {"prompt": wf, **({"extra_data": extra} if extra else {})})
    assert status == 200, body
    return body["prompt_id"]


def wait_history(base: str, pid: str) -> dict:
    t0 = time.monotonic()
    while time.monotonic() - t0 < TIMEOUT:
        status, body = http("GET", f"{base}/history/{pid}")
        if body:
            return body[pid]
        time.sleep(0.01)
    raise TimeoutError(pid)


def wait_running(q, pid: str) -> None:
    t0 = time.monotonic()
    while pid not in q.running:
        assert time.monotonic() - t0 < TIMEOUT
        time.sleep(0.005)


def view_pixels(base: str, entry: dict) -> np.ndarray:
    from PIL import Image
    import io

    (out,) = entry["outputs"].values()
    (img,) = out["images"]
    status, png = http("GET", f"{base}/view?filename={img['filename']}"
                              f"&subfolder={img['subfolder']}")
    assert status == 200
    return np.asarray(Image.open(io.BytesIO(png)))


def test_prompt_history_view_round_trip_equals_direct_run(serve, world):
    base, _ = serve()
    wf = graph(world, seed=7, prefix="round")
    pid = post_prompt(base, wf)
    entry = wait_history(base, pid)
    assert entry["status"]["status_str"] == "success", entry
    got = view_pixels(base, entry)
    direct = phost.run_workflow(graph(world, seed=7, prefix="direct"), outputs=world["cache"],
                                device="cpu")
    want = np.clip(direct["decode"][0][0].numpy() * 255.0 + 0.5, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(got, want)
    status, body = http("GET", f"{base}/history")
    assert pid in body
    assert http("GET", f"{base}/view?filename=../../etc/passwd")[0] == 403
    assert http("GET", f"{base}/view?filename=missing.png")[0] == 404


def test_errors_land_in_history_and_bad_requests_are_rejected(serve, world):
    base, _ = serve()
    pid = post_prompt(base, {"1": {"class_type": "NoSuchNode", "inputs": {}}})
    entry = wait_history(base, pid)
    assert entry["status"]["status_str"] == "error"
    assert "NoSuchNode" in entry["status"]["message"]
    assert http("POST", f"{base}/prompt", raw=b"{not json")[0] == 400
    assert http("POST", f"{base}/prompt", {"prompt": {}})[0] == 400
    assert http("POST", f"{base}/prompt", {"prompt": {"1": {}}, "extra_data": {
        "priority": "high"}})[0] == 400
    assert http("POST", f"{base}/queue", {"delete": "abc"})[0] == 400
    assert http("GET", f"{base}/nowhere")[0] == 404
    # What is not ported answers 501, never a silent success; /trace is ported.
    status, body = http("GET", f"{base}/trace")
    assert status == 200 and "traceEvents" in body
    for method, path in (("GET", "/metrics/history"),
                         ("GET", "/embed/k"), ("GET", "/stage/k"),
                         ("POST", "/history/phase")):
        status, body = http(method, f"{base}{path}", {} if method == "POST" else None)
        assert status == 501 and "not ported" in body["error"], path
    status, body = http("POST", f"{base}/prompt", {"prompt": {"1": {}},
                                                   "extra_data": {"pa_stage": {}}})
    assert status == 501


def test_object_info_and_system_stats(serve):
    base, _ = serve()
    status, info = http("GET", f"{base}/object_info")
    assert status == 200 and "TPUKSampler" in info and "StepGate" in info
    status, one = http("GET", f"{base}/object_info/TPUKSampler")
    assert list(one) == ["TPUKSampler"]
    assert "sampler_name" in one["TPUKSampler"]["input"]["required"]
    assert one["TPUKSampler"]["output"] == ["LATENT"]
    assert http("GET", f"{base}/object_info/Nope")[0] == 404
    status, stats = http("GET", f"{base}/system_stats")
    assert status == 200 and "cpu" in stats["devices"]


def _ws_connect(base: str):
    host, port = base.removeprefix("http://").split(":")
    sock = socket.create_connection((host, int(port)), timeout=TIMEOUT)
    key = base64.b64encode(os.urandom(16)).decode()
    sock.sendall((f"GET /ws HTTP/1.1\r\nHost: {host}\r\nUpgrade: websocket\r\n"
                  f"Connection: Upgrade\r\nSec-WebSocket-Key: {key}\r\n"
                  "Sec-WebSocket-Version: 13\r\n\r\n").encode())
    f = sock.makefile("rb")
    status = f.readline()
    assert b"101" in status, status
    while f.readline() not in (b"\r\n", b""):
        pass
    return sock, f


def test_ws_event_sequence_and_completion_signal(serve, world):
    base, _ = serve()
    sock, f = _ws_connect(base)
    try:
        wf = graph(world, seed=11, prefix="ws")
        pid = post_prompt(base, wf)
        events = []
        while True:
            opcode, data = pserver._ws_read_frame(f)
            assert opcode == 0x1
            ev = json.loads(data)
            events.append(ev)
            if ev["type"] == "executing" and ev["data"]["node"] is None:
                break
        kinds = [e["type"] for e in events]
        assert kinds[0] == "status" and "execution_start" in kinds
        assert kinds.index("execution_start") < kinds.index("executing")
        mine = [e for e in events if e["type"] != "status"]
        assert all(e["data"]["prompt_id"] == pid for e in mine)
        progress = [e["data"] for e in events if e["type"] == "progress"]
        assert [p["value"] for p in progress] == list(range(1, STEPS + 1))
        assert all(p["max"] == STEPS and p["node"] == "sampler" for p in progress)
        executed = [e["data"] for e in events if e["type"] == "executed"]
        assert [e["node"] for e in executed] == ["save"]
        assert executed[0]["output"]["images"][0]["type"] == "output"
        assert events[-1]["data"] == {"node": None, "prompt_id": pid}
        ran = [e["data"]["node"] for e in events if e["type"] == "executing"][:-1]
        assert ran[-1] == "save" and "sampler" in ran
        # The opt-in preview frames: binary, event type 1, PNG.
        pid = post_prompt(base, graph(world, seed=12, prefix="ws"), preview=True)
        binary = 0
        while True:
            opcode, data = pserver._ws_read_frame(f)
            if opcode == 0x2:
                assert data[:8] == b"\x00\x00\x00\x01\x00\x00\x00\x02"
                assert data[8:12] == b"\x89PNG"
                binary += 1
                continue
            ev = json.loads(data)
            if ev["type"] == "executing" and ev["data"] == {"node": None, "prompt_id": pid}:
                break
        assert binary == STEPS
    finally:
        sock.close()


def test_queue_delete_and_interrupt_stop_at_a_step_boundary(serve):
    base, q = serve()
    running = post_prompt(base, gate_graph("a"))
    wait_running(q, running)
    pending = post_prompt(base, gate_graph("b"))
    status, body = http("GET", f"{base}/queue")
    assert body == {"queue_running": [running], "queue_pending": [pending]}
    GATES["a"].set()  # step 1 runs
    status, body = http("POST", f"{base}/queue", {"delete": [pending, running]})
    assert body == {"deleted": 2}
    assert wait_history(base, pending)["status"]["status_str"] == "interrupted"
    GATES["a"].set()  # step 2 reports, and the boundary check stops it
    assert wait_history(base, running)["status"]["status_str"] == "interrupted"

    running = post_prompt(base, gate_graph("c"))
    wait_running(q, running)
    pending = post_prompt(base, gate_graph("d"))
    status, body = http("POST", f"{base}/interrupt")
    assert body == {"dropped": 1}
    GATES["c"].set()
    assert wait_history(base, running)["status"]["status_str"] == "interrupted"
    assert wait_history(base, pending)["status"]["status_str"] == "interrupted"
    # A finished prompt's Cancel event does not leak into the next one.
    ok = post_prompt(base, gate_graph("e", steps=1))
    GATES["e"].set()
    assert wait_history(base, ok)["status"]["status_str"] == "success"


def test_full_queue_answers_429_and_drain_503_then_resume(serve):
    base, q = serve(max_pending=1)
    running = post_prompt(base, gate_graph("f", steps=1))
    wait_running(q, running)
    post_prompt(base, gate_graph("g", steps=1))
    status, body = http("POST", f"{base}/prompt", {"prompt": gate_graph("h", steps=1)})
    assert status == 429 and "queue full" in body["error"]
    status, body = http("POST", f"{base}/drain", {})
    assert status == 200 and body["accepting"] is False
    assert http("GET", f"{base}/health")[1]["accepting"] is False
    status, body = http("POST", f"{base}/prompt", {"prompt": gate_graph("i", steps=1)})
    assert status == 503
    GATES["f"].set()
    GATES["g"].set()
    assert wait_history(base, running)["status"]["status_str"] == "success"
    status, body = http("POST", f"{base}/drain", {"resume": True})
    assert body["accepting"] is True
    last = post_prompt(base, gate_graph("j", steps=1))
    GATES["j"].set()
    assert wait_history(base, last)["status"]["status_str"] == "success"


def test_metrics_text_and_health_sections(serve, world):
    base, q = serve()
    wait_history(base, post_prompt(base, graph(world, seed=3, prefix="m")))
    status, text = http("GET", f"{base}/metrics")
    text = text.decode()
    assert status == 200
    assert "# TYPE pa_server_queue_pending gauge" in text and "pa_server_running 0" in text
    status, doc = http("GET", f"{base}/health")
    assert doc["schema"] == "pa-health/v3" and doc["accepting"] is True
    assert doc["host_id"] == q.host_id and doc["device"] == "cpu"
    assert "cpu" in doc["devices"] and doc["hbm"] == []
    assert doc["queue"]["workers"] == 1 and doc["queue"]["serving"] is False
    assert doc["queue"]["completed"] >= 1 and doc["role"] == "all"
    assert set(doc["reuse"]) == {"embed_cache", "decode", "serving"}
    assert doc["reuse"]["serving"] is None
    # Left out, named, not invented.
    assert "compile" not in doc and "numerics" in doc["not_ported"]


def lane_steps() -> float:
    return sum(float(line.rsplit(" ", 1)[1]) for line in registry.render().splitlines()
               if line.startswith("pa_serving_lane_steps_total{"))


def test_two_workers_give_the_images_of_one(serve, world):
    seeds = {21: "euler", 22: "dpmpp_2m", 23: "heun"}
    base1, _ = serve(workers=1)
    one = {s: view_pixels(base1, wait_history(base1, post_prompt(
        base1, graph(world, seed=s, sampler=sa, prefix=f"w1_{s}")))) for s, sa in seeds.items()}
    before = lane_steps()
    base2, q2 = serve(workers=2)
    assert q2.scheduler is get_scheduler() and q2.decode_queue is get_decode_queue()
    pids = {s: post_prompt(base2, graph(world, seed=s, sampler=sa, prefix=f"w2_{s}"))
            for s, sa in seeds.items()}
    two = {s: view_pixels(base2, wait_history(base2, pid)) for s, pid in pids.items()}
    for s in seeds:
        # The lanes' f32 updates differ from the inline sampler's in the last bits;
        # an 8-bit pixel may round the other way.
        assert np.abs(two[s].astype(int) - one[s].astype(int)).max() <= 1, s
        assert (two[s] == one[s]).mean() > 0.95, s
    # The sampler runs went through the scheduler's lanes.
    # euler and dpmpp_2m: one eval a step; heun: two, and one for its last step.
    assert lane_steps() - before == STEPS + STEPS + (2 * STEPS - 1)
    status, text = http("GET", f"{base2}/metrics")
    assert "pa_serving_dispatch_total" in text.decode()
    assert "pa_decode_dispatch_total" in text.decode()
    status, doc = http("GET", f"{base2}/health")
    assert doc["queue"]["serving"] is True and doc["reuse"]["decode"]["width"] == 4


def test_refused_options_raise_not_ported(monkeypatch, world):
    monkeypatch.setenv("PA_NUMERICS", "1")
    with pytest.raises(NotImplementedError, match="numerics"):
        pserver.PromptQueue(device="cpu", cache=world["cache"])
    monkeypatch.delenv("PA_NUMERICS")
    with pytest.raises(NotImplementedError, match="role"):
        pserver.PromptQueue(device="cpu", role="decode", cache=world["cache"])
    with pytest.raises(NotImplementedError, match="fleet"):
        pserver.main(["--fleet-router", "http://127.0.0.1:9", "--port", "0"])
