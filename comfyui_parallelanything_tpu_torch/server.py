"""Minimal ComfyUI-compatible HTTP API over the port's workflow host (counterpart
of ``comfyui_parallelanything_tpu/server.py``).

Clients drive the reference's graphs through ComfyUI's HTTP server: the frontend
and every scripting client POST API-format JSON to ``/prompt``. This module is
that surface for the port's host: stdlib only (``http.server``), a pool of prompt
worker threads (default ONE, the reference's serial schedule; ``workers > 1`` or
``PA_SERVER_WORKERS`` runs prompts concurrently and installs the continuous-batching
scheduler and the batched decode tail, ``serving/``, so concurrent prompts' sampler
steps share one batched model call), and one ``host.WorkflowCache`` shared across
prompts, so a model one prompt loaded stays resident for the next. Graphs run on
``cuda:0`` unless the server is started with ``device="cpu"`` (``--device cpu``).

Endpoints:

- ``POST /prompt``        ``{"prompt": {...graph...}}`` → ``{"prompt_id",
                          "number"}``; ``extra_data.priority`` /
                          ``extra_data.deadline_s`` feed the serving policy;
                          ``extra_data.preview`` opts in to preview frames; 429
                          when the bounded queue (``max_pending`` /
                          ``PA_MAX_PENDING``) is full, 503 while draining
- ``GET  /history``       every finished prompt; ``/history/{id}`` one
- ``GET  /view``          a saved image (``filename``, ``subfolder``)
- ``GET  /queue``         running and pending prompt ids
- ``POST /queue``         ``{"delete": [id, ...]}`` drops queued prompts and stops
                          running ones at their next step boundary (a serving
                          lane frees without touching its neighbours);
                          ``{"clear": true}`` drops every pending prompt
- ``POST /interrupt``     drop every pending prompt and stop every running one at
                          its next step boundary
- ``POST /drain``         stop seating new prompts (``POST /prompt`` → 503) while
                          running ones finish; ``{"resume": true}`` reopens
- ``POST /upload/image``  multipart upload into ``$PA_INPUT_DIR`` (stock dedupe
                          suffixes, ``overwrite`` honoured)
- ``GET  /object_info[/cls]`` node-registry introspection
- ``GET  /system_stats``  devices (``devices.discovery``)
- ``GET  /metrics``       Prometheus text (``utils/metrics.registry``): the
                          serving buckets' occupancy, lane wait, step seconds and
                          dispatches, the decode tail, the queue gauges, the
                          per-card ``pa_hbm_*`` memory gauges, the span histogram
                          (``pa_trace_span_seconds``) and the SLO plane
                          (``pa_slo_*``, ``utils/slo.py``: request and stage
                          histograms, burn-rate and budget gauges per objective of
                          ``PA_SLO_OBJECTIVES``; ``PA_SLO=0`` turns it off)
- ``GET  /trace``         Chrome/Perfetto trace-event JSON of the span tracer
                          (``utils/tracing.py``; open it at ui.perfetto.dev):
                          ``?prompt_id=`` filters to one prompt's timeline
                          (``prompt`` → ``workflow-node`` → ``sampler-run`` →
                          ``lane-wait``/``lane``/``step``, ``decode``), with
                          ``enabled``, ``host_id``, ``role`` and ``epoch_wall_s``;
                          tracing is on with ``trace=True``, ``--trace`` or
                          ``PA_TRACE=1`` (off: an empty export that says so)
- ``GET  /health``        one JSON document (``utils/telemetry.health_snapshot``):
                          devices, per-card memory, peak watermark, the queue and
                          admission state (``host_id``, ``accepting``,
                          ``inflight_prompts``)
- ``GET  /ws``            WebSocket events (RFC 6455, stdlib): ``status`` on
                          queue changes, ``execution_start``, ``execution_cached``,
                          ``executing`` per node, ``progress`` per sampler step,
                          ``executed`` per output node, ``execution_interrupted``,
                          and the completion signal ``executing`` with ``node:
                          null``; opt-in binary preview frames (``>II`` event 1,
                          format 2, then PNG bytes)

Each prompt is a ``prompt`` span with an ``admission-wait`` span before it (HTTP
ingress to worker pickup, also the SLO ``admission`` stage); its residency
(admission + execution) feeds ``pa_slo_request_seconds``, and its spans are kept
past the live rings (``tracing.retain_prompt``).

Not ported (ROADMAP Queue 1 items 9b–9d); each answers 501 or raises, never a
silent no-op: the fleet's ``traceparent`` context, fault sites, the metric
history (``/metrics/history``, ``/history/phase``) and its sampler, the fleet's
roles other than the default and its heartbeat registration (``--fleet-router``),
the stage hand-off (``extra_data.pa_stage``, ``/stage/{key}``), the embed cache's
remote tier (``/embed/{key}``), the numerics sentinel (``PA_NUMERICS=1``) and the
roofline gauges.

Run:  ``python -m comfyui_parallelanything_tpu_torch.server [--port 8188]
[--workers 4] [--device cuda:0]``
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
import queue
import struct
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from .host import DEFAULT_DEVICE, WorkflowCache, run_workflow
from .parallel.orchestrator import _not_ported
from .utils import slo, tracing
from .utils.progress import Interrupted, progress_scope

_WS_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"  # RFC 6455 §1.3

# Routes of the JAX server that the port answers with 501.
_NOT_PORTED_GET = {"embed": "GET /embed/{key} (the embed cache's remote tier)",
                   "stage": "GET /stage/{key} (the fleet's stage hand-off)"}
_NOT_PORTED_POST = {"/history/phase": "POST /history/phase (the metric history)"}


def _ws_frame(payload: bytes, opcode: int = 0x1) -> bytes:
    """One server→client frame (FIN set, unmasked: RFC 6455 §5.2)."""
    head = bytes([0x80 | opcode])
    n = len(payload)
    if n < 126:
        head += bytes([n])
    elif n < 1 << 16:
        head += bytes([126]) + struct.pack(">H", n)
    else:
        head += bytes([127]) + struct.pack(">Q", n)
    return head + payload


def _ws_read_frame(rfile) -> tuple[int, bytes] | None:
    """(opcode, payload) of one client frame, or None on EOF, an abrupt disconnect
    mid-header included. Client frames are masked (RFC 6455 §5.3)."""

    def need(k: int) -> bytes | None:
        data = rfile.read(k)
        return data if len(data) == k else None

    hdr = need(2)
    if hdr is None:
        return None
    opcode = hdr[0] & 0x0F
    masked, n = hdr[1] & 0x80, hdr[1] & 0x7F
    if n == 126:
        ext = need(2)
        if ext is None:
            return None
        n = struct.unpack(">H", ext)[0]
    elif n == 127:
        ext = need(8)
        if ext is None:
            return None
        n = struct.unpack(">Q", ext)[0]
    mask = need(4) if masked else b"\x00" * 4
    if mask is None:
        return None
    data = need(n)
    if data is None:
        return None
    if masked:
        data = bytes(b ^ mask[i % 4] for i, b in enumerate(data))
    return opcode, data


def _jsonable(v):
    """INPUT_TYPES trees hold tuples, dicts, strings and the odd non-JSON leaf (a
    type, an infinite bound): degrade those to strings."""
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, (str, int, bool)) or v is None:
        return v
    if isinstance(v, float):
        return v if v == v and abs(v) != float("inf") else str(v)
    return str(v)


class _WsListener:
    """One /ws client: a writer thread drains a bounded frame queue. Every write
    (events and pongs) goes through it, so frames never interleave; ``send`` never
    blocks, and a stalled client fills its queue and is evicted."""

    def __init__(self, sock):
        self.sock = sock
        self.frames: "queue.Queue[bytes | None]" = queue.Queue(maxsize=64)
        self._writer = threading.Thread(target=self._write_loop, daemon=True)
        self._writer.start()

    def _write_loop(self) -> None:
        while True:
            frame = self.frames.get()
            if frame is None:
                return
            try:
                self.sock.sendall(frame)
            except OSError:
                return

    def send(self, frame: bytes) -> bool:
        """False: the queue is full (a stalled client), and the caller evicts it."""
        try:
            self.frames.put_nowait(frame)
            return True
        except queue.Full:
            return False

    def close(self) -> None:
        try:
            self.frames.put_nowait(None)
        except queue.Full:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


class QueueFullError(RuntimeError):
    """The bounded prompt queue is full: HTTP 429."""


class DrainingError(RuntimeError):
    """The host is draining (POST /drain): HTTP 503."""


def default_host_id() -> str:
    """The process's identity on ``/health``: ``$PA_HOST_ID``, else hostname-pid."""
    hid = os.environ.get("PA_HOST_ID")
    if hid:
        return hid
    import socket

    try:
        name = socket.gethostname()
    except OSError:
        name = "host"
    return f"{name}-{os.getpid()}"


class PromptQueue:
    """Prompt executor with ComfyUI-shaped bookkeeping.

    Default is the reference's schedule: ONE worker thread, prompts strictly
    serial. ``workers > 1`` runs that many prompt workers and installs a
    ``ContinuousBatchingScheduler`` and a ``DecodeQueue`` (``serving=True/False``
    overrides), so the overlapping sampler runs share step dispatches and the
    decodes batch. Each prompt runs under its own ``progress_scope``: its progress
    hook and a Cancel event that doubles as its serving lane's cancel. ``device``
    is where the graphs place weights and latents (``run_workflow(device=...)``);
    ``cache`` shares a ``WorkflowCache`` with the caller (default: a new one).
    ``trace`` (default ``$PA_TRACE``) turns the process-wide span tracer on."""

    def __init__(self, class_mappings=None, output_dir: str | None = None,
                 workers: int | None = None, max_pending: int | None = None,
                 serving: bool | None = None, host_id: str | None = None,
                 role: str | None = None, device: str = DEFAULT_DEVICE,
                 cache: WorkflowCache | None = None, trace: bool | None = None):
        if os.environ.get("PA_NUMERICS", "") not in ("", "0", "false"):
            raise _not_ported("the numerics sentinel (PA_NUMERICS=1; ROADMAP Queue 1 item 9b)")
        role = role or os.environ.get("PA_ROLE") or "all"
        if role != "all":
            raise _not_ported(f"fleet role {role!r} (the role pools; ROADMAP Queue 1 item 9d)")
        if trace is None:
            trace = os.environ.get("PA_TRACE", "") not in ("", "0", "false")
        if trace:
            tracing.enable()
        self.class_mappings = class_mappings
        self.output_dir = output_dir or os.environ.get("PA_OUTPUT_DIR", "output")
        self.device = device
        self.host_id = host_id or default_host_id()
        self.role = role
        self.accepting = True
        self.cache = cache if cache is not None else WorkflowCache()
        self.pending: "queue.Queue[tuple | None]" = queue.Queue()
        self.pending_ids: list[str] = []  # guarded-by: _lock
        # pid → its per-prompt Cancel event (progress_scope).
        self.running: dict[str, threading.Event] = {}  # guarded-by: _lock
        self.history: dict[str, dict] = {}  # guarded-by: _lock
        self.counter = 0
        self._lock = threading.Lock()
        self._listeners: dict = {}  # socket → _WsListener; guarded-by: _lock
        self.workers = max(1, int(workers if workers is not None
                                  else os.environ.get("PA_SERVER_WORKERS", "1")))
        if max_pending is None:
            max_pending = int(os.environ.get("PA_MAX_PENDING", "0"))
        self.max_pending = max_pending or None  # 0: unbounded
        self.scheduler = None
        self.decode_queue = None
        if (self.workers > 1 if serving is None else serving):
            from .serving import ContinuousBatchingScheduler, DecodeQueue

            self.scheduler = ContinuousBatchingScheduler().install()
            self.decode_queue = DecodeQueue().install()
        from .utils.telemetry import MemoryMonitor

        self._mem_monitor = MemoryMonitor(float(os.environ.get("PA_MEM_SAMPLE_S", "60"))).start()
        self._workers = [threading.Thread(target=self._run, daemon=True)
                         for _ in range(self.workers)]
        for t in self._workers:
            t.start()

    def add_listener(self, sock) -> _WsListener:
        listener = _WsListener(sock)
        with self._lock:
            self._listeners[sock] = listener
        return listener

    def remove_listener(self, sock) -> None:
        with self._lock:
            listener = self._listeners.pop(sock, None)
        if listener is not None:
            listener.close()

    def _broadcast(self, frame: bytes) -> None:
        with self._lock:
            listeners = list(self._listeners.items())
        for sock, listener in listeners:
            if not listener.send(frame):
                self.remove_listener(sock)

    def _emit(self, event: dict) -> None:
        """Queue one JSON event to every /ws client; never blocks the caller."""
        self._broadcast(_ws_frame(json.dumps(event).encode()))

    def _emit_binary(self, payload: bytes) -> None:
        """Queue one binary event (a preview frame)."""
        self._broadcast(_ws_frame(payload, opcode=0x2))

    def _emit_status(self) -> None:
        with self._lock:
            remaining = len(self.pending_ids)
        self._emit({"type": "status",
                    "data": {"status": {"exec_info": {"queue_remaining": remaining}}}})

    def submit(self, prompt: dict, preview: bool = False, priority: int = 0,
               deadline_s: float | None = None) -> tuple[str, int]:
        pid = uuid.uuid4().hex
        # Bookkeeping and enqueue under one lock: interrupt() drains under it, so a
        # submit racing an interrupt lands wholly before or wholly after.
        with self._lock:
            if not self.accepting:
                raise DrainingError(f"host {self.host_id} is draining (no new prompts)")
            if (self.max_pending is not None
                    and len(self.pending_ids) - len(self.running) >= self.max_pending):
                from .utils.metrics import registry

                registry.counter("pa_server_rejected_total",
                                 help="prompts refused with 429 (queue full)")
                raise QueueFullError(f"queue full ({self.max_pending} pending)")
            self.counter += 1
            number = self.counter
            self.pending_ids.append(pid)
            self.pending.put((pid, prompt, bool(preview), int(priority), deadline_s,
                              time.monotonic()))
        self._emit_status()
        return pid, number

    def drain(self) -> dict:
        """Stop seating new prompts (POST /prompt → 503); running ones finish."""
        with self._lock:
            self.accepting = False
            return {"host_id": self.host_id, "accepting": False,
                    "pending": len(self.pending_ids) - len(self.running),
                    "running": len(self.running)}

    def resume(self) -> dict:
        """Reopen admission after a drain."""
        with self._lock:
            self.accepting = True
            return {"host_id": self.host_id, "accepting": True}

    def _drop_pending(self, pid: str) -> None:  # caller holds _lock
        self.pending_ids.remove(pid)
        self.history[pid] = {"status": {"status_str": "interrupted", "completed": False,
                                        "host_id": self.host_id}, "outputs": {}}

    def interrupt(self) -> int:
        """Drop every pending prompt and ask every running one to stop at its next
        boundary (ComfyUI's Cancel); a step in flight is not preempted."""
        dropped = 0
        with self._lock:
            while True:
                try:
                    item = self.pending.get_nowait()
                except queue.Empty:
                    break
                if item is None:  # keep the shutdown sentinel
                    self.pending.put(None)
                    break
                if item[0] in self.pending_ids:
                    dropped += 1
                    self._drop_pending(item[0])
            # A pending id that is not running is a worker's pop in flight: dropping
            # it here makes the worker skip it, so the Cancel wins the race.
            for pid in [p for p in self.pending_ids if p not in self.running]:
                dropped += 1
                self._drop_pending(pid)
            for evt in self.running.values():
                evt.set()
        if self.scheduler is not None:
            self.scheduler.kick()
        if dropped:
            self._emit_status()
        return dropped

    def clear_pending(self) -> int:
        """Drop every PENDING prompt (running ones finish): ``{"clear": true}``."""
        dropped = 0
        with self._lock:
            for pid in [p for p in self.pending_ids if p not in self.running]:
                self._drop_pending(pid)
                dropped += 1
        if dropped:
            self._emit_status()
        return dropped

    def cancel(self, pids) -> int:
        """Per-prompt Cancel (``{"delete": [...]}``): a pending prompt drops with an
        interrupted history entry; a running one gets its scope event set, which
        the host checks between nodes and the scheduler at the next step boundary."""
        acted = 0
        with self._lock:
            targets = {str(p) for p in pids}
            running_hits = [p for p in targets if p in self.running]
            pending_hits = [p for p in targets
                            if p in self.pending_ids and p not in self.running]
            for pid in pending_hits:
                self._drop_pending(pid)
                acted += 1
            for pid in running_hits:
                self.running[pid].set()
                acted += 1
        if running_hits and self.scheduler is not None:
            self.scheduler.kick()
        if pending_hits:
            self._emit_status()
        return acted

    def shutdown(self) -> None:
        self.pending.put(None)  # each worker passes the sentinel on
        for t in self._workers:
            t.join(timeout=30)
        self._mem_monitor.stop()
        if self.scheduler is not None:
            self.scheduler.shutdown()
        if self.decode_queue is not None:
            self.decode_queue.uninstall()
            self.decode_queue.shutdown()

    def _run(self) -> None:
        from .serving.scheduler import serving_hints

        while True:
            item = self.pending.get()
            if item is None:
                self.pending.put(None)
                return
            pid, prompt, preview, priority, deadline_s, enq_ts = item
            cancel_evt = threading.Event()
            with self._lock:
                if pid not in self.pending_ids:
                    continue  # cancelled while queued
                self.running[pid] = cancel_evt
            self._emit({"type": "execution_start", "data": {"prompt_id": pid}})
            t0 = time.monotonic()
            # The SLO admission stage: ingress to worker pickup.
            admission_s = max(0.0, t0 - enq_ts)
            slo.observe_stage("admission", admission_s)
            if tracing.on():
                now_us = tracing.now_us()
                tracing.record("admission-wait", now_us - admission_s * 1e6, admission_s * 1e6,
                               cat="server", prompt_id=pid)
            current: dict = {"node": None}

            def on_node(nid, _pid=pid, _cur=current):
                _cur["node"] = nid
                self._emit({"type": "executing", "data": {"node": nid, "prompt_id": _pid}})

            def hook(value, max_value, _pid=pid, _cur=current):
                self._emit({"type": "progress",
                            "data": {"value": value, "max": max_value, "prompt_id": _pid,
                                     "node": _cur["node"]}})

            def on_cached(nids, _pid=pid):
                self._emit({"type": "execution_cached",
                            "data": {"nodes": list(nids), "prompt_id": _pid}})

            def preview_hook(latent):
                # Stock preview frame: >II event type 1 (PREVIEW_IMAGE), format 2
                # (PNG), then the PNG bytes; best effort.
                try:
                    from .utils.latent_preview import preview_png

                    png = preview_png(latent)
                except Exception:  # noqa: BLE001 - previews are best effort
                    return
                self._emit_binary(struct.pack(">II", 1, 2) + png)

            try:
                # The prompt span is the root of the prompt's timeline.
                with progress_scope(hook=hook, preview_hook=preview_hook if preview else None,
                                    interrupt_event=cancel_evt, prompt_id=pid), \
                        serving_hints(priority=priority, deadline_s=deadline_s), \
                        tracing.span("prompt", cat="server", prompt_id=pid,
                                     host_id=self.host_id, role=self.role):
                    results = run_workflow(prompt, class_mappings=self.class_mappings,
                                           outputs=self.cache, on_node=on_node,
                                           on_cached=on_cached, device=self.device)
                entry = {"status": {"status_str": "success", "completed": True,
                                    "exec_s": round(time.monotonic() - t0, 3)},
                         "outputs": self._image_outputs(prompt, results)}
                for nid, out in entry["outputs"].items():
                    self._emit({"type": "executed",
                                "data": {"node": nid, "output": out, "prompt_id": pid}})
            except Interrupted:
                entry = {"status": {"status_str": "interrupted", "completed": False},
                         "outputs": {}}
                self._emit({"type": "execution_interrupted",
                            "data": {"prompt_id": pid, "node_id": current["node"]}})
            except Exception as e:  # noqa: BLE001 - failures land in history
                entry = {"status": {"status_str": "error", "completed": False,
                                    "message": f"{type(e).__name__}: {e}"},
                         "outputs": {}}
            entry["status"]["host_id"] = self.host_id
            # The request's server-side residency: admission wait + execution.
            slo.observe_request(admission_s + (time.monotonic() - t0))
            if tracing.on():
                tracing.retain_prompt(pid)
            with self._lock:
                self.history[pid] = entry
                if pid in self.pending_ids:
                    self.pending_ids.remove(pid)
                # The Cancel event retires with its prompt: a late Cancel cannot
                # leak into the next one.
                self.running.pop(pid, None)
            # The completion signal API clients wait for.
            self._emit({"type": "executing", "data": {"node": None, "prompt_id": pid}})
            self._emit_status()

    def _image_outputs(self, prompt: dict, results: dict) -> dict:
        """ComfyUI's history shape: per save node ``{"images": [{filename,
        subfolder, type}]}``, for outputs whose first element lists existing files
        under the output directory (what the SaveImage family returns)."""
        out: dict[str, dict] = {}
        for nid in prompt:
            vals = results.get(str(nid))
            if not vals or not isinstance(vals[0], (list, tuple)):
                continue
            images = []
            for p in vals[0]:
                if not (isinstance(p, str) and os.path.exists(p)):
                    continue
                rel = os.path.relpath(p, self.output_dir)
                sub, fname = os.path.split(rel)
                if sub.startswith(".."):
                    continue  # outside the output directory: /view would refuse it
                images.append({"filename": fname, "subfolder": sub, "type": "output"})
            if images:
                out[str(nid)] = {"images": images}
        return out


class _Handler(BaseHTTPRequestHandler):
    q: PromptQueue  # set by make_server
    # RFC 6455 handshakes need an HTTP/1.1 status line; every response sets
    # Content-Length, which keep-alive needs.
    protocol_version = "HTTP/1.1"
    disable_nagle_algorithm = True

    def log_message(self, fmt, *args):  # quiet
        pass

    def _send(self, code: int, payload, content_type="application/json"):
        body = json.dumps(payload).encode() if content_type == "application/json" else payload
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json_body(self):
        length = int(self.headers.get("Content-Length", 0))
        return json.loads(self.rfile.read(length) or b"{}")

    def _not_ported(self, what: str):
        return self._send(501, {"error": str(_not_ported(what))})

    def do_GET(self):  # noqa: N802 - http.server API
        url = urlparse(self.path)
        parts = [p for p in url.path.split("/") if p]
        q = self.q
        if url.path == "/ws":
            return self._serve_websocket()
        if url.path == "/queue":
            with q._lock:
                running = list(q.running)
                pend = [p for p in q.pending_ids if p not in q.running]
            return self._send(200, {"queue_running": running, "queue_pending": pend})
        if url.path == "/metrics":
            from .devices.memory import publish_memory_gauges
            from .utils.metrics import registry

            with q._lock:
                registry.gauge("pa_server_queue_pending", len(q.pending_ids) - len(q.running),
                               help="prompts queued, not yet running")
                registry.gauge("pa_server_running", len(q.running),
                               help="prompts executing right now")
            publish_memory_gauges()
            # The windowed objective verdicts, published at scrape time.
            slo.registry.publish_gauges()
            return self._send(200, registry.render().encode(),
                              content_type="text/plain; version=0.0.4; charset=utf-8")
        if url.path == "/health":
            from .serving.bucket import batched_fraction
            from .utils.telemetry import health_snapshot

            with q._lock:
                queue_doc = {
                    "pending": len(q.pending_ids) - len(q.running),
                    "running": len(q.running), "workers": q.workers,
                    "max_pending": q.max_pending, "completed": len(q.history),
                    "serving": q.scheduler is not None,
                    "serving_batched_fraction": round(batched_fraction(), 4),
                }
                host = {"host_id": q.host_id, "accepting": q.accepting,
                        "inflight_prompts": len(q.pending_ids), "role": q.role,
                        "device": q.device}
            return self._send(200, health_snapshot(queue=queue_doc, host=host))
        if url.path == "/trace":
            # Off, the export is empty and says so, so a client tells "off" from
            # "no spans".
            prompt_id = parse_qs(url.query).get("prompt_id", [None])[0]
            trace = tracing.export(prompt_id=prompt_id)
            trace.update(enabled=tracing.on(), host_id=q.host_id, role=q.role)
            return self._send(200, trace)
        if parts and parts[0] == "history":
            with q._lock:
                snap = dict(q.history)
            if len(parts) == 2:
                entry = snap.get(parts[1])
                return self._send(200, {parts[1]: entry} if entry else {})
            return self._send(200, snap)
        if url.path == "/view":
            qs = parse_qs(url.query)
            fname = qs.get("filename", [""])[0]
            sub = qs.get("subfolder", [""])[0]
            path = os.path.normpath(os.path.join(q.output_dir, sub, fname))
            base = os.path.abspath(q.output_dir)
            if not os.path.abspath(path).startswith(base + os.sep):
                return self._send(403, {"error": "path escapes output dir"})
            if not os.path.exists(path):
                return self._send(404, {"error": "not found"})
            with open(path, "rb") as f:
                return self._send(200, f.read(), content_type="image/png")
        if parts and parts[0] == "object_info":
            from .nodes import NODE_CLASS_MAPPINGS, NODE_DISPLAY_NAME_MAPPINGS

            classes = dict(NODE_CLASS_MAPPINGS)
            classes.update(q.class_mappings or {})
            names = [parts[1]] if len(parts) == 2 else list(classes)
            info = {}
            for name in names:
                cls = classes.get(name)
                if cls is None:
                    continue
                info[name] = {
                    "input": _jsonable(cls.INPUT_TYPES()),
                    "output": _jsonable(list(cls.RETURN_TYPES)),
                    "output_name": _jsonable(list(getattr(cls, "RETURN_NAMES", None)
                                                  or cls.RETURN_TYPES)),
                    "name": name,
                    "display_name": NODE_DISPLAY_NAME_MAPPINGS.get(name, name),
                    "description": getattr(cls, "DESCRIPTION", ""),
                    "category": getattr(cls, "CATEGORY", ""),
                }
            if len(parts) == 2 and not info:
                return self._send(404, {"error": f"unknown node {parts[1]!r}"})
            return self._send(200, info)
        if url.path == "/system_stats":
            from .devices.discovery import available_devices

            return self._send(200, {"devices": available_devices()})
        if url.path == "/metrics/history":
            return self._not_ported("GET /metrics/history (the metric history)")
        if parts and parts[0] in _NOT_PORTED_GET:
            return self._not_ported(_NOT_PORTED_GET[parts[0]])
        return self._send(404, {"error": f"no route {url.path}"})

    def _serve_websocket(self):
        """RFC 6455 upgrade, then park reading client frames (ping → pong, close →
        exit) while the queue's listener writes events."""
        key = self.headers.get("Sec-WebSocket-Key")
        if self.headers.get("Upgrade", "").lower() != "websocket" or not key:
            return self._send(400, {"error": "expected a WebSocket upgrade"})
        accept = base64.b64encode(hashlib.sha1((key + _WS_GUID).encode()).digest()).decode()
        sock = self.connection
        # Registered before the 101 goes out: a client that POSTs the moment its
        # handshake completes must not miss its prompt's events.
        listener = self.q.add_listener(sock)
        self.send_response(101, "Switching Protocols")
        self.send_header("Upgrade", "websocket")
        self.send_header("Connection", "Upgrade")
        self.send_header("Sec-WebSocket-Accept", accept)
        self.end_headers()
        self.wfile.flush()
        self.close_connection = True
        try:
            while True:
                frame = _ws_read_frame(self.rfile)
                if frame is None or frame[0] == 0x8:  # EOF / close
                    return
                if frame[0] == 0x9:  # ping → pong, through the single writer
                    listener.send(_ws_frame(frame[1], opcode=0xA))
        except OSError:
            return
        finally:
            self.q.remove_listener(sock)

    def do_POST(self):  # noqa: N802 - http.server API
        url = urlparse(self.path)
        q = self.q
        if url.path == "/interrupt":
            return self._send(200, {"dropped": q.interrupt()})
        if url.path in _NOT_PORTED_POST:
            return self._not_ported(_NOT_PORTED_POST[url.path])
        if url.path == "/upload/image":
            return self._upload_image()
        if url.path not in ("/drain", "/queue", "/prompt"):
            return self._send(404, {"error": f"no route {url.path}"})
        try:
            payload = self._json_body()
        except (ValueError, json.JSONDecodeError) as e:
            return self._send(400, {"error": f"bad JSON: {e}"})
        if not isinstance(payload, dict):
            return self._send(400, {"error": "the body must be a JSON object"})
        if url.path == "/drain":
            return self._send(200, q.resume() if payload.get("resume") else q.drain())
        if url.path == "/queue":
            deleted = q.clear_pending() if payload.get("clear") else 0
            targets = payload.get("delete")
            if targets is not None:
                if not isinstance(targets, (list, tuple)):
                    return self._send(400, {"error": '"delete" must be a list of prompt ids'})
                deleted += q.cancel(targets)
            return self._send(200, {"deleted": deleted})
        prompt = payload.get("prompt")
        if not isinstance(prompt, dict) or not prompt:
            return self._send(400, {"error": 'body must carry a non-empty {"prompt": {...}} graph'})
        extra = payload.get("extra_data") or {}
        if not isinstance(extra, dict):
            return self._send(400, {"error": "extra_data must be an object"})
        if extra.get("pa_stage") is not None:
            return self._not_ported("extra_data.pa_stage (the fleet's staged dispatch)")
        try:
            deadline_s = extra.get("deadline_s")
            pid, number = q.submit(
                prompt, preview=bool(extra.get("preview") or payload.get("preview")),
                priority=int(extra.get("priority") or 0),
                deadline_s=None if deadline_s is None else float(deadline_s))
        except DrainingError as e:
            return self._send(503, {"error": str(e)})
        except QueueFullError as e:
            return self._send(429, {"error": str(e)})
        except (TypeError, ValueError) as e:
            return self._send(400, {"error": f"bad extra_data: {e}"})
        return self._send(200, {"prompt_id": pid, "number": number})

    def _upload_image(self):
        """Stock ``POST /upload/image``: a multipart form with an ``image`` file
        part (and an optional ``overwrite``) saved into ``$PA_INPUT_DIR``; answers
        ``{"name", "subfolder", "type"}``."""
        import email
        import email.policy
        import re

        ctype = self.headers.get("Content-Type", "")
        if "multipart/form-data" not in ctype:
            return self._send(400, {"error": "multipart/form-data required"})
        try:
            length = int(self.headers.get("Content-Length", 0))
        except ValueError:
            length = -1
        if length <= 0 or length > 64 * 1024 * 1024:
            return self._send(400, {"error": "bad Content-Length"})
        body = self.rfile.read(length)
        msg = email.message_from_bytes(
            b"Content-Type: " + ctype.encode() + b"\r\n\r\n" + body, policy=email.policy.HTTP)
        image_part, overwrite = None, False
        for part in msg.iter_parts():
            name = part.get_param("name", header="content-disposition")
            if name == "image":
                image_part = part
            elif name == "overwrite":
                overwrite = (part.get_content() or "").strip().lower() in ("1", "true", "yes")
        if image_part is None:
            return self._send(400, {"error": "no 'image' file part"})
        filename = image_part.get_filename() or "upload.png"
        # A safe basename only, never a dot-name or an empty one.
        filename = re.sub(r"[^A-Za-z0-9._-]", "_", os.path.basename(filename))
        if filename.strip("._") == "":
            filename = "upload.png"
        data = image_part.get_payload(decode=True)
        if not data:
            return self._send(400, {"error": "empty image payload"})
        in_dir = os.environ.get("PA_INPUT_DIR", "input")
        os.makedirs(in_dir, exist_ok=True)
        stem, ext = os.path.splitext(filename)
        path = os.path.join(in_dir, filename)
        if overwrite:
            with open(path, "wb") as f:
                f.write(data)
        else:
            # Stock dedupe: " (1)", " (2)", ...; "xb" makes pick-and-write atomic.
            i = 0
            while True:
                try:
                    with open(path, "xb") as f:
                        f.write(data)
                    break
                except FileExistsError:
                    i += 1
                    filename = f"{stem} ({i}){ext}"
                    path = os.path.join(in_dir, filename)
        return self._send(200, {"name": filename, "subfolder": "", "type": "input"})


class _HTTPServer(ThreadingHTTPServer):
    # http.server's default listen backlog is 5; bursts of clients overflow it.
    request_queue_size = 128
    daemon_threads = True


def make_server(host: str = "127.0.0.1", port: int = 8188, class_mappings=None,
                output_dir: str | None = None, workers: int | None = None,
                max_pending: int | None = None, serving: bool | None = None,
                host_id: str | None = None, role: str | None = None,
                device: str = DEFAULT_DEVICE, cache: WorkflowCache | None = None,
                trace: bool | None = None) -> tuple[ThreadingHTTPServer, PromptQueue]:
    """Build (not start) the HTTP server and its prompt queue. Port 0 picks a free
    port (``server.server_address`` has it). ``workers > 1`` (or
    ``$PA_SERVER_WORKERS``) runs prompts concurrently and installs the
    continuous-batching scheduler; ``max_pending`` (or ``$PA_MAX_PENDING``) bounds
    the queue; ``device`` is where graphs run (default ``cuda:0``); ``trace`` (or
    ``$PA_TRACE=1``) turns the span tracer on, so ``GET /trace`` serves timelines."""
    q = PromptQueue(class_mappings=class_mappings, output_dir=output_dir, workers=workers,
                    max_pending=max_pending, serving=serving, host_id=host_id, role=role,
                    device=device, cache=cache, trace=trace)
    handler = type("Handler", (_Handler,), {"q": q})
    return _HTTPServer((host, port), handler), q


def main(argv: list[str] | None = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(prog="python -m comfyui_parallelanything_tpu_torch.server",
                                 description="ComfyUI-compatible HTTP API over the port's host")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8188)
    ap.add_argument("--output-dir", default=None)
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="where graphs place weights and latents (default cuda:0; 'cpu')")
    ap.add_argument("--workers", type=int, default=None,
                    help="concurrent prompt workers (>1 enables continuous batching; "
                         "default $PA_SERVER_WORKERS or 1)")
    ap.add_argument("--max-pending", type=int, default=None,
                    help="bounded queue depth, 429 beyond it (default $PA_MAX_PENDING or "
                         "unbounded)")
    ap.add_argument("--host-id", default=None,
                    help="identity on /health (default $PA_HOST_ID or hostname-pid)")
    ap.add_argument("--role", default=None, help="fleet role; only 'all' is ported")
    ap.add_argument("--trace", action="store_true", default=None,
                    help="enable span tracing (GET /trace serves Chrome/Perfetto trace "
                         "JSON; default $PA_TRACE)")
    ap.add_argument("--fleet-router", default=None,
                    help="register with a fleet router (not ported: refused)")
    args = ap.parse_args(argv)
    if args.fleet_router or os.environ.get("PA_FLEET_ROUTER"):
        raise _not_ported("fleet registration (--fleet-router; ROADMAP Queue 1 item 9d)")
    srv, q = make_server(args.host, args.port, output_dir=args.output_dir,
                         workers=args.workers, max_pending=args.max_pending,
                         host_id=args.host_id, role=args.role, device=args.device,
                         trace=args.trace)
    print(f"ParallelAnything workflow server (PyTorch) on "
          f"http://{args.host}:{srv.server_address[1]} ({args.device}, {q.workers} worker(s))")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
        q.shutdown()


if __name__ == "__main__":
    main()
