"""Batched tail decode: the VAE decodes of concurrent prompts batch into shared
decode dispatches (counterpart of ``comfyui_parallelanything_tpu/serving/decode.py``).

The scheduler co-batches the denoise loop; without this queue every prompt's VAE
decode would run on its own worker thread, one decode per prompt even when four
prompts finish on the same lockstep step with the same latent shape.

- **submit/ticket**: ``TPUVAEDecode`` asks the installed queue first (the server
  installs one beside the scheduler); the worker blocks on its ticket as a sampler
  run blocks on its serving ticket. Ineligible work (a tiled decode, a video VAE,
  a latent that is not rank 4) gets None and decodes inline unchanged.
- **width-bucketed batching**: latents of the same VAE object, shape and dtype
  concatenate on the batch axis, padded with zero rows to the fixed width
  (``PA_DECODE_WIDTH``, default 4), so any 1..W group runs the decode at ONE batch
  size per (vae, shape). The decoder is independent per sample, so a pad row
  changes nothing; results are sliced back per ticket.
- **linger window**: a group dispatches when it reaches the width or when its
  oldest ticket has waited ``PA_DECODE_LINGER_S`` (default 0.01 s): decodes from
  prompts retiring off the same dispatch arrive within milliseconds.
- **metered**: ``pa_decode_dispatch_total`` / ``pa_decode_requests_total``,
  ``pa_decode_batched_fraction``, ``pa_decode_queue_depth``, wait and step
  histograms.

A batched decode runs other kernels at another batch size than the inline one,
so it equals the inline decode to the card's bf16 rounding, not bit for bit
(``tests/test_torch_serving_lanes.py`` holds it on the CPU in f32).

Tracing and the SLO plane: each ticket's queue wait is the ``decode_wait`` stage
(``utils/slo.py``); each dispatch records a ``decode-dispatch`` span on the
dispatcher's timeline and a ``decode`` span on each waiter's (its tid and prompt,
captured at submit), both ending after the dispatch's synchronise, so they hold
device time.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
import uuid
from typing import Any

import torch

from ..utils import slo, tracing
from ..utils.metrics import registry

_installed: "DecodeQueue | None" = None
_install_lock = threading.Lock()

# Process-wide batched-decode accounting (the bucket.py _batch_stats twin):
# requests decoded in dispatches carrying >1 request, over all requests.
_stats = {"total": 0, "shared": 0}
_stats_lock = threading.Lock()


def get_decode_queue() -> "DecodeQueue | None":
    """The process-wide decode queue TPUVAEDecode consults, or None (inline)."""
    return _installed


def record_decode_occupancy(occupancy: int) -> None:
    with _stats_lock:
        _stats["total"] += occupancy
        if occupancy > 1:
            _stats["shared"] += occupancy
        frac = _stats["shared"] / max(1, _stats["total"])
    registry.gauge(
        "pa_decode_batched_fraction", frac,
        help="decode requests served via shared dispatch / total",
    )


def batched_fraction() -> float:
    with _stats_lock:
        return _stats["shared"] / max(1, _stats["total"])


def _vae_token(vae) -> str:
    """Lifetime-unique token per VAE object: the group key's model component
    (``models/embed_cache.lifetime_token``)."""
    from ..models.embed_cache import lifetime_token

    return lifetime_token(vae, "_pa_decode_token")


@dataclasses.dataclass
class DecodeTicket:
    """One latent handed to the decode tail; the submitting worker blocks in
    ``result()`` for the queue wait and the shared dispatch."""

    vae: Any
    z: Any
    # Trace correlation captured at submit (utils/tracing.py).
    prompt_id: str | None = None
    trace_tid: int | None = None
    trace_id: str | None = None
    submit_ts: float = dataclasses.field(default_factory=time.monotonic)
    rid: str = dataclasses.field(default_factory=lambda: uuid.uuid4().hex)

    def __post_init__(self):
        self._done = threading.Event()
        self._result = None
        self._error: BaseException | None = None

    def resolve(self, result=None, error: BaseException | None = None) -> None:
        self._result, self._error = result, error
        self._done.set()

    def result(self, timeout: float | None = 300.0):
        if not self._done.wait(timeout):
            raise TimeoutError(f"decode ticket {self.rid} still in flight")
        if self._error is not None:
            raise self._error
        return self._result


class DecodeQueue:
    """Width-bucketed batching of tail decodes with a linger window.

    ``auto=True`` runs a dispatcher thread; ``auto=False`` exposes the same
    round as a manual ``pump()`` for deterministic tests (the scheduler's
    discipline)."""

    def __init__(self, width: int | None = None, linger_s: float | None = None,
                 auto: bool = True, max_waiting: int = 256):
        self.width = max(1, int(
            width if width is not None
            else os.environ.get("PA_DECODE_WIDTH", "4")
        ))
        self.linger_s = float(
            linger_s if linger_s is not None
            else os.environ.get("PA_DECODE_LINGER_S", "0.01")
        )
        self.max_waiting = max_waiting
        self.dispatches = 0
        # group key -> [DecodeTicket] in arrival order.
        self._groups: dict[tuple, list] = {}  # guarded-by: _lock
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._stop = False
        self._thread = None
        if auto:
            self._thread = threading.Thread(
                target=self._loop, name="pa-decode-dispatcher", daemon=True
            )
            self._thread.start()

    # -- lifecycle ----------------------------------------------------------

    def install(self) -> "DecodeQueue":
        global _installed
        with _install_lock:
            _installed = self
        return self

    def uninstall(self) -> None:
        global _installed
        with _install_lock:
            if _installed is self:
                _installed = None

    def shutdown(self, timeout: float = 10.0) -> None:
        """Stop the dispatcher and resolve every waiting ticket with an
        error — no submitter may be left blocked on a dead queue."""
        self.uninstall()
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
        with self._lock:
            groups = list(self._groups.values())
            self._groups.clear()
        for tickets in groups:
            for t in tickets:
                t.resolve(error=RuntimeError("decode queue shutdown"))

    # -- submission ---------------------------------------------------------

    def submit(self, vae, z, tile: int = 0) -> DecodeTicket | None:
        """Admit one decode, or None when it cannot share a dispatch (the caller
        decodes inline): a tiled decode runs its own tile schedule, and only a
        rank-4 image latent through the image ``VAE`` batches on dim 0."""
        from ..models.vae import VAE

        if self._stop or tile:
            return None
        if not isinstance(vae, VAE) or getattr(z, "ndim", 0) != 4:
            return None
        key = (_vae_token(vae), tuple(z.shape), str(z.dtype), str(z.device))
        ticket = DecodeTicket(
            vae=vae, z=z,
            prompt_id=tracing.current_prompt_id() if tracing.on() else None,
            trace_tid=threading.get_ident() if tracing.on() else None,
            trace_id=tracing.current_trace_id() if tracing.on() else None)
        with self._lock:
            if self._stop:
                # Re-checked under the lock: a shutdown that completed since the
                # entry check already resolved every ticket; decode inline.
                return None
            waiting = sum(len(v) for v in self._groups.values())
            if waiting >= self.max_waiting:
                return None  # backpressure: shed to the inline path
            self._groups.setdefault(key, []).append(ticket)
            registry.gauge("pa_decode_queue_depth", waiting + 1,
                           help="latents waiting for a shared decode")
            self._cond.notify_all()
        return ticket

    # -- dispatch -----------------------------------------------------------

    def _ready(self, now: float) -> list[tuple]:  # caller holds _lock
        """Group keys ripe for dispatch: width reached, or oldest ticket
        past the linger window."""
        out = []
        for key, tickets in self._groups.items():
            if not tickets:
                continue
            if len(tickets) >= self.width \
                    or now - tickets[0].submit_ts >= self.linger_s:
                out.append(key)
        return out

    def pump(self, force: bool = False) -> bool:
        """One dispatch round: run every ripe group (``force`` dispatches
        everything waiting — the manual-test / drain path). Returns whether
        anything dispatched."""
        did = False
        while True:
            with self._lock:
                now = time.monotonic()
                keys = list(self._groups) if force else self._ready(now)
                batch = None
                for key in keys:
                    tickets = self._groups.get(key) or []
                    take, rest = tickets[:self.width], tickets[self.width:]
                    if rest:
                        self._groups[key] = rest
                    else:
                        self._groups.pop(key, None)
                    if take:
                        batch = (key, take)
                        break
                if batch is None:
                    registry.gauge(
                        "pa_decode_queue_depth",
                        sum(len(v) for v in self._groups.values()),
                    )
                    return did
            self._dispatch(*batch)
            did = True

    def _dispatch(self, key: tuple, tickets: list) -> None:
        now = time.monotonic()
        for t in tickets:
            wait = now - t.submit_ts
            registry.histogram("pa_decode_wait_seconds", wait,
                               help="submit-to-dispatch decode queue wait")
            slo.observe_stage("decode_wait", wait)
        vae = tickets[0].vae
        k = len(tickets)
        t0_us = tracing.now_us() if tracing.on() else 0.0
        t0 = time.perf_counter()
        try:
            # Pad to the fixed width with inert rows (the decoder is independent
            # per sample): 1..W requests run at one batch size per (vae, shape).
            zs = [t.z for t in tickets]
            zs += [torch.zeros_like(zs[0])] * (self.width - k)
            out = vae.decode(torch.cat(zs, dim=0))
            if out.device.type == "cuda":
                # The decode histogram must include device time.
                torch.cuda.synchronize(out.device)
        except Exception as e:  # noqa: BLE001 - no waiter may hang
            for t in tickets:
                t.resolve(error=e)
            return
        dt = time.perf_counter() - t0
        b = tickets[0].z.shape[0]
        self.dispatches += 1
        registry.counter("pa_decode_dispatch_total", help="shared decode dispatches")
        registry.counter("pa_decode_requests_total", inc=k,
                         help="decode requests served: the batching numerator")
        registry.histogram("pa_decode_step_seconds", dt,
                           help="wall time of one shared decode dispatch")
        record_decode_occupancy(k)
        if tracing.on() and t0_us:
            dur_us = tracing.now_us() - t0_us
            tracing.record("decode-dispatch", t0_us, dur_us, cat="serving", occupancy=k,
                           masked=self.width - k, width=self.width)
            for t in tickets:
                tracing.record("decode", t0_us, dur_us, cat="serving", tid=t.trace_tid,
                               prompt_id=t.prompt_id, rid=t.rid, occupancy=k,
                               **({"trace_id": t.trace_id} if t.trace_id else {}))
        for i, t in enumerate(tickets):
            t.resolve(result=out[i * b:(i + 1) * b])

    def drain(self, timeout: float = 60.0) -> None:
        """Pump until nothing is waiting (manual mode helper)."""
        t0 = time.monotonic()
        while True:
            with self._lock:
                if not any(self._groups.values()):
                    return
            self.pump(force=True)
            if time.monotonic() - t0 > timeout:
                raise TimeoutError("decode drain timed out")

    def stats(self) -> dict:
        """The /health ``reuse.decode`` section."""
        with self._lock:
            waiting = sum(len(v) for v in self._groups.values())
        return {
            "width": self.width,
            "linger_s": self.linger_s,
            "waiting": waiting,
            "batched_fraction": batched_fraction(),
        }

    def _loop(self) -> None:
        while True:
            with self._cond:
                if self._stop:
                    return
                if not any(self._groups.values()):
                    self._cond.wait(timeout=0.2)
                    continue
                now = time.monotonic()
                if not self._ready(now):
                    # Sleep until the oldest group's linger lapses (bounded
                    # below so a clock hiccup can't busy-spin).
                    oldest = min(
                        t[0].submit_ts for t in self._groups.values() if t
                    )
                    delay = max(0.001, self.linger_s - (now - oldest))
                    self._cond.wait(timeout=delay)
                    continue
            try:
                self.pump()
            except Exception:  # noqa: BLE001 - the dispatcher must survive
                time.sleep(0.05)
