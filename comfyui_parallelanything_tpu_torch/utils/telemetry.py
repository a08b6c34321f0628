"""Device-memory telemetry and the server's health document (counterpart of the
part of ``comfyui_parallelanything_tpu/utils/telemetry.py`` that the server and
the scheduler call).

- :class:`HbmWatermark` folds per-device peaks (``devices/memory.memory_snapshot``)
  into ``peak_bytes``; :class:`MemoryMonitor` samples it and the ``pa_hbm_*``
  gauges on a daemon thread, so ``GET /health`` and ``GET /metrics`` stay fresh
  between requests.
- :func:`health_snapshot` is ``GET /health``'s document: load average, devices,
  per-card memory and the peak watermark, the queue and admission state the
  server passes in, and the reuse section (embed cache, decode tail, serving
  buckets).

The OOM classifier the JAX module keeps here (``looks_like_oom``) is the port's
``parallel/orchestrator.is_out_of_memory``. Left out, and listed in the document's
``not_ported`` field instead of filled with invented values: the compile
accounting (the port compiles its kernels once, in the ``nvcc`` build), the
roofline and planner sections, the numerics sentinel and the anomaly/timeseries
plane (ROADMAP Queue 1 items 8, 9b and 9d); also the perf ledger and the postmortem
bundles (item 9d).
"""

from __future__ import annotations

import os
import threading
import time

HEALTH_SCHEMA = "pa-health/v3"

NOT_PORTED_SECTIONS = ("compile", "roofline", "plan", "numerics", "anomaly")


def _loadavg_1m() -> float | None:
    try:
        return round(os.getloadavg()[0], 2)
    except (AttributeError, OSError):
        return None


class HbmWatermark:
    """Peak device memory over explicit samples: ``sample()`` reads every card
    (``memory_snapshot``) and folds the largest ``bytes_in_use`` or allocator peak
    into ``peak_bytes``."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.peak_bytes = 0
        self.samples = 0
        self.last: list[dict] | None = None

    def sample(self, devices=None) -> list[dict]:
        from ..devices.memory import memory_snapshot

        snap = memory_snapshot(devices)
        peak = max((max(s["bytes_in_use"], s.get("peak_bytes_in_use") or 0) for s in snap),
                   default=0)
        with self._lock:
            self.peak_bytes = max(self.peak_bytes, peak)
            self.samples += 1
            self.last = snap
        from .metrics import registry

        registry.gauge("pa_hbm_peak_bytes", self.peak_bytes,
                       help="max per-device bytes in use observed by the watermark")
        return snap


watermark = HbmWatermark()


class MemoryMonitor:
    """Periodic device-memory sampler (daemon thread): feeds the watermark and the
    ``pa_hbm_*`` gauges. A failed read is skipped, never raised into the server."""

    def __init__(self, interval_s: float = 60.0):
        self.interval_s = max(1.0, float(interval_s))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, name="pa-memory-monitor",
                                        daemon=True)

    def start(self) -> "MemoryMonitor":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                from ..devices.memory import publish_memory_gauges

                publish_memory_gauges()
                watermark.sample()
            except Exception:  # noqa: BLE001 - the sampler must not take the server down
                pass


def health_snapshot(queue: dict | None = None, host: dict | None = None) -> dict:
    """``GET /health``'s document. ``host`` (identity and admission: ``host_id``,
    ``accepting``, ``inflight_prompts``, ``role``) merges top-level;
    ``queue`` is the server's queue section. Every section degrades to None on
    its own: a failed device read does not blank the host-side sections."""
    out: dict = {
        "schema": HEALTH_SCHEMA,
        "ts": time.time(),
        "loadavg_1m": _loadavg_1m(),
        "not_ported": list(NOT_PORTED_SECTIONS),
    }
    if host:
        out.update(host)
    try:
        from ..devices.discovery import available_devices

        out["devices"] = available_devices()
    except Exception:  # noqa: BLE001
        out["devices"] = None
    try:
        from ..devices.memory import memory_snapshot

        hbm = memory_snapshot()
        out["hbm"] = hbm
        utils = [s["utilization"] for s in hbm if s.get("utilization") is not None]
        out["hbm_utilization_max"] = max(utils) if utils else None
    except Exception:  # noqa: BLE001
        out["hbm"] = None
        out["hbm_utilization_max"] = None
    out["peak_hbm_bytes"] = watermark.peak_bytes or None
    try:
        from ..models.embed_cache import cache as embed_cache
        from ..serving.decode import get_decode_queue
        from ..serving.scheduler import get_scheduler

        dq, sched = get_decode_queue(), get_scheduler()
        out["reuse"] = {
            "embed_cache": embed_cache.stats(),
            "decode": dq.stats() if dq is not None else None,
            "serving": sched.reuse_stats() if sched is not None else None,
        }
    except Exception:  # noqa: BLE001
        out["reuse"] = None
    if queue is not None:
        out["queue"] = queue
    return out
