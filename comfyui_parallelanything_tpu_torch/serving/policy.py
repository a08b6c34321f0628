"""Admission policy for the continuous-batching scheduler (counterpart of
``comfyui_parallelanything_tpu/serving/policy.py``).

Who joins a bucket's next free lane (FIFO within a priority), when a request is
refused instead of queued (bounded depth), and when a queued request is abandoned
(deadline, client cancel). Host-side bookkeeping only: nothing here touches a
tensor.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time


class ServingRejected(RuntimeError):
    """Admission refused (bounded queue depth): the scheduler's caller runs
    inline; the HTTP layer maps its own depth bound to 429."""


class DeadlineExceeded(RuntimeError):
    """The request's deadline passed before (or while) it held a lane."""


class AdmissionQueue:
    """Priority-FIFO waiting line with a depth bound.

    Ordering: higher ``priority`` first, FIFO (submit order) within a
    priority: the heap key is ``(-priority, seq)``. ``max_waiting`` bounds the
    line; ``push`` raises ServingRejected beyond it (an unbounded line turns
    overload into silent latency)."""

    _seq = itertools.count()

    def __init__(self, max_waiting: int = 64):
        self.max_waiting = max_waiting
        self._heap: list[tuple[float, int, object]] = []  # guarded-by: _lock
        self._lock = threading.Lock()

    def __len__(self) -> int:
        with self._lock:
            return len(self._heap)

    def push(self, request) -> None:
        with self._lock:
            if len(self._heap) >= self.max_waiting:
                raise ServingRejected(
                    f"admission queue full ({self.max_waiting} waiting)"
                )
            heapq.heappush(
                self._heap,
                (-float(getattr(request, "priority", 0)), next(self._seq), request),
            )

    def pop(self):
        """Highest-priority oldest request, or None when empty."""
        with self._lock:
            if not self._heap:
                return None
            return heapq.heappop(self._heap)[2]

    def expired(self, now: float | None = None):
        """Pop every queued request whose deadline has passed (resolved by the
        caller with DeadlineExceeded)."""
        now = time.monotonic() if now is None else now
        out = []
        with self._lock:
            keep = []
            for entry in self._heap:
                req = entry[2]
                dl = getattr(req, "deadline", None)
                (out if dl is not None and now >= dl else keep).append(entry)
            if out:
                self._heap = [e for e in keep]
                heapq.heapify(self._heap)
        return [e[2] for e in out]
