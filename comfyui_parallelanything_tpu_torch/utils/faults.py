"""Fault injection: one plan syntax, one arming rule, every site (counterpart of
``comfyui_parallelanything_tpu/utils/faults.py``, the same module).

- **Named sites** (:data:`FAULT_SITES`). A call site asks
  ``faults.check("<site>", key=...)`` at the point where the real failure would
  happen; with no armed plan that is one attribute read. The port's sites:
  ``stream-prefetch-oom`` (the streaming runner's stage placement, so the
  ``stream-recarve`` rung runs), ``compile-fail`` (the first capture of a
  whole-loop CUDA graph, so the ``compile-eager`` rung runs), ``slow-host`` (the
  server's prompt worker), ``backend-http`` (HTTP ingress) and ``lane-nan`` (a
  serving lane's eval input, through ``utils/numerics.take_injection``).
  ``heartbeat-loss``, ``journal-corrupt``, ``slow-disk``, ``network-partition`` and
  ``mid-step-crash`` parse, and have no call site in the port until the fleet tier
  (ROADMAP Queue 1 item 9d).
- **A deterministic seeded plan**: ``PA_FAULT_PLAN`` is JSON,
  ``{"seed": N, "faults": [{"site": ..., "match": ..., "nth": ..., "count": ...,
  "delay_s": ..., "mode": ...}]}`` (or a bare list; seed 0). ``match``
  substring-filters the site's ``key``; ``nth`` fires on the nth eligible hit
  (1-based; omitted, it derives from the plan seed, so two runs of one seed fire at
  the same points); ``count`` is how many consecutive hits fire (``null``: every
  hit from ``nth`` on); ``delay_s`` rides delay-type faults.
- **One arming rule**: a plan (or the legacy ``PA_FAIL_INJECT`` alias) fires only
  under an explicit ``PA_EVIDENCE_DIR`` / ``PA_LEDGER_DIR`` redirect; without one it
  parses (a typo still fails loudly) and never fires.
- **Attribution**: every fired fault records an instant ``faults``-category span
  (``fault-injected``) and counts ``pa_fault_injected_total{site=}``.

Legacy aliases: ``PA_FAIL_INJECT=nan:<lane>`` is a one-shot ``lane-nan`` fault; any
other value is ``mid-step-crash`` firing from hit 3 on.

The module level is stdlib-only with no package-relative imports: it loads as part
of the package or alone by path, and the span and counter fall back to nothing when
the package cannot be imported.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
import time

# Site vocabulary: name → where it injects (the call site owns the failure
# shape; this table is the operator-facing contract, README "Fault
# tolerance"). check() accepts only these names so a typo'd plan fails
# loudly at parse instead of silently never firing.
FAULT_SITES = {
    "stream-prefetch-oom": "parallel/streaming.py stage placement — raises an "
                           "out-of-memory error so the re-carve ladder runs",
    "compile-fail": "sampling/compiled.py first capture of a loop — raises "
                    "so the compile→eager degradation rung runs",
    "backend-http": "server.py HTTP ingress — mode drop/delay/5xx per "
                    "request path (key = METHOD /path)",
    "heartbeat-loss": "fleet HeartbeatClient — the beat is silently skipped "
                      "(the router sees the host go dark)",
    "slow-host": "server.py prompt worker — sleeps delay_s before the "
                 "prompt executes (straggler rehearsal)",
    "mid-step-crash": "chaos denoise step (no call site in the port yet) — "
                      "raises an OOM-shaped error mid-run",
    "lane-nan": "serving lane eval input (via utils/numerics.take_injection) "
                "— match is the lane index to poison",
    "journal-corrupt": "fleet PromptJournal.append — the record's line is "
                       "written torn (mode=truncate: half the bytes, no "
                       "newline) or garbled (mode=garble: NULs mid-line), "
                       "rehearsing a router crash mid-write; match filters "
                       "the event name (submit/dispatch/resolve)",
    "slow-disk": "fleet PromptJournal.append + utils/telemetry ledger "
                 "writes — sleeps delay_s inside the append (the fsync "
                 "stall rehearsal: journal/ledger latency shows up in "
                 "pa_disk_append_seconds and the anomaly sentinel's "
                 "disk_append_p95 watch); match filters the target "
                 "(journal event name, or 'ledger')",
    "network-partition": "fleet router↔backend link — BOTH directions of "
                         "one host's traffic drop while each side stays "
                         "alive: router _post/_get raises a refused-socket "
                         "OSError (key = 'router-><base>') and the host's "
                         "HeartbeatClient silently skips its beat (key = "
                         "'<host_id>->router'); match filters the key, so "
                         "one spec partitions one host, two specs cut both "
                         "directions",
}


def _stable_u64(key: str) -> int:
    return int.from_bytes(hashlib.md5(key.encode()).digest()[:8], "big")


@dataclasses.dataclass
class FaultSpec:
    """One parsed plan entry. ``nth`` None → derived from the plan seed."""

    site: str
    match: str | None = None
    nth: int | None = None
    count: int | None = 1          # None = every hit from nth on
    delay_s: float = 0.0
    mode: str | None = None

    def resolved_nth(self, seed: int) -> int:
        if self.nth is not None:
            return max(1, int(self.nth))
        # Deterministic in (plan seed, site, match): same seed → same firing
        # schedule, different sites de-correlate. Band [1, 4] keeps derived
        # faults inside short CI workloads.
        return 1 + _stable_u64(f"{seed}:{self.site}:{self.match}") % 4


@dataclasses.dataclass
class FaultAction:
    """What a call site receives when its fault fires."""

    site: str
    mode: str | None
    delay_s: float
    key: str
    hit: int            # which eligible hit this was (1-based)
    spec: FaultSpec

    def sleep(self) -> None:
        if self.delay_s > 0:
            time.sleep(self.delay_s)


class FaultPlanError(ValueError):
    """Malformed PA_FAULT_PLAN — raised at parse, never silently ignored."""


def parse_plan(raw) -> tuple[int, list[FaultSpec]]:
    """(seed, specs) from the PA_FAULT_PLAN JSON value (dict or bare list)."""
    if isinstance(raw, str):
        try:
            raw = json.loads(raw)
        except json.JSONDecodeError as e:
            raise FaultPlanError(f"PA_FAULT_PLAN is not JSON: {e}") from e
    if isinstance(raw, list):
        seed, entries = 0, raw
    elif isinstance(raw, dict):
        seed = int(raw.get("seed", 0))
        entries = raw.get("faults", [])
    else:
        raise FaultPlanError(f"PA_FAULT_PLAN must be a dict or list, "
                             f"got {type(raw).__name__}")
    specs = []
    for i, e in enumerate(entries):
        if not isinstance(e, dict) or "site" not in e:
            raise FaultPlanError(f"fault entry {i} must be an object with "
                                 f"a 'site': {e!r}")
        site = str(e["site"])
        if site not in FAULT_SITES:
            raise FaultPlanError(
                f"unknown fault site {site!r} (have: "
                f"{', '.join(sorted(FAULT_SITES))})"
            )
        count = e.get("count", 1)
        specs.append(FaultSpec(
            site=site,
            match=None if e.get("match") is None else str(e["match"]),
            nth=None if e.get("nth") is None else int(e["nth"]),
            count=None if count is None else int(count),
            delay_s=float(e.get("delay_s", 0.0)),
            mode=None if e.get("mode") is None else str(e["mode"]),
        ))
    return seed, specs


def _legacy_specs(value: str) -> list[FaultSpec]:
    """The PA_FAIL_INJECT alias, parsed as the JAX package parses it."""
    if value.startswith("nan:"):
        try:
            lane = int(value.split(":", 1)[1])
        except ValueError:
            return []
        return [FaultSpec(site="lane-nan", match=str(lane), nth=1, count=1)]
    # The JAX bench's contract: the third step (and every one after, though the
    # first raise ends the run) fails with an OOM-shaped error.
    return [FaultSpec(site="mid-step-crash", mode="oom", nth=3, count=None)]


class FaultRegistry:
    """Hit counting + firing decisions for one parsed plan. Thread-safe —
    sites fire from HTTP handler threads, the serving dispatcher, and the
    streaming runner concurrently."""

    def __init__(self, seed: int = 0, specs: list[FaultSpec] | None = None,
                 armed: bool = True):
        self.seed = int(seed)
        # unguarded: write-once at construction (refresh() swaps the
        # whole REGISTRY object, never this list), read-only afterwards
        self.specs = list(specs or ())
        self.armed = bool(armed) and bool(self.specs)
        self.env_sig: tuple | None = None   # what from_env parsed, for refresh()
        self._hits: dict[tuple[int, str], int] = {}   # (spec idx, key-class) — guarded-by: _lock
        self._fired: dict[str, int] = {}              # site → fired count — guarded-by: _lock
        self._lock = threading.Lock()

    @classmethod
    def from_env(cls, env=os.environ) -> "FaultRegistry":
        plan = env.get("PA_FAULT_PLAN")
        legacy = env.get("PA_FAIL_INJECT")
        redirected = bool(env.get("PA_EVIDENCE_DIR") or env.get("PA_LEDGER_DIR"))
        if plan:
            seed, specs = parse_plan(plan)
        elif legacy:
            seed, specs = 0, _legacy_specs(legacy)
        else:
            reg = cls(armed=False)
            reg.env_sig = _env_sig(env)
            return reg
        # The one arming rule: no evidence/ledger redirect → the plan parses
        # (typos still fail loudly) but never fires.
        reg = cls(seed=seed, specs=specs, armed=redirected)
        reg.env_sig = _env_sig(env)
        return reg

    def check(self, site: str, key: str = "") -> FaultAction | None:
        """The per-site hook. Counts one eligible hit per matching spec and
        returns the first spec whose firing window covers it (else None).
        Fired faults are recorded (span + counter) before returning."""
        if not self.armed:
            return None
        action = None
        with self._lock:
            for idx, spec in enumerate(self.specs):
                if spec.site != site:
                    continue
                if spec.match is not None and spec.match not in key:
                    continue
                hkey = (idx, "")
                self._hits[hkey] = hit = self._hits.get(hkey, 0) + 1
                nth = spec.resolved_nth(self.seed)
                in_window = hit >= nth and (
                    spec.count is None or hit < nth + spec.count
                )
                if in_window and action is None:
                    action = FaultAction(site=site, mode=spec.mode,
                                         delay_s=spec.delay_s, key=key,
                                         hit=hit, spec=spec)
            if action is not None:
                self._fired[site] = self._fired.get(site, 0) + 1
        if action is not None:
            self._record_fired(action)
        return action

    def record_external(self, site: str, key: str = "", mode=None) -> None:
        """Attribution for a fault the plan armed but a SUBSYSTEM executes
        (the lane-nan poke lives in utils/numerics.take_injection, which owns
        the one-shot/seating semantics) — same span + counter as check()."""
        with self._lock:
            self._fired[site] = self._fired.get(site, 0) + 1
        self._record_fired(FaultAction(site=site, mode=mode, delay_s=0.0,
                                       key=key, hit=0,
                                       spec=FaultSpec(site=site)))

    @staticmethod
    def _record_fired(action: FaultAction) -> None:
        """Span + counter + log — every injected fault is attributable.
        Package imports are lazy and best-effort: this module stays
        standalone-loadable, and attribution must never mask the fault."""
        try:
            from . import tracing

            if tracing.on():
                now = tracing.now_us()
                tracing.record(
                    "fault-injected", now, 0.0, cat="faults",
                    site=action.site, mode=action.mode, key=action.key,
                    hit=action.hit,
                )
        except Exception:  # noqa: BLE001 — standalone load / tracing hiccup
            pass
        try:
            from .metrics import registry

            registry.counter(
                "pa_fault_injected_total", labels={"site": action.site},
                help="faults fired by the injection registry (utils/faults.py)"
                     " — chaos runs prove their injections here",
            )
        except Exception:  # noqa: BLE001
            pass
        try:
            from .logging import get_logger

            get_logger().warning(
                "fault injected [%s] mode=%s key=%s hit=%d",
                action.site, action.mode, action.key, action.hit,
            )
        except Exception:  # noqa: BLE001
            pass

    def lane_nan_target(self) -> int | None:
        """The lane index of the first un-exhausted ``lane-nan`` spec, or
        None. Does NOT consume a hit — utils/numerics.take_injection owns
        the one-shot/seated semantics; it reports consumption back through
        :meth:`record_external`."""
        if not self.armed:
            return None
        with self._lock:
            for spec in self.specs:
                if spec.site != "lane-nan":
                    continue
                try:
                    return int(spec.match or "0")
                except ValueError:
                    continue
        return None

    def fired(self) -> dict[str, int]:
        with self._lock:
            return dict(self._fired)

    def reset(self) -> None:
        """Clear hit/fired counters (re-arm) — tests and the dryrun's
        repeated injection sections."""
        with self._lock:
            self._hits.clear()
            self._fired.clear()


def _env_sig(env=os.environ) -> tuple:
    return (env.get("PA_FAULT_PLAN"), env.get("PA_FAIL_INJECT"),
            bool(env.get("PA_EVIDENCE_DIR") or env.get("PA_LEDGER_DIR")))


# Process-wide registry, parsed from the env at import (the server and scripts set the
# env before the package loads). reload() re-reads unconditionally;
# refresh() re-reads only when the relevant env vars changed since the parse
# — the sites that must honor env set mid-process (utils/numerics.py's
# lane-nan path, guarded by its own sentinel flag) call refresh().
registry = FaultRegistry.from_env()


def active() -> bool:
    """The hot-path flag — True only when an armed plan exists."""
    return registry.armed


def check(site: str, key: str = "") -> FaultAction | None:
    """Module-level hook every instrumented site calls. Disabled path is
    this one attribute read."""
    if not registry.armed:
        return None
    return registry.check(site, key)


def fired() -> dict[str, int]:
    return registry.fired()


def reset() -> None:
    registry.reset()


def reload() -> FaultRegistry:
    global registry
    registry = FaultRegistry.from_env()
    return registry


def refresh() -> FaultRegistry:
    """Re-parse the env ONLY when the fault-relevant vars changed — cheap
    enough for sites whose callers set the env after package import."""
    if registry.env_sig != _env_sig():
        return reload()
    return registry


def oom_error(action: FaultAction) -> RuntimeError:
    """The injected out-of-memory error: what the port's
    ``parallel/orchestrator.is_out_of_memory`` takes for an OOM (a
    ``torch.cuda.OutOfMemoryError``), so the degradation ladders treat it as the
    real thing. Without torch, a ``RuntimeError`` carrying the host allocator's
    message, which the classifier also takes."""
    msg = f"injected failure (site={action.site}, hit={action.hit})"
    try:
        import torch

        return torch.cuda.OutOfMemoryError(f"CUDA out of memory: {msg}")
    except Exception:  # noqa: BLE001 - standalone load without torch
        return RuntimeError(f"DefaultCPUAllocator: can't allocate memory: {msg}")
