"""Cooperative per-step progress and interrupt (counterpart of
``comfyui_parallelanything_tpu/utils/progress.py``, the same semantics).

Inside ComfyUI the reference gets progress bars and the Cancel button from the
host. Standalone, this module is that machinery: the eager sampler loops call
``report_progress`` once per step (``sampling/runner.py``), the graph host checks
the interrupt before each node (``host.run_workflow``), and ``request_interrupt``
stops the running prompt at its next boundary.

The hooks are process-wide single slots; ``set_progress_hook`` returns the
previous hook so scoped installs nest. ``progress_scope`` installs a per-thread
(hook, preview, interrupt-event) triple that shadows the process-wide slots for
code on that thread, so one prompt's Cancel cannot stop another's.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional

_hook: Optional[Callable[[int, int], None]] = None
_preview_hook: Optional[Callable[[object], None]] = None
_interrupt = threading.Event()
_scope_local = threading.local()


class Interrupted(RuntimeError):
    """Raised between sampler steps (or before a graph node) after
    ``request_interrupt()``: ComfyUI's InterruptProcessingException."""


class ProgressScope:
    """One thread's (hook, preview, interrupt-event) triple. ``interrupt_event`` is a
    one-shot per-prompt Cancel; ``prompt_id`` names the prompt the scope serves."""

    __slots__ = ("hook", "preview_hook", "interrupt_event", "prompt_id")

    def __init__(self, hook=None, preview_hook=None, interrupt_event=None, prompt_id=None):
        self.hook = hook
        self.preview_hook = preview_hook
        self.interrupt_event = interrupt_event
        self.prompt_id = prompt_id


@contextlib.contextmanager
def progress_scope(hook=None, preview_hook=None, interrupt_event=None, prompt_id=None):
    """Install a per-thread ``ProgressScope`` for the block; nests (the previous
    scope comes back on exit, and a nested scope keeps its parent's prompt id)."""
    prev = getattr(_scope_local, "scope", None)
    if prompt_id is None and prev is not None:
        prompt_id = prev.prompt_id
    scope = ProgressScope(hook, preview_hook, interrupt_event, prompt_id)
    _scope_local.scope = scope
    try:
        yield scope
    finally:
        _scope_local.scope = prev


def current_scope() -> Optional[ProgressScope]:
    """The calling thread's active scope, or None (the process-wide slots)."""
    return getattr(_scope_local, "scope", None)


def current_progress_hook() -> Optional[Callable[[int, int], None]]:
    """The hook ``report_progress`` would fire on this thread now."""
    scope = current_scope()
    if scope is not None and scope.hook is not None:
        return scope.hook
    return _hook


def current_preview_hook() -> Optional[Callable[[object], None]]:
    """The preview hook active on this thread (its scope's, else the slot's)."""
    scope = current_scope()
    if scope is not None and scope.preview_hook is not None:
        return scope.preview_hook
    return _preview_hook


def set_progress_hook(fn: Optional[Callable[[int, int], None]]):
    """Install ``fn(value, max_value)`` as the step hook; returns the previous one."""
    global _hook
    prev, _hook = _hook, fn
    return prev


def set_preview_hook(fn: Optional[Callable[[object], None]]):
    """Install ``fn(latent)`` to receive the current latent once per eager sampler
    step; returns the previous hook. The captured whole-loop path has no step
    boundaries and sends no previews."""
    global _preview_hook
    prev, _preview_hook = _preview_hook, fn
    return prev


def request_interrupt() -> None:
    """Ask the running sampler loop to stop at its next step boundary."""
    _interrupt.set()


def clear_interrupt() -> None:
    """Reset the flag, so a stale interrupt cannot stop the next prompt."""
    _interrupt.clear()


def interrupt_requested() -> bool:
    return _interrupt.is_set()


def check_interrupt(where: str = "between nodes") -> None:
    """Honour a pending interrupt: the scope's event (not consumed), or the
    process-wide flag (consumed, so the next prompt starts clean)."""
    scope = current_scope()
    if (scope is not None and scope.interrupt_event is not None
            and scope.interrupt_event.is_set()):
        raise Interrupted(f"interrupted {where}")
    if _interrupt.is_set():
        _interrupt.clear()
        raise Interrupted(f"interrupted {where}")


def report_progress(value: int, max_value: int, latent=None) -> None:
    """One sampler step done: call the hook, then the preview hook with the current
    latent (when both are there), then honour a pending interrupt."""
    hook = current_progress_hook()
    preview = current_preview_hook()
    if hook is not None:
        hook(value, max_value)
    if preview is not None and latent is not None:
        preview(latent)
    check_interrupt(f"at step {value}/{max_value}")
