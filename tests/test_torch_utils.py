"""The port's step clocks, finite checks and setup log lines (``utils/metrics.py``,
``utils/checks.py``, ``utils/logging.py``) against the JAX package on the CPU.

- ``checked``: a forward whose output holds a NaN or an Inf raises ``ValueError``
  on the host with the JAX message (``"<name>[leaf i] contains NaN/Inf"``, leaf i
  the first non-finite floating-point leaf; integer leaves are not checked); a
  finite output passes through unchanged.
- ``StepTimer``: on one scripted clock both timers keep the warm-up steps apart
  from the throughput stats and end with equal ``StepStats``; the port waits for
  the step's output on the device before the clock stops, as the JAX timer blocks.
- ``force_ready`` and ``chained_time``: the same readback and the same chain of
  calls (warm-up included) with equal outputs.
- ``log_setup_summary`` and ``log_placement``: the JAX log lines.
"""

import logging
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401
from test_torch_quick_jax import quick_jax_compiles  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from comfyui_parallelanything_tpu.utils import checks as jchecks  # noqa: E402
from comfyui_parallelanything_tpu.utils import logging as jlogging  # noqa: E402
from comfyui_parallelanything_tpu.utils import metrics as jmetrics  # noqa: E402
from comfyui_parallelanything_tpu_torch.utils import checks as pchecks  # noqa: E402
from comfyui_parallelanything_tpu_torch.utils import logging as plogging  # noqa: E402
from comfyui_parallelanything_tpu_torch.utils import metrics as pmetrics  # noqa: E402

X = np.random.default_rng(0).normal(size=(2, 3)).astype(np.float32)


def _forward(bad):
    """A forward with three outputs: a float tensor, an integer one and a float one
    that holds ``bad`` at one place (None: finite)."""
    def make(asarray, x):
        last = np.array(X) * 2.0
        if bad is not None:
            last[1, 2] = bad
        return (asarray(x), asarray(np.arange(3, dtype=np.int32)), asarray(last))
    return make


@pytest.mark.parametrize("bad", [float("nan"), float("inf"), -float("inf")])
def test_checked_raises_on_a_non_finite_output_as_jax_does(bad):
    make = _forward(bad)
    jfn = jchecks.checked(lambda x: make(jnp.asarray, x), "toy forward")
    pfn = pchecks.checked(lambda x: make(torch.from_numpy, x.numpy()), "toy forward")
    with pytest.raises(ValueError) as jerr:
        jfn(jnp.asarray(X))
    with pytest.raises(ValueError) as perr:
        pfn(torch.from_numpy(X))
    assert "toy forward[leaf 2] contains NaN/Inf" in str(jerr.value)
    assert "toy forward[leaf 2] contains NaN/Inf" in str(perr.value)
    with pytest.raises(ValueError, match=r"out\[leaf 0\] contains NaN/Inf"):
        pchecks.assert_finite({"a": torch.tensor([1.0, bad]), "b": torch.ones(2)}, "out")


def test_checked_passes_a_finite_output_through():
    make = _forward(None)
    jout = jchecks.checked(lambda x: make(jnp.asarray, x))(jnp.asarray(X))
    pout = pchecks.checked(lambda x: make(torch.from_numpy, x.numpy()))(torch.from_numpy(X))
    for j, p in zip(jout, pout):
        np.testing.assert_array_equal(np.asarray(j), p.numpy())


def _scripted_clock(monkeypatch, module, events):
    ticks = iter([0.0, 5.0, 5.0, 7.0, 7.0, 8.5, 8.5, 9.25, 100.0, 100.5])

    def clock():
        events.append("clock")
        return next(ticks)

    monkeypatch.setattr(module, "time", types.SimpleNamespace(perf_counter=clock))


def test_step_timer_keeps_warmup_apart_and_waits_for_the_device(monkeypatch):
    events = []
    monkeypatch.setattr(pmetrics, "_wait_for", lambda v: events.append(("wait", v)))
    timers = {"jax": jmetrics.StepTimer(warmup_steps=1),
              "port": pmetrics.StepTimer(warmup_steps=1)}
    for side, timer in timers.items():
        events.clear()
        _scripted_clock(monkeypatch, jmetrics if side == "jax" else pmetrics, events)
        arrays = jnp.asarray if side == "jax" else torch.from_numpy
        outs = [timer.time_step(lambda x: x * 2, arrays(X), batch_size=2) for _ in range(4)]
        np.testing.assert_array_equal(np.asarray(outs[-1]), X * 2)
        with timer.step():  # an empty box: nothing to wait for
            pass
    j, p = timers["jax"], timers["port"]
    assert vars(p.warmup) == vars(j.warmup) == dict(steps=1, total_s=5.0, images=2, last_s=5.0)
    assert vars(p.stats) == vars(j.stats) == dict(steps=4, total_s=4.75, images=7, last_s=0.5)
    assert p.stats.sec_per_it == j.stats.sec_per_it and p.stats.images_per_sec == \
        j.stats.images_per_sec
    # The port's last run: the clock stops only after the wait on each step's output.
    assert [e if e == "clock" else e[0] for e in events] == \
        ["clock", "wait", "clock"] * 4 + ["clock", "clock"]


def test_force_ready_and_chained_time_match_jax():
    calls = {"jax": 0, "port": 0}

    def stepper(side):
        def step(x):
            calls[side] += 1
            return x * 0.5 + 1.0
        return step

    assert pmetrics.force_ready(torch.from_numpy(X)) == pytest.approx(
        jmetrics.force_ready(jnp.asarray(X)), rel=1e-6)
    j_s, j_out = jmetrics.chained_time(stepper("jax"), jnp.asarray(X), iters=3, warmup=1)
    p_s, p_out = pmetrics.chained_time(stepper("port"), torch.from_numpy(X), iters=3, warmup=1)
    assert calls["port"] == calls["jax"] == 5  # warm-up raised to 2, then 3 timed
    assert p_s > 0 and j_s > 0
    np.testing.assert_allclose(p_out.numpy(), np.asarray(j_out), rtol=1e-6)


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def test_setup_and_placement_log_lines_match_jax():
    # Both packages' loggers write to stderr and do not propagate: listen on each.
    lines = {}
    for side, mod in (("jax", jlogging), ("port", plogging)):
        logger, handler = mod.get_logger(), _Lines()
        logger.addHandler(handler)
        try:
            mod.log_setup_summary(["cuda:0", "cuda:1"], [0.625, 0.375], "data-parallel")
            mod.log_placement("cuda:1", "double_blocks[0:9]")
        finally:
            logger.removeHandler(handler)
        lines[side] = handler.lines
    assert lines["port"] == lines["jax"] == [
        "parallel setup (data-parallel): cuda:0=62.5%, cuda:1=37.5%",
        "placed double_blocks[0:9] on cuda:1"]
