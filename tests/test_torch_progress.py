"""Progress, interrupt, latent preview and ``sampler_prefs`` in the port
(``utils/progress.py``, ``utils/latent_preview.py``, ``sampling/runner.py``)
against the JAX package's: the progress and preview hooks fire once per step with
the same (value, max) and the same latents on the k-sampler, DDIM and flow
branches, an interrupt raises ``Interrupted`` between steps and between graph
nodes, the captured loop reports no steps, and a model's
``sampler_prefs["cfg_rescale"]`` is the default the caller's 0 yields to. The
model is a small per-sample function both sides compute the same way. f32,
rtol/atol 2e-4."""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from comfyui_parallelanything_tpu.sampling import runner as jrunner  # noqa: E402
from comfyui_parallelanything_tpu.utils import latent_preview as jpreview  # noqa: E402
from comfyui_parallelanything_tpu.utils import progress as jprogress  # noqa: E402
from comfyui_parallelanything_tpu_torch import host as phost  # noqa: E402
from comfyui_parallelanything_tpu_torch.sampling import runner as prunner  # noqa: E402
from comfyui_parallelanything_tpu_torch.utils import latent_preview as ppreview  # noqa: E402
from comfyui_parallelanything_tpu_torch.utils import progress as pprogress  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
SHAPE = (1, 4, 4, 4)


class _Model:
    """x·(0.9 + 0.1·m) + 0.05·sin(t/300) + m, m the context's mean, per sample, on
    either side."""

    def __init__(self, lib, prefs=None):
        self.lib = lib
        if prefs is not None:
            self.sampler_prefs = prefs

    def __call__(self, x, t, context=None, **kw):
        lib = self.lib
        tt = t.reshape((-1,) + (1,) * (x.ndim - 1))
        m = context.mean(axis=(1, 2)).reshape(tt.shape)
        return x * (0.9 + 0.1 * m) + 0.05 * lib.sin(tt / 300.0) + m


def _inputs():
    rng = np.random.default_rng(0)
    noise = rng.standard_normal(SHAPE).astype(np.float32)
    ctx = rng.standard_normal((1, 3, 8)).astype(np.float32)
    uctx = rng.standard_normal((1, 3, 8)).astype(np.float32)
    return noise, ctx, uctx


def _run_jax(sampler, steps, **kw):
    noise, ctx, uctx = _inputs()
    return np.asarray(jrunner.run_sampler(
        _Model(jnp, kw.pop("prefs", None)), jnp.asarray(noise), jnp.asarray(ctx),
        sampler=sampler, steps=steps, cfg_scale=3.0, uncond_context=jnp.asarray(uctx), **kw))


def _run_port(sampler, steps, **kw):
    noise, ctx, uctx = _inputs()
    T = torch.from_numpy
    return prunner.run_sampler(_Model(torch, kw.pop("prefs", None)), T(noise), T(ctx),
                               sampler=sampler, steps=steps, cfg_scale=3.0,
                               uncond_context=T(uctx), **kw).numpy()


@pytest.fixture
def hooks():
    """Install the same recording progress and preview hooks on both sides."""
    seen = {"jax": ([], []), "port": ([], [])}
    prev = [(jprogress.set_progress_hook(lambda v, m: seen["jax"][0].append((v, m))),
             jprogress.set_preview_hook(lambda x: seen["jax"][1].append(np.asarray(x)))),
            (pprogress.set_progress_hook(lambda v, m: seen["port"][0].append((v, m))),
             pprogress.set_preview_hook(lambda x: seen["port"][1].append(x.clone())))]
    yield seen
    for mod, (h, p) in zip((jprogress, pprogress), prev):
        mod.set_progress_hook(h)
        mod.set_preview_hook(p)
        mod.clear_interrupt()


@pytest.mark.parametrize("sampler,kw", [("euler", {}), ("dpmpp_2m", {}), ("heun", {}),
                                        ("ddim", {}), ("flow_euler", {}),
                                        ("euler", {"prediction": "flow"})])
def test_hooks_fire_once_per_step_as_in_jax(hooks, sampler, kw):
    want = _run_jax(sampler, 3, **kw)
    got = _run_port(sampler, 3, **kw)
    np.testing.assert_allclose(got, want, **TOL)
    (jsteps, jlat), (psteps, plat) = hooks["jax"], hooks["port"]
    # One call per step (the JAX DDIM loop reports over its timestep count).
    n = 4 if sampler == "ddim" else 3
    assert psteps == jsteps == [(i + 1, n) for i in range(n)]
    assert len(plat) == len(jlat) == n
    for p, j in zip(plat, jlat):
        np.testing.assert_allclose(p.numpy(), j, **TOL)


def test_the_captured_loop_reports_no_steps(hooks):
    eager = _run_port("euler", 3)
    hooks["port"][0].clear()
    hooks["port"][1].clear()
    looped = _run_port("euler", 3, compile_loop=True)
    np.testing.assert_allclose(looped, eager, rtol=1e-6, atol=1e-6)
    assert hooks["port"] == ([], [])


def test_interrupt_stops_between_steps(hooks):
    calls = []

    def hook(v, m):
        calls.append(v)
        if v == 1:
            pprogress.request_interrupt()

    pprogress.set_progress_hook(hook)
    with pytest.raises(pprogress.Interrupted, match="at step 1/3"):
        _run_port("euler", 3)
    assert calls == [1] and not pprogress.interrupt_requested()  # consumed


def test_interrupt_inside_a_sampler_node_stops_the_graph(hooks):
    ran = []

    class Sample:
        RETURN_TYPES = ("LATENT",)
        FUNCTION = "go"

        def go(self):
            pprogress.set_progress_hook(lambda v, m: pprogress.request_interrupt())
            return (_run_port("euler", 3),)

    class After:
        RETURN_TYPES = ("X",)
        FUNCTION = "go"

        @classmethod
        def INPUT_TYPES(cls):
            return {"required": {"latent": ("LATENT", {})}}

        def go(self, latent):
            ran.append(1)
            return (latent,)

    wf = {"s": {"class_type": "Sample", "inputs": {}},
          "a": {"class_type": "After", "inputs": {"latent": ["s", 0]}}}
    with pytest.raises(pprogress.Interrupted):  # unwrapped, not a WorkflowError
        phost.run_workflow(wf, {"Sample": Sample, "After": After}, device="cpu")
    assert not ran


def test_a_scope_shadows_the_slots_on_its_thread_only(hooks):
    mine, other = [], []
    event = threading.Event()
    with pprogress.progress_scope(hook=lambda v, m: mine.append(v), interrupt_event=event,
                                  prompt_id="p1") as scope:
        assert pprogress.current_scope() is scope
        pprogress.report_progress(1, 2)
        t = threading.Thread(target=lambda: other.append(pprogress.current_scope()))
        t.start()
        t.join()
        event.set()
        with pytest.raises(pprogress.Interrupted):
            pprogress.report_progress(2, 2)
        with pprogress.progress_scope() as inner:
            assert inner.prompt_id == "p1"  # a nested scope keeps the prompt
    assert mine == [1, 2] and other == [None] and pprogress.current_scope() is None
    assert hooks["port"][0] == []  # the process-wide hook was shadowed


def test_sampler_prefs_supply_cfg_rescale_as_in_jax():
    prefs = {"cfg_rescale": 0.7}
    want = _run_jax("euler", 2, prefs=prefs)
    got = _run_port("euler", 2, prefs=prefs)
    np.testing.assert_allclose(got, want, **TOL)
    plain = _run_port("euler", 2)
    assert not np.allclose(got, plain, rtol=1e-4, atol=1e-4)  # the prefs took effect
    np.testing.assert_allclose(got, _run_port("euler", 2, cfg_rescale=0.7), rtol=0, atol=0)
    # An explicit caller value wins over the model's.
    np.testing.assert_allclose(_run_port("euler", 2, prefs=prefs, cfg_rescale=0.3),
                               _run_port("euler", 2, cfg_rescale=0.3), rtol=0, atol=0)


@pytest.mark.parametrize("channels", [4, 16, 3, 1])
def test_latent_preview_matches_jax(channels):
    lat = np.random.default_rng(channels).standard_normal((2, 5, 6, channels)).astype(np.float32)
    want = jpreview.latent_to_rgb(lat)
    got = ppreview.latent_to_rgb(torch.from_numpy(lat))
    assert got.shape == (5, 6, 3)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    video = np.stack([lat, lat * 0.5], axis=1)
    np.testing.assert_allclose(ppreview.latent_to_rgb(video), jpreview.latent_to_rgb(video),
                               rtol=1e-6, atol=1e-6)
    png = ppreview.preview_png(torch.from_numpy(lat), max_side=24)
    assert png == jpreview.preview_png(lat, max_side=24) and png[:8] == b"\x89PNG\r\n\x1a\n"
