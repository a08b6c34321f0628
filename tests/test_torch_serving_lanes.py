"""The PyTorch port's continuous-batching serving on the CPU, held to itself: a tiny
SD1.5-like UNet of the port's own (random weights from a torch generator, no JAX
reference) through the scheduler with ``auto=False`` and ``pump()``: a
denoise-masked lane; shared-cond against stacked rows (bitwise); cancel; the policy
(priority, FIFO, depth, deadlines); ineligible work inline with the fallback
counter; the OOM ladder; an uninstalled scheduler and a ``compile_loop`` run beside
an installed one; the decode queue against the inline decode; and sixteen
submitting threads against the dispatcher thread. The parity cases against the JAX
scheduler are ``tests/test_torch_serving.py``'s, whose helpers this file shares.
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401
from test_torch_serving import (  # noqa: E402,F401
    CFG,
    LATENT,
    UNET,
    _bg,
    _close,
    _counter,
    _hermetic,
    _join,
    _np,
    _wait_enqueued,
    port_unet_run,
    sched,
    serve,
    unet_request,
)

from comfyui_parallelanything_tpu_torch.models import unet as pu  # noqa: E402
from comfyui_parallelanything_tpu_torch.parallel.orchestrator import (  # noqa: E402
    HOST_OOM_MESSAGE,
)
from comfyui_parallelanything_tpu_torch.sampling import lane_specs as pls  # noqa: E402
from comfyui_parallelanything_tpu_torch.sampling.k_samplers import make_sigmas  # noqa: E402
from comfyui_parallelanything_tpu_torch.sampling.runner import run_sampler  # noqa: E402
from comfyui_parallelanything_tpu_torch.serving import (  # noqa: E402
    AdmissionQueue,
    ContinuousBatchingScheduler,
    DeadlineExceeded,
    DecodeQueue,
    ServingRejected,
    get_scheduler,
    serving_hints,
)
from comfyui_parallelanything_tpu_torch.utils.metrics import registry  # noqa: E402
from comfyui_parallelanything_tpu_torch.utils.progress import (  # noqa: E402
    Interrupted,
    progress_scope,
)


@pytest.fixture(scope="module")
def unet():
    return pu.build_unet(pu.UNetConfig(**UNET, dtype=torch.float32), device="cpu",
                         generator=torch.Generator().manual_seed(3))


def test_denoise_masked_lane_beside_a_plain_lane(unet, sched):
    pm = unet
    masked = unet_request(50, "dpmpp_2m", 4)
    init = torch.from_numpy(_np(51, LATENT))
    mask = torch.zeros(LATENT)
    mask[:, 2:6, 1:7] = 1.0
    extra = dict(init_latent=init, denoise=0.75, latent_mask=mask)
    plain = unet_request(52, "euler", 3)
    got, other = serve(sched, [lambda: port_unet_run(pm, masked, **extra),
                               lambda: port_unet_run(pm, plain)])
    [bucket] = sched.buckets.values()
    sched.uninstall()
    _close(got, port_unet_run(pm, masked, **extra))
    _close(other, port_unet_run(pm, plain))
    # The keep region is the init, noised to the end of the truncated schedule (σ=0).
    assert torch.equal(got[mask == 0], init[mask == 0])
    assert bucket.dispatch_count == 4  # max(4, 3) steps


def test_shared_cond_equals_stacked_rows_bitwise(unet, sched):
    pm = unet
    base = unet_request(60, "euler", 3)
    ctx, unc = torch.from_numpy(base["ctx"]), torch.from_numpy(base["unc"])

    def run(seed, c, u):
        return run_sampler(pm, torch.from_numpy(_np(seed, LATENT)), c, sampler="euler",
                           steps=3, cfg_scale=CFG, uncond_context=u)

    before = _counter("pa_serving_shared_cond_seats_total")
    shared = serve(sched, [lambda s=s: run(s, ctx, unc) for s in (61, 62)])
    assert _counter("pa_serving_shared_cond_seats_total") == before + 1
    assert next(iter(sched.buckets.values()))._cond_mode is None  # released when idle
    stacked = serve(sched, [lambda s=s: run(s, ctx.clone(), unc.clone()) for s in (61, 62)])
    assert _counter("pa_serving_shared_cond_seats_total") == before + 1
    sched.uninstall()
    for a, b in zip(shared, stacked):
        assert torch.equal(a, b)


def test_cancel_frees_a_lane_and_leaves_its_neighbours_bitwise(unet, sched):
    pm = unet
    reqs = [unet_request(70 + i, s, 4) for i, s in enumerate(("euler", "dpmpp_2m", "heun"))]
    want = serve(sched, [lambda r=r: port_unet_run(pm, r) for r in (reqs[0], reqs[2])])
    cancel = threading.Event()

    def cancelled():
        with progress_scope(interrupt_event=cancel):
            return port_unet_run(pm, reqs[1])

    jobs = [_bg(lambda: port_unet_run(pm, reqs[0])), _bg(cancelled),
            _bg(lambda: port_unet_run(pm, reqs[2]))]
    _wait_enqueued(sched, 3)
    sched.pump()
    cancel.set()
    sched.drain()
    sched.uninstall()
    assert isinstance(jobs[1][1].get("err"), Interrupted)
    got = _join([jobs[0], jobs[2]])
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_priority_fifo_depth_and_deadlines(unet, sched):
    q = AdmissionQueue(max_waiting=3)

    class R:
        def __init__(self, rid, priority=0, deadline=None):
            self.rid, self.priority, self.deadline = rid, priority, deadline

    q.push(R("a"))
    q.push(R("b", priority=2))
    q.push(R("c"))
    with pytest.raises(ServingRejected):
        q.push(R("d"))
    assert [q.pop().rid for _ in range(3)] == ["b", "a", "c"] and q.pop() is None
    q.push(R("late", deadline=time.monotonic() - 1))
    q.push(R("ok", deadline=time.monotonic() + 60))
    assert [r.rid for r in q.expired()] == ["late"] and q.pop().rid == "ok"

    pm = unet
    r = unet_request(80, "euler", 2)
    def expired():
        with serving_hints(priority=1, deadline_s=0.0):  # per submitting thread
            return port_unet_run(pm, r)

    t, box = _bg(expired)
    _wait_enqueued(sched, 1)
    sched.pump()
    t.join(30)
    assert isinstance(box.get("err"), DeadlineExceeded) and not sched.total_dispatches()
    # A full scheduler queue sends the run inline (and counts it).
    small = ContinuousBatchingScheduler(max_width=1, max_waiting=1, auto=False).install()
    try:
        first = _bg(lambda: port_unet_run(pm, r))
        _wait_enqueued(small, 1)
        before = registry.get("pa_serving_inline_fallback_total",
                              {"reason": "ineligible", "sampler": "euler"}) or 0.0
        inline = port_unet_run(pm, r)  # refused: runs inline on this thread
        assert registry.get("pa_serving_inline_fallback_total",
                            {"reason": "ineligible", "sampler": "euler"}) == before + 1
        small.drain()
        _close(_join([first])[0], inline)
    finally:
        small.shutdown()
    sched.uninstall()


def _fallbacks(reason, sampler="euler"):
    return registry.get("pa_serving_inline_fallback_total",
                        {"reason": reason, "sampler": sampler}) or 0.0


def test_ineligible_work_runs_inline_and_ticks_the_fallback_counter(unet, sched):
    from comfyui_parallelanything_tpu_torch.models.controlnet import (
        apply_control,
        build_controlnet,
    )

    pm = unet
    r = unet_request(100, "euler", 2)
    x, c, u = (torch.from_numpy(r[k]) for k in ("noise", "ctx", "unc"))
    kw = dict(sampler="euler", steps=2, cfg_scale=CFG, uncond_context=u)
    before = _fallbacks("ineligible")
    # What the JAX scheduler also keeps inline: a latent callback, an extra cond of
    # another sequence length, a LoRA whose signature misses the served module, and a
    # chained ControlNet composition.
    run_sampler(pm, x, c, callback=lambda i, z: None, **kw)
    other_l = torch.zeros((1, c.shape[1] + 3, c.shape[2]))
    run_sampler(pm, x, c, extra_conds=[{"context": other_l, "strength": 0.5}], **kw)
    # A factor pair on a bias: the inline merge takes it, the lanes' signature
    # (2-D targets) does not.
    name = next(n for n, p in pm.module.named_parameters() if n.endswith(".bias"))
    w = dict(pm.module.named_parameters())[name]
    lora = {name: (torch.zeros(2, 1), torch.zeros(w.shape[0], 2))}
    run_sampler(pm, x, c, lora=lora, **kw)
    net = build_controlnet(pu.UNetConfig(**UNET, dtype=torch.float32), device="cpu",
                           generator=torch.Generator().manual_seed(6))
    chained = apply_control(apply_control(pm, net, torch.zeros(1, 64, 64, 3), 0.5),
                            net, torch.zeros(1, 64, 64, 3), 0.25)
    assert chained.control_delegate is None
    run_sampler(chained, x, c, **kw)
    assert _fallbacks("ineligible") == before + 4
    assert not sched.buckets  # nothing was queued
    sched.uninstall()


def test_oom_ladder_halves_the_width_then_runs_inline(unet):
    pm = unet
    calls = []

    class Tight(torch.nn.Module):
        """The UNet, but a call of more than ``rows`` rows runs out of host memory."""

        def __init__(self, rows):
            super().__init__()
            self.inner, self.rows = pm.module, rows

        def forward(self, x, t, context=None, **kw):
            calls.append(x.shape[0])
            if x.shape[0] > self.rows:
                raise RuntimeError(f"{HOST_OOM_MESSAGE} (test)")
            return self.inner(x, t, context, **kw)

    reqs = [unet_request(110 + i, "euler", 2) for i in range(2)]
    want = [port_unet_run(pm, r) for r in reqs]
    before = registry.get("pa_degradation_total", {"rung": "lane-width-halve"}) or 0.0
    s = ContinuousBatchingScheduler(max_width=4, auto=False).install()
    try:
        got = serve(s, [lambda r=r: port_unet_run(Tight(4), r) for r in reqs[:1]])
        assert calls[:2] == [8, 4]  # width 4 (CFG: 8 rows) refused, width 2 served
        assert registry.get("pa_degradation_total", {"rung": "lane-width-halve"}) == before + 1
        _close(got[0], want[0])
        tight = Tight(0)  # every call fails: width 4, 2, 1, then inline
        calls.clear()
        before_inline = _fallbacks("degraded")
        with pytest.raises(RuntimeError, match="allocate memory"):
            serve(s, [lambda: port_unet_run(tight, reqs[1])])  # inline fails the same way
        assert calls == [8, 4, 2, 2]
        assert _fallbacks("degraded") == before_inline + 1
    finally:
        s.shutdown()


def test_uninstalled_scheduler_is_inert_and_compile_loop_runs_inline(unet):
    pm = unet
    r = unet_request(120, "dpmpp_2m", 3)
    want = port_unet_run(pm, r)
    s = ContinuousBatchingScheduler(max_width=4, auto=False)
    try:
        assert get_scheduler() is None
        assert torch.equal(port_unet_run(pm, r), want) and not s.buckets
        s.install()
        # A captured-loop caller is never handed to the scheduler: its capture is
        # guarded against the dispatcher instead (sampling/compiled.py).
        assert torch.equal(port_unet_run(pm, r, compile_loop=True),
                           port_unet_run_inline_compiled(pm, r))
        assert not s.buckets
        s.uninstall()
        assert get_scheduler() is None and torch.equal(port_unet_run(pm, r), want)
    finally:
        s.shutdown()


def port_unet_run_inline_compiled(pm, r):
    s = get_scheduler()
    s.uninstall()
    try:
        return port_unet_run(pm, r, compile_loop=True)
    finally:
        s.install()


def test_decode_queue_equals_the_inline_decode():
    from comfyui_parallelanything_tpu_torch import nodes
    from comfyui_parallelanything_tpu_torch.models import VAEConfig, build_vae

    vae = build_vae(VAEConfig(z_channels=4, base_channels=32, channel_mult=(1, 2),
                              num_res_blocks=1, norm_groups=8, dtype=torch.float32),
                    device="cpu", generator=torch.Generator().manual_seed(0))
    zs = [torch.from_numpy(_np(130 + i, (1, 4, 4, 4))) for i in range(3)]
    want = [nodes.TPUVAEDecode().decode(vae, {"samples": z})[0] for z in zs]
    q = DecodeQueue(width=4, linger_s=60.0, auto=False).install()
    try:
        jobs = [_bg(lambda z=z: nodes.TPUVAEDecode().decode(vae, {"samples": z})[0])
                for z in zs]
        t0 = time.monotonic()
        while q.stats()["waiting"] < 3:
            assert time.monotonic() - t0 < 30
            time.sleep(0.002)
        q.drain()
        got = _join(jobs)
        assert q.dispatches == 1 and q.submit(vae, zs[0], tile=16) is None
    finally:
        q.shutdown()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-5)


def test_many_submitters_against_the_dispatcher_thread():
    """More submitting threads than cores against the auto dispatcher, with a short
    switch interval: every run equals its inline twin, and the lane-steps the buckets
    served are exactly the runs' evals (a lost update would break either)."""
    import sys

    def toy(x, t, c=None, **kw):
        return torch.tanh(0.5 * x + (t / 1000.0).view(-1, 1, 1, 1)
                          + c.mean(dim=(1, 2)).view(-1, 1, 1, 1))

    runs = [(150 + i, ("euler", "heun", "dpmpp_2m", "euler_ancestral")[i % 4], 2 + i % 3)
            for i in range(16)]

    def run(seed, sampler, steps):
        return run_sampler(toy, torch.from_numpy(_np(seed, (1, 4, 4, 2))),
                           torch.from_numpy(_np(seed + 1, (1, 3, 4))), sampler=sampler,
                           steps=steps, cfg_scale=3.0,
                           uncond_context=torch.from_numpy(_np(seed + 2, (1, 3, 4))),
                           rng=torch.Generator().manual_seed(seed))

    want = [run(*r) for r in runs]
    evals = sum(pls.lane_eval_count(sa, make_sigmas("karras", n).numpy())
                for _, sa, n in runs)
    before = _counter("pa_serving_lane_steps_total")
    interval = sys.getswitchinterval()
    s = ContinuousBatchingScheduler(max_width=4).install()
    try:
        sys.setswitchinterval(1e-5)
        jobs = [_bg(lambda r=r: run(*r)) for r in runs]
        got = _join(jobs)
        assert all(not t.is_alive() for t, _ in jobs)
    finally:
        sys.setswitchinterval(interval)
        s.shutdown()
    for g, w in zip(got, want):
        _close(g, w)
    assert _counter("pa_serving_lane_steps_total") - before == evals
