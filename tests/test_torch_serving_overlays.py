"""The PyTorch port's serving lane overlays on the CPU: multi-cond CFG extras,
delegated ControlNet lanes and per-lane LoRA (``sampling/compiled.lane_step_program``'s
``n_extra`` / ``control_apply`` / ``lora_sig``, ``serving/bucket.py``'s overlays and
the scheduler's capability eligibility), mirroring the JAX package's
``tests/test_serving_caps.py``; ``factorize_bake``'s exact test and the stock
``LoraLoader``'s lane delegate. Each served lane of a mixed bucket against the JAX
package's inline ``run_sampler``: ``tests/test_torch_serving_overlays_jax.py``,
which shares this file's fixtures.

The tiny SD1.5-like UNet of ``tests/test_torch_serving.py`` (numpy weights from a
seed for the JAX module's abstract tree, carried to the port by ``convert_jax``)
and a ControlNet of the same config, every weight random (a zero convolution would
make the net a no-op). Lanes run in float32 against the port's own inline sampler
at ``_close``'s 2e-4 of the latent's scale (the LoRA lane adds ``x·aᵀ·bᵀ`` where
inline merges ``W + b·a``), and bitwise where the same program runs the same lane.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401
from test_torch_quick_jax import quick_jax_compiles  # noqa: E402,F401
from test_torch_serving import (  # noqa: E402,F401
    CFG,
    CTX,
    LATENT,
    UNET,
    _bg,
    _close,
    _hermetic,
    _join,
    _np,
    _tree,
    _wait_enqueued,
    sched,
    unet_pair,
)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from comfyui_parallelanything_tpu.models import controlnet as jcn  # noqa: E402
from comfyui_parallelanything_tpu.models import unet as ju  # noqa: E402
from comfyui_parallelanything_tpu_torch.models import controlnet as pcn  # noqa: E402
from comfyui_parallelanything_tpu_torch.models import unet as pu  # noqa: E402
from comfyui_parallelanything_tpu_torch.models.convert_jax import (  # noqa: E402
    from_jax_unet_params,
)
from comfyui_parallelanything_tpu_torch.models.lora import combine_factors  # noqa: E402
from comfyui_parallelanything_tpu_torch.sampling.runner import run_sampler  # noqa: E402
from comfyui_parallelanything_tpu_torch.serving import ContinuousBatchingScheduler  # noqa: E402
from comfyui_parallelanything_tpu_torch.utils.metrics import registry  # noqa: E402

HINT = (1, 64, 64, 3)
# Port LoRA targets: 2-D attention and feed-forward projections (and a
# convolution), each a (path, seed) of its factors.
LORA_TARGETS = ("in_0_0_attn.blocks.0.attn1_q.weight", "in_0_0_attn.blocks.0.attn2_v.weight",
                "out_0_1_attn.blocks.0.ff_in.weight")
CONV_TARGET = "in_0_0_res.Conv_0.weight"


@functools.cache
def _controlnet_tree():
    jcfg = ju.UNetConfig(**UNET, dtype=jnp.float32)
    abstract = jax.eval_shape(
        jcn.ControlNet2D(jcfg).init, jax.random.key(0), jnp.zeros(LATENT),
        jnp.zeros(HINT), jnp.ones((1,)), jnp.zeros(CTX))["params"]
    return _tree(abstract, 7)


@pytest.fixture(scope="module")
def nets():
    tree = _controlnet_tree()
    jnet = jcn.build_controlnet(ju.UNetConfig(**UNET, dtype=jnp.float32),
                                params=jax.tree.map(jnp.asarray, tree))
    pnet = pcn.build_controlnet(pu.UNetConfig(**UNET, dtype=torch.float32), device="cpu",
                                state_dict=from_jax_unet_params(tree))
    return jnet, pnet


def _factors(pm, paths, rank, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    params = dict(pm.module.named_parameters())
    out = {}
    for p in paths:
        w = params[p]
        k = int(w[0].numel())
        out[p] = (torch.from_numpy((rng.normal(size=(rank, k)) * scale).astype(np.float32)),
                  torch.from_numpy((rng.normal(size=(w.shape[0], rank)) * scale)
                                   .astype(np.float32)))
    return out


def _jax_factors(factors):
    """The port's ``(a, b)`` on a torch ``(out, in)`` weight is the JAX pair
    ``(b.T, a.T)`` on the flax kernel, at the flax path."""
    out = {}
    for p, (a, b) in factors.items():
        jp = p.replace(".blocks.", ".block_").replace(".", "/").replace("/weight", "/kernel")
        out[jp] = (jnp.asarray(b.numpy().T), jnp.asarray(a.numpy().T))
    return out


@pytest.fixture(scope="module")
def kit(unet_pair, nets):
    """One coherent capability kit: an img2img mask, a ControlNet composition, two
    LoRA factor maps (one stacking two LoRAs), an extra cond."""
    _, pm = unet_pair
    r = np.random.default_rng(99)
    init = torch.from_numpy(_np(90, LATENT))
    mask = torch.from_numpy((r.random(size=(1, 8, 8, 1)) > 0.5).astype(np.float32))
    hint = r.random(size=HINT).astype(np.float32)
    composed = pcn.apply_control(pm, nets[1], hint, strength=0.7)
    lora1 = _factors(pm, LORA_TARGETS, 2, 11)
    lora2 = combine_factors([lora1, _factors(pm, LORA_TARGETS[:1] + (CONV_TARGET,), 1, 12)])
    ctx2 = torch.from_numpy(_np(91, CTX))
    return dict(pm=pm, init=init, mask=mask, hint=hint, composed=composed, lora1=lora1,
                lora2=lora2, ctx2=ctx2)


def _inputs(seed):
    return torch.from_numpy(_np(seed, LATENT)), torch.from_numpy(_np(seed + 100, CTX))


def _run(model, seed, kw):
    x, c = _inputs(seed)
    return run_sampler(model, x, c, **kw)


def _served(s, plans):
    """plans {name: (model, seed, kwargs)} submitted together, all seated before the
    first dispatch, drained; results by name."""
    jobs = {k: _bg(lambda m=m, seed=seed, kw=kw: _run(m, seed, kw))
            for k, (m, seed, kw) in plans.items()}
    _wait_enqueued(s, len(plans))
    s.drain()
    return dict(zip(jobs, _join(list(jobs.values()))))


def _inline(s, plans):
    s.uninstall()
    try:
        return {k: _run(m, seed, kw) for k, (m, seed, kw) in plans.items()}
    finally:
        s.install()


def _metric_sum(name, **match):
    want = {f'{k}="{v}"' for k, v in match.items()}
    total = 0.0
    for line in registry.render().splitlines():
        if line.startswith(name + "{") and all(w in line for w in want):
            total += float(line.rsplit(" ", 1)[1])
    return total


def _uncond():
    return torch.from_numpy(_np(5, CTX))


def test_mixed_capability_bucket_matches_solo(kit, sched):
    """A masked lane, a ControlNet lane, a two-LoRA lane and a plain lane share ONE
    bucket; dispatches are the longest lane's evals; each lane matches its inline
    run; each capability ticks its seat counter and nothing falls back inline."""
    pm = kit["pm"]
    cfg = dict(cfg_scale=CFG, uncond_context=_uncond())
    plans = {
        "masked": (pm, 1, dict(sampler="euler", steps=4, init_latent=kit["init"],
                               denoise=0.8, latent_mask=kit["mask"], **cfg)),
        "control": (kit["composed"], 2, dict(sampler="euler", steps=6, **cfg)),
        "lora2": (pm, 3, dict(sampler="euler", steps=8, lora=kit["lora2"], **cfg)),
        "plain": (pm, 4, dict(sampler="euler", steps=5, **cfg)),
    }
    inline = _inline(sched, plans)
    caps = {k: _metric_sum("pa_serving_lane_capability_total", kind=k)
            for k in ("img2img_mask", "controlnet", "lora", "txt2img")}
    fallbacks = _metric_sum("pa_serving_inline_fallback_total")
    served = _served(sched, plans)
    [bucket] = sched.buckets.values()
    assert bucket.width == 4 and sched.total_dispatches() == 8
    for k in plans:
        _close(served[k], inline[k])
    for k, before in caps.items():
        assert _metric_sum("pa_serving_lane_capability_total", kind=k) == before + 1, k
    assert _metric_sum("pa_serving_inline_fallback_total") == fallbacks


@pytest.mark.parametrize("prediction", ["eps", "flow"])
@pytest.mark.parametrize("cap", ["multi_cond", "control", "lora"])
def test_capability_lane_matches_solo(kit, sched, cap, prediction):
    """Each capability beside a ragged partner (another sampler, another step
    count) in one bucket, against its inline run."""
    pm = kit["pm"]
    cfg = dict(cfg_scale=3.0, uncond_context=_uncond(), prediction=prediction)
    model, kw = {
        "multi_cond": (pm, dict(sampler="euler", steps=5, extra_conds=(
            {"context": kit["ctx2"], "strength": 0.7, "area": (4, 8, 0, 0),
             "timestep_range": (0.0, 0.6)},), cond_strength=0.9, **cfg)),
        "control": (kit["composed"], dict(sampler="euler", steps=6, **cfg)),
        "lora": (pm, dict(sampler="dpmpp_2m", steps=7, lora=kit["lora1"], **cfg)),
    }[cap]
    plans = {"cap": (model, 21, kw),
             "partner": (pm, 22, dict(sampler="heun", steps=3, **cfg))}
    inline = _inline(sched, plans)
    served = _served(sched, plans)
    assert len(sched.buckets) == 1
    for k in plans:
        _close(served[k], inline[k])


def test_lora_and_masked_lanes_bitwise_across_occupancy(kit, sched):
    """A LoRA lane and a masked lane alone give the bits they give beside two more
    plain lanes: zero factor rows and gated-off mask rows change nothing."""
    pm = kit["pm"]
    pair = {
        "lora": (pm, 31, dict(sampler="euler_ancestral", steps=5, lora=kit["lora1"],
                              rng=torch.Generator().manual_seed(3))),
        "masked": (pm, 32, dict(sampler="euler", steps=5, init_latent=kit["init"],
                                denoise=0.8, latent_mask=kit["mask"])),
    }
    first = _served(sched, pair)
    pair["lora"][2]["rng"] = torch.Generator().manual_seed(3)
    full = _served(sched, dict(pair, p1=(pm, 33, dict(sampler="euler", steps=5)),
                               p2=(pm, 34, dict(sampler="euler", steps=4))))
    for k in pair:
        assert torch.equal(first[k], full[k]), k


def test_oom_on_a_mixed_bucket_reseats_its_capabilities(kit):
    """A dispatch OOM on a LoRA + ControlNet + masked bucket halves its width and
    re-seats the lanes from step 0 with their capability rows rebuilt from the
    requests: bitwise a clean run at the halved width."""
    from comfyui_parallelanything_tpu_torch.parallel.orchestrator import HOST_OOM_MESSAGE

    pm = kit["pm"]
    plans = {
        "lora": (pm, 41, dict(sampler="euler", steps=5, lora=kit["lora1"])),
        "control": (kit["composed"], 42, dict(sampler="euler", steps=4)),
    }
    clean = ContinuousBatchingScheduler(max_width=1, auto=False).install()
    try:
        want = {}
        for k, plan in plans.items():
            want.update(_served(clean, {k: plan}))
    finally:
        clean.shutdown()
    s = ContinuousBatchingScheduler(max_width=2, auto=False).install()
    try:
        jobs = {k: _bg(lambda m=m, seed=seed, kw=kw: _run(m, seed, kw))
                for k, (m, seed, kw) in plans.items()}
        _wait_enqueued(s, 2)
        [b] = s.buckets.values()
        real, state = b.dispatch, {"done": False}

        def boom():
            if not state["done"]:
                state["done"] = True
                raise RuntimeError(HOST_OOM_MESSAGE)
            return real()

        b.dispatch = boom
        s.drain()
        got = dict(zip(jobs, _join(list(jobs.values()))))
        assert {bk.width for bk in s.buckets.values()} == {1}
        for k in plans:
            assert torch.equal(got[k], want[k]), k
    finally:
        s.shutdown()


def test_conflicting_control_trunks_bounce_to_inline(kit, nets, sched):
    """One control trunk an epoch: a second ControlNet arriving at the bucket runs
    inline (and still gives its own result) instead of joining the seated lane."""
    pm = kit["pm"]
    other_net = pcn.build_controlnet(pu.UNetConfig(**UNET, dtype=torch.float32),
                                     device="cpu", generator=torch.Generator().manual_seed(8))
    other = pcn.apply_control(pm, other_net, kit["hint"] * 0.5, strength=0.3)
    plans = {"c1": (kit["composed"], 51, dict(sampler="euler", steps=5)),
             "c2": (other, 52, dict(sampler="euler", steps=5))}
    inline = _inline(sched, plans)
    before = _metric_sum("pa_serving_ctrl_conflict_total")
    degraded = _metric_sum("pa_serving_inline_fallback_total", reason="degraded")
    served = _served(sched, plans)
    for k in plans:
        _close(served[k], inline[k])
    assert _metric_sum("pa_serving_ctrl_conflict_total") == before + 1
    assert _metric_sum("pa_serving_inline_fallback_total", reason="degraded") == degraded + 1


def test_ineligible_extras_fall_back_inline_with_the_counter(kit, sched):
    """An extra cond of another sequence length cannot share the role blocks: the
    run completes inline, bitwise the unscheduled run, and ticks
    ``pa_serving_inline_fallback_total{reason="ineligible"}``."""
    pm = kit["pm"]
    bad = ({"context": torch.zeros((1, CTX[1] + 4, CTX[2])), "strength": 0.5},)
    before = _metric_sum("pa_serving_inline_fallback_total", reason="ineligible")
    got = _run(pm, 61, dict(sampler="euler", steps=3, extra_conds=bad))
    assert _metric_sum("pa_serving_inline_fallback_total", reason="ineligible") == before + 1
    assert not sched.buckets
    sched.uninstall()
    want = _run(pm, 61, dict(sampler="euler", steps=3, extra_conds=bad))
    assert torch.equal(got, want)


def test_a_bf16_bake_keeps_the_exact_test_as_jax():
    """``factorize_bake`` keeps the JAX function's exact test. A bake rounded to bf16
    (the full-size SD1.5 checkpoint's dtype) carries its rounding at full rank, above
    ``max_rank``: no factors, as JAX's, so its prompts run inline. A float32 bake of a
    rank-4 delta plus one weak real component, planted at a tenth of the spectral size
    a bf16 bake's rounding would have, recovers all five ranks, the weak one too, as
    JAX's does. A changed bias is not representable."""
    from comfyui_parallelanything_tpu.models import lora as jlora
    from comfyui_parallelanything_tpu_torch.models.lora import factorize_bake

    rng = np.random.default_rng(0)
    w0, w1 = {}, {}
    for i, (m, k) in enumerate([(96, 80), (80, 128), (160, 72)]):
        w = (rng.standard_normal((m, k)) * 0.05).astype(np.float32)
        rms = float(np.sqrt((w ** 2).mean()))
        strong = (rng.standard_normal((m, 4)) * 0.05 * rms / 2) @ rng.standard_normal((4, k))
        u, v = rng.standard_normal(m), rng.standard_normal(k)
        noise = 2.0 ** -7 * rms * (m ** 0.5 + k ** 0.5)
        weak = 0.1 * noise * np.outer(u / np.linalg.norm(u), v / np.linalg.norm(v))
        w0[f"l{i}"], w1[f"l{i}"] = w, (w + strong + weak).astype(np.float32)
    for dtype, jdtype, want in ((torch.bfloat16, jnp.bfloat16, None),
                                (torch.float32, jnp.float32, 5)):
        base = {f"{p}.weight": torch.from_numpy(x).to(dtype) for p, x in w0.items()}
        baked = {f"{p}.weight": torch.from_numpy(x).to(dtype) for p, x in w1.items()}
        got = factorize_bake(base, baked)
        jgot = jlora.factorize_bake({p: jnp.asarray(x, jdtype) for p, x in w0.items()},
                                    {p: jnp.asarray(x, jdtype) for p, x in w1.items()})
        if want is None:
            assert got is None and jgot is None
            continue
        assert {p: a.shape[0] for p, (a, _b) in got.items()} == {f"l{i}.weight": want
                                                                for i in range(3)}
        assert {p: np.asarray(a).shape[0] for p, (a, _b) in jgot.items()} == {
            f"l{i}": want for i in range(3)}
        for p, (a, b) in got.items():
            torch.testing.assert_close(b @ a, baked[p] - base[p], rtol=1e-4, atol=1e-6)
    assert factorize_bake({"b": torch.zeros(3)}, {"b": torch.ones(3)}) is None


def test_the_lora_loader_delegate_recovers_the_bake(kit):
    """``LoraLoader._lane_delegate``: the base and the factors of a bake against it;
    None when the bake is not low rank."""
    from comfyui_parallelanything_tpu_torch.models.lora import lora_model
    from comfyui_parallelanything_tpu_torch.nodes_compat import LoraLoader

    pm = kit["pm"]
    baked = lora_model(pm, kit["lora1"])
    delegate = LoraLoader._lane_delegate(pm, baked)
    assert delegate["base"] is pm and set(delegate["factors"]) == set(kit["lora1"])
    for p, (a, b) in delegate["factors"].items():
        a0, b0 = kit["lora1"][p]
        torch.testing.assert_close(b @ a, b0 @ a0, rtol=1e-4, atol=1e-6)
    bias = "in_0_0_attn.blocks.0.attn1_o.bias"  # a changed bias has no factors
    w = dict(pm.module.named_parameters())[bias]
    biased = lora_model(pm, {bias: (torch.ones(1, 1), torch.full((w.shape[0], 1), 0.1))})
    assert LoraLoader._lane_delegate(pm, biased) is None
