"""Parity of the PyTorch port's whole-loop compiled sampler (``sampling/compiled.py``
through ``run_sampler(compile_loop=True)``) against the JAX package's on the CPU.

Both sides drive the toy model of ``tests/test_compiled.py`` (written once in
``jax.numpy`` there and once in torch here) from the same inputs, 5 steps, at that
file's tolerance (rtol 2e-4, atol 2e-5). On CPU tensors the port's compiled entry
points run the eager sampler body uncaptured, so they must also equal the port's
eager loop exactly. The stochastic samplers' draws: the JAX compiled loop takes
``fold_in(fold_in(key(7), 1), i)`` per step (split in two for ``dpmpp_sde``); the
port's table is filled from ``k_samplers.step_noise``, patched here with those JAX
draws. The keys use JAX's ``rbg`` implementation, which XLA compiles several times
faster than threefry on the CPU; the compiled programs are otherwise the JAX
package's own.

The eps- and v-prediction runs hand both sides the JAX package's alpha-bar table
(``alphas_cumprod``, the runner's schedule input) as the same numpy array. Each
package builds ``scaled_linear_schedule`` in f32 with its own linspace formula and
cumulative-product order, and the tables differ by up to 1.4e-6 relatively; the
toy model's ``cos(t)`` at t ≈ 800 turns the few-ulp timestep difference into about
2e-5 of the result, above the atol where an element is near 0. The schedules' own
parity is ``tests/test_torch_samplers.py``'s.
"""

import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_quick_jax import quick_jax_compiles  # noqa: E402,F401
from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from comfyui_parallelanything_tpu import DeviceChain as JaxChain  # noqa: E402
from comfyui_parallelanything_tpu import parallelize as jax_parallelize  # noqa: E402
from comfyui_parallelanything_tpu.sampling import schedules as jax_schedules  # noqa: E402
from comfyui_parallelanything_tpu.sampling.runner import (  # noqa: E402
    run_sampler as jax_run_sampler,
)
from comfyui_parallelanything_tpu_torch import DeviceChain, parallelize  # noqa: E402
from comfyui_parallelanything_tpu_torch.parallel import chain as chain_mod  # noqa: E402
from comfyui_parallelanything_tpu_torch.sampling import compiled  # noqa: E402
from comfyui_parallelanything_tpu_torch.sampling import k_samplers as pk  # noqa: E402
from comfyui_parallelanything_tpu_torch.sampling.runner import run_sampler  # noqa: E402

from test_compiled import ALL_SAMPLERS, SHAPE, _ctx, _noise, _toy_model  # noqa: E402
from test_torch_unet import TOL as UNET_TOL  # noqa: E402
from test_torch_unet import _inputs as _unet_inputs  # noqa: E402
from test_torch_unet import _pair as _unet_pair  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-5)
ACP = np.array(jax_schedules.scaled_linear_schedule())
RUNNER_LOG = "comfyui_parallelanything_tpu_torch.sampling.runner"


def ptoy(x, t, context=None, **kwargs):
    """``tests/test_compiled.py``'s ``_toy_model`` in torch."""
    h = 0.12 * x * torch.cos(t)[:, None, None, None]
    if context is not None:
        h = h + 0.01 * context.sum(dim=(1, 2))[:, None, None, None]
    if kwargs.get("y") is not None:
        h = h + 0.001 * kwargs["y"][:, None, None, :]
    return h


class Toy(torch.nn.Module):
    """The toy as a module with one weight ``a`` (the chain cases' model)."""

    def __init__(self, a=0.12):
        super().__init__()
        self.a = torch.nn.Parameter(torch.tensor(a))

    def forward(self, x, t, context=None, **kwargs):
        h = x * self.a * torch.cos(t)[:, None, None, None]
        if context is not None:
            h = h + 0.01 * context.sum(dim=(1, 2))[:, None, None, None]
        return h


def jax_toy(params, x, t, context=None, **kwargs):
    h = x * params["a"] * jnp.cos(t)[:, None, None, None]
    if context is not None:
        h = h + 0.01 * context.sum(axis=(1, 2))[:, None, None, None]
    return h


@pytest.fixture(scope="module", autouse=True)
def _rbg_keys():
    before = jax.config.jax_default_prng_impl
    jax.config.update("jax_default_prng_impl", "rbg")
    yield
    jax.config.update("jax_default_prng_impl", before)


@pytest.fixture(autouse=True)
def jax_noise(monkeypatch):
    """``step_noise`` patched with the JAX compiled loop's draws; set ``split`` for
    ``dpmpp_sde``."""
    state = {"split": False}
    base = jax.random.fold_in(jax.random.key(7), 1)

    def patched(rng, i, shape, like, part=0):
        key = jax.random.fold_in(base, i)
        if state["split"]:
            key = jax.random.split(key)[part]
        draw = np.array(jax.random.normal(key, tuple(shape), jnp.float32))
        return torch.from_numpy(draw).to(like.device, like.dtype)

    monkeypatch.setattr(pk, "step_noise", patched)
    yield state
    compiled.clear_compiled_loops()


def _each(v, to):
    if isinstance(v, np.ndarray):
        return to(v)
    if isinstance(v, dict):
        return {k: _each(x, to) for k, x in v.items()}
    return v


def _compare(sampler, port_model=ptoy, jax_model=None, noise=None, ctx=None, steps=5,
             tol=TOL, **kw):
    """Both packages' ``compile_loop=True`` on the same numpy inputs (numpy values in
    ``kw``, also inside dicts, go to each side as its own array); returns the port's
    result and its inputs."""
    noise = np.array(_noise()) if noise is None else noise
    ctx = np.array(_ctx()) if ctx is None else ctx
    if sampler != "flow_euler" and kw.get("prediction") != "flow":
        kw["alphas_cumprod"] = ACP
    want = jax_run_sampler(jax_model or _toy_model(), jnp.asarray(noise), jnp.asarray(ctx),
                           sampler=sampler, steps=steps, rng=jax.random.key(7),
                           compile_loop=True, **_each(kw, jnp.asarray))
    pkw = dict(sampler=sampler, steps=steps, **_each(kw, torch.from_numpy))
    got = run_sampler(port_model, torch.from_numpy(noise), torch.from_numpy(ctx),
                      compile_loop=True, **pkw)
    assert got.shape == noise.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    return got, (port_model, torch.from_numpy(noise), torch.from_numpy(ctx), pkw)


@pytest.mark.parametrize("sampler", ALL_SAMPLERS)
def test_every_sampler_matches_jax_and_the_eager_loop(sampler, jax_noise):
    jax_noise["split"] = sampler == "dpmpp_sde"
    got, (model, noise, ctx, pkw) = _compare(sampler)
    np.testing.assert_array_equal(got.numpy(), run_sampler(model, noise, ctx, **pkw).numpy())


@pytest.mark.parametrize("sampler", ["euler", "ddim", "flow_euler"])
def test_cfg_rescale_and_a_batch_kwarg_doubled_through_cfg(sampler):
    y = np.linspace(0.0, 1.0, SHAPE[0] * 4, dtype=np.float32).reshape(SHAPE[0], 4)
    _compare(sampler, cfg_scale=4.0, uncond_context=np.array(_ctx(seed=9)), cfg_rescale=0.3,
             uncond_kwargs={"y": -y}, y=y)


def _mask():
    mask = np.zeros((1, 8, 8, 1), np.float32)
    mask[:, :4] = 1.0
    return mask


@pytest.mark.parametrize("sampler", ["euler_ancestral", "ddim", "flow_euler"])
def test_img2img_with_a_mask(sampler):
    _compare(sampler, init_latent=np.full(SHAPE, 0.5, np.float32), denoise=0.6,
             latent_mask=_mask())


@pytest.mark.parametrize("sampler", ["dpmpp_2s_ancestral", "uni_pc"])
def test_flow_prediction_with_a_mask(sampler):
    _compare(sampler, prediction="flow", shift=1.2, init_latent=np.full(SHAPE, 0.5, np.float32),
             latent_mask=_mask())


def test_v_prediction_and_scheduler():
    _compare("dpmpp_2m", prediction="v", scheduler="sgm_uniform")


def test_chain_pads_batch_3_over_two_replicas_as_the_jax_mesh():
    noise = np.array(jax.random.normal(jax.random.key(1), (3, 8, 8, 4)))
    ctx = np.array(jax.random.normal(jax.random.key(3), (3, 6, 16)))
    uncond = np.array(jax.random.normal(jax.random.key(9), (3, 6, 16)))
    pm = parallelize(Toy(), DeviceChain.even(["cpu:0", "cpu:1"]))
    jm = jax_parallelize((jax_toy, {"a": jnp.float32(0.12)}), JaxChain.even(["cpu:0", "cpu:1"]))
    got, _ = _compare("dpmpp_2m", port_model=pm, jax_model=jm, noise=noise, ctx=ctx, steps=4,
                      cfg_scale=3.0, uncond_context=uncond)
    assert [(r["replays"], r["device"]) for r in compiled.loop_records()] == [(1, "cpu")] * 2


def test_stochastic_noise_table_shards_with_the_batch():
    # Port only: each replica reads its rows of every step's draw, so the padded
    # two-replica loop equals the eager loop over the whole batch.
    torch.manual_seed(0)
    noise, ctx = torch.randn(3, 8, 8, 4), torch.randn(3, 6, 16)
    pm = parallelize(Toy(), DeviceChain.even(["cpu:0", "cpu:1"]))
    kw = dict(sampler="dpmpp_sde", steps=3, cfg_scale=2.0, uncond_context=-ctx)
    eager = run_sampler(pm, noise, ctx, **kw)
    np.testing.assert_array_equal(run_sampler(pm, noise, ctx, compile_loop=True, **kw).numpy(),
                                  eager.numpy())


def test_tiny_unet_through_parallelize():
    # At the UNet forward's own parity tolerance (tests/test_torch_unet.py): the
    # loop cannot agree more closely than the model it calls.
    jm, pm_unet, _ = _unet_pair("sd15_like")
    x, _, ctx, _ = _unet_inputs(3, jm.config, batch=1)
    _, _, uncond, _ = _unet_inputs(4, jm.config, batch=1)
    _compare("dpmpp_2m", port_model=parallelize(pm_unet, [("cpu", 100)]),
             jax_model=jax_parallelize(jm, [("cpu", 100)]), noise=x, ctx=ctx, steps=3,
             tol=UNET_TOL, cfg_scale=7.0, uncond_context=uncond)


def test_eager_cases_are_logged(caplog, monkeypatch):
    caplog.set_level(logging.INFO, logger=RUNNER_LOG)
    noise, ctx = torch.from_numpy(np.array(_noise())), torch.from_numpy(np.array(_ctx()))
    seen = []
    out = run_sampler(ptoy, noise, ctx, sampler="euler", steps=5, compile_loop=True,
                      callback=lambda i, x: seen.append(i))
    assert seen == [0, 1, 2, 3, 4] and torch.isfinite(out).all()
    run_sampler(ptoy, noise, ctx, sampler="euler", steps=2, compile_loop=True,
                extra_conds=[{"context": ctx, "strength": 0.5}])
    monkeypatch.setattr(chain_mod, "get_device", lambda s: torch.device("cpu"))
    hybrid = parallelize(Toy(), [("cuda:0", 50), ("cpu", 50)])
    assert hybrid.traceable() is None
    np.testing.assert_array_equal(
        run_sampler(hybrid, noise, ctx, sampler="euler", steps=2, compile_loop=True).numpy(),
        run_sampler(hybrid, noise, ctx, sampler="euler", steps=2).numpy())
    text = caplog.text
    assert "user callback" in text and "multi-cond" in text and "heterogeneous chain" in text
    assert compiled.loop_records() == []  # every case ran the eager loop


def test_second_call_reuses_the_loop_and_cleanup_drops_it():
    noise, ctx = torch.from_numpy(np.array(_noise())), torch.from_numpy(np.array(_ctx()))
    pm = parallelize(Toy(), [("cpu", 100)])
    first = run_sampler(pm, noise, ctx, sampler="euler", steps=3, compile_loop=True)
    again = run_sampler(pm, noise, ctx, sampler="euler", steps=3, compile_loop=True)
    np.testing.assert_array_equal(first.numpy(), again.numpy())
    assert [(r["sampler"], r["replays"]) for r in compiled.loop_records()] == [("euler", 2)]
    run_sampler(pm, noise, ctx, sampler="euler", steps=4, compile_loop=True)  # a new schedule
    assert len(compiled.loop_records()) == 2
    pm.cleanup()
    assert compiled.loop_records() == []
