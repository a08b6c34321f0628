"""Parity of the PyTorch port's sampling stack (``schedules.py``, ``k_samplers.py``,
``ddim.py`` and the ddim / k-sampler branches of ``runner.py``) against the JAX
package on the CPU.

Both sides drive the same toy model, written once in ``jax.numpy`` and once in
torch (a smooth function of the latent, the timestep, the context and the pooled
``y``), from the same numpy inputs. The stochastic samplers draw their noise in
``k_samplers.step_noise`` on the port's side; the tests patch it with what
``jax.random.normal`` drew from the JAX package's keys (``fold_in(rng, i)``, split
in two for ``dpmpp_sde``), since torch's generators cannot reproduce them. Both
sides run in f32 and must agree to rtol/atol 2e-4; integer schedules (ddim
timesteps, schedule lengths) exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from comfyui_parallelanything_tpu.sampling import ddim as jddim  # noqa: E402
from comfyui_parallelanything_tpu.sampling import k_samplers as jk  # noqa: E402
from comfyui_parallelanything_tpu.sampling import schedules as jsched  # noqa: E402
from comfyui_parallelanything_tpu.sampling.runner import (  # noqa: E402
    run_sampler as jax_run_sampler,
)
from comfyui_parallelanything_tpu_torch.ops import basic as pbasic  # noqa: E402
from comfyui_parallelanything_tpu_torch.sampling import ddim as pddim  # noqa: E402
from comfyui_parallelanything_tpu_torch.sampling import k_samplers as pk  # noqa: E402
from comfyui_parallelanything_tpu_torch.sampling import runner as prunner  # noqa: E402
from comfyui_parallelanything_tpu_torch.sampling import schedules as psched  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
SHAPE = (2, 6, 5, 4)


def jmodel(x, t, c=None, y=None, **kw):
    h = 0.5 * x + (t / 1000.0)[:, None, None, None]
    if c is not None:
        h = h + c.mean(axis=(1, 2))[:, None, None, None]
    if y is not None:
        h = h + 0.3 * y.mean(axis=-1)[:, None, None, None]
    return jnp.tanh(h) + 0.1 * x


def pmodel(x, t, c=None, y=None, **kw):
    h = 0.5 * x + (t / 1000.0)[:, None, None, None]
    if c is not None:
        h = h + c.mean(dim=(1, 2))[:, None, None, None]
    if y is not None:
        h = h + 0.3 * y.mean(dim=-1)[:, None, None, None]
    return torch.tanh(h) + 0.1 * x


def _inputs(seed, batch=2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch,) + SHAPE[1:]).astype(np.float32)
    ctx = rng.normal(size=(batch, 3, 8)).astype(np.float32)
    unc = rng.normal(size=(batch, 3, 8)).astype(np.float32)
    y = rng.normal(size=(batch, 5)).astype(np.float32)
    uy = rng.normal(size=(batch, 5)).astype(np.float32)
    return x, ctx, unc, y, uy


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


@pytest.fixture
def jax_noise(monkeypatch):
    """Patch ``step_noise`` with JAX's draws: ``fold_in(base, i)``, or for
    ``split=True`` (dpmpp_sde) ``split(fold_in(base, i))[part]``. Set ``base``
    (a JAX key) and ``split`` on the returned dict; ``calls`` records (i, part)."""
    state = {"base": jax.random.key(0), "split": False, "calls": []}

    def patched(rng, i, shape, like, part=0):
        state["calls"].append((i, part))
        key = jax.random.fold_in(state["base"], i)
        if state["split"]:
            key = jax.random.split(key)[part]
        draw = np.asarray(jax.random.normal(key, tuple(shape), jnp.float32))
        return torch.from_numpy(draw).to(like.device, like.dtype)

    monkeypatch.setattr(pk, "step_noise", patched)
    return state


class TestSchedules:
    def test_scaled_linear_and_ddim_timesteps(self):
        _close(psched.scaled_linear_schedule(), jsched.scaled_linear_schedule())
        _close(psched.scaled_linear_schedule(500, 0.001, 0.02),
               jsched.scaled_linear_schedule(500, 0.001, 0.02))
        for n in (1, 7, 20, 50):
            np.testing.assert_array_equal(psched.ddim_timesteps(n).numpy(),
                                          np.asarray(jsched.ddim_timesteps(n)))
        assert psched.ddim_timesteps(20).dtype == torch.int32

    @pytest.mark.parametrize("name", jk.SCHEDULER_NAMES)
    def test_every_scheduler_matches_jax(self, name):
        assert pk.SCHEDULER_NAMES == jk.SCHEDULER_NAMES
        acp = jsched.scaled_linear_schedule(1000, 0.001, 0.015)
        for n in (1, 3, 12, 200):
            for kw in ({}, {"acp": True}, {"flow": 3.0}):
                jkw, pkw = {}, {}
                if kw.get("acp"):
                    jkw["alphas_cumprod"] = acp
                    pkw["alphas_cumprod"] = torch.from_numpy(np.array(acp))
                if "flow" in kw:
                    jkw["sigma_table"] = jk.flow_sigma_table(kw["flow"])
                    pkw["sigma_table"] = pk.flow_sigma_table(kw["flow"])
                want = np.asarray(jk.make_sigmas(name, n, **jkw))
                got = pk.make_sigmas(name, n, **pkw)
                assert got.dtype == torch.float32 and got.device.type == "cpu"
                assert got.shape == want.shape, (name, n, kw)
                _close(got, want)

    def test_tables_interp_and_unknown(self):
        acp = jsched.scaled_linear_schedule()
        _close(pk.model_sigmas(psched.scaled_linear_schedule()), jk.model_sigmas(acp))
        _close(pk.flow_sigma_table(1.15), jk.flow_sigma_table(1.15))
        xp = jnp.asarray([0.0, 1.0, 1.0, 2.5, 4.0])
        fp = jnp.asarray([3.0, -1.0, 2.0, 0.5, 7.0])
        x = np.asarray([-1.0, 0.0, 0.25, 1.0, 2.0, 4.0, 9.0], np.float32)
        _close(pk.interp(torch.from_numpy(x), torch.from_numpy(np.array(xp)),
                         torch.from_numpy(np.array(fp))), jnp.interp(x, xp, fp))
        with pytest.raises(ValueError, match="unknown scheduler"):
            pk.make_sigmas("nope", 4)


class TestEpsDenoiser:
    @pytest.mark.parametrize("prediction", ["eps", "v", "flow"])
    @pytest.mark.parametrize("cfg", [1.0, 3.5], ids=["no-cfg", "cfg"])
    def test_matches_jax(self, prediction, cfg):
        x, ctx, unc, y, uy = _inputs(1)
        extra = dict(cfg_scale=cfg, cfg_rescale=0.4 if cfg != 1.0 else 0.0,
                     prediction=prediction)
        jd = jk.EpsDenoiser(jmodel, jnp.asarray(ctx), uncond_context=jnp.asarray(unc),
                            uncond_kwargs={"y": jnp.asarray(uy)}, y=jnp.asarray(y), **extra)
        T = torch.from_numpy
        pd = pk.EpsDenoiser(pmodel, T(ctx), uncond_context=T(unc), uncond_kwargs={"y": T(uy)},
                            y=T(y), **extra)
        for sigma in (14.6, 3.0, 0.5, 0.03) if prediction != "flow" else (1.0, 0.6, 0.05):
            _close(pd(T(x), torch.tensor(sigma)), jd(jnp.asarray(x), jnp.float32(sigma)))
        _close(pd._timestep(torch.tensor(2.0)), jd._timestep(jnp.float32(2.0)))

    @pytest.mark.parametrize("cfg", [1.0, 2.0], ids=["no-cfg", "cfg"])
    def test_combined_area_mask_and_window_conds(self, cfg):
        x, ctx, unc, y, _ = _inputs(2)
        e_ctx = np.random.default_rng(3).normal(size=(1, 4, 8)).astype(np.float32)
        e_y = np.random.default_rng(4).normal(size=(1, 5)).astype(np.float32)
        mask = (np.arange(24)[None, :, None] < 10).repeat(20, axis=2).astype(np.float32)

        def conds(A):
            return dict(
                extra_conds=[
                    {"context": A(e_ctx), "pooled": A(e_y), "strength": 0.7,
                     "area": (3, 2, 1, 1)},
                    {"context": A(e_ctx[:, :2]), "area_pct": (0.5, 0.6, 0.5, 0.2),
                     "mask": A(mask), "mask_strength": 0.8},
                    {"context": A(e_ctx[:, 1:]), "timestep_range": (0.0, 0.5)},
                ],
                cond_area=(4, 3, 0, 1), cond_strength=1.3)

        kw = dict(cfg_scale=cfg, uncond_context=unc, y=y)
        jd = jk.EpsDenoiser(jmodel, jnp.asarray(ctx), **{k: jnp.asarray(v) if
                            isinstance(v, np.ndarray) else v for k, v in kw.items()},
                            **conds(jnp.asarray))
        T = torch.from_numpy
        pd = pk.EpsDenoiser(pmodel, T(ctx), **{k: T(v) if isinstance(v, np.ndarray) else v
                                              for k, v in kw.items()}, **conds(T))
        for sigma in (10.0, 1.2, 0.1):  # the window is open at 0.1, closed at 10
            _close(pd(T(x), torch.tensor(sigma)), jd(jnp.asarray(x), jnp.float32(sigma)))
        jm = jk.EpsDenoiser(jmodel, jnp.asarray(ctx), cond_mask=jnp.asarray(mask),
                            cond_mask_strength=0.5)
        pm = pk.EpsDenoiser(pmodel, T(ctx), cond_mask=T(mask), cond_mask_strength=0.5)
        _close(pm(T(x), torch.tensor(2.0)), jm(jnp.asarray(x), jnp.float32(2.0)))

    def test_area_weight_and_gate_match_jax(self):
        shape = (2, 6, 5, 4)
        for kw in (dict(area=(3, 2, 1, 2)), dict(area_pct=(0.5, 0.5, 0.25, 0.1)),
                   dict(mask=np.ones((8, 8), np.float32) * 0.5, mask_strength=0.3), {}):
            _close(pk.area_weight(None if "area" not in kw else kw["area"], 0.7, shape,
                                  mask=kw.get("mask"), mask_strength=kw.get("mask_strength", 1.0),
                                  area_pct=kw.get("area_pct")),
                   jk.area_weight(kw.get("area"), 0.7, shape, mask=kw.get("mask"),
                                  mask_strength=kw.get("mask_strength", 1.0),
                                  area_pct=kw.get("area_pct")))
        from comfyui_parallelanything_tpu.ops.basic import progress_window_gate

        t = np.asarray([0.0, 300.0, 700.0, 999.0], np.float32)
        for flow in (False, True):
            tt = t / 999.0 if flow else t
            got = pbasic.progress_window_gate(torch.from_numpy(tt), 0.2, 0.75, 4, flow)
            np.testing.assert_array_equal(
                got.numpy(), np.asarray(progress_window_gate(jnp.asarray(tt), 0.2, 0.75, 4, flow)))
        assert pk.broadcast_cond_batch(torch.ones(1, 3), 4).shape == (4, 3)
        with pytest.raises(ValueError, match="does not divide"):
            pk.broadcast_cond_batch(torch.ones(3, 3), 4)


SIGMAS = np.array(jk.karras_sigmas(4), np.float32)
FLOW_SIGMAS = np.array(jk.make_sigmas("normal", 4, sigma_table=jk.flow_sigma_table(2.0)),
                         np.float32)


def _pair_denoisers(prediction="eps", cfg=2.0):
    x, ctx, unc, y, uy = _inputs(5)
    jd = jk.EpsDenoiser(jmodel, jnp.asarray(ctx), cfg_scale=cfg, uncond_context=jnp.asarray(unc),
                        prediction=prediction, y=jnp.asarray(y))
    T = torch.from_numpy
    pd = pk.EpsDenoiser(pmodel, T(ctx), cfg_scale=cfg, uncond_context=T(unc),
                        prediction=prediction, y=T(y))
    return x, jd, pd


class TestSamplers:
    @pytest.mark.parametrize("name", list(jk.SAMPLERS) + [f"flow:{n}" for n in jk.FLOW_VARIANTS])
    def test_sampler_matches_jax(self, name, jax_noise):
        flow = name.startswith("flow:")
        name = name.removeprefix("flow:")
        assert list(pk.SAMPLERS) == list(jk.SAMPLERS) and pk.RNG_SAMPLERS == jk.RNG_SAMPLERS
        assert set(pk.FLOW_VARIANTS) == set(jk.FLOW_VARIANTS)
        assert pk.FLOW_REJECT == jk.FLOW_REJECT
        jfn = jk.FLOW_VARIANTS[name] if flow else jk.SAMPLERS[name]
        pfn = pk.FLOW_VARIANTS[name] if flow else pk.SAMPLERS[name]
        sig = FLOW_SIGMAS if flow else SIGMAS
        x, jd, pd = _pair_denoisers("flow" if flow else "eps")
        x = x * float(sig[0])
        jseen, pseen = [], []
        args_j, args_p = (), ()
        if name in jk.RNG_SAMPLERS:
            key = jax.random.key(7)
            jax_noise["base"], jax_noise["split"] = key, name == "dpmpp_sde"
            args_j, args_p = (key,), (torch.Generator().manual_seed(7),)
        want = jfn(jd, jnp.asarray(x), jnp.asarray(sig), *args_j,
                   callback=lambda i, z: jseen.append(i))
        got = pfn(pd, torch.from_numpy(x), torch.from_numpy(sig), *args_p,
                  callback=lambda i, z: pseen.append(i))
        assert pseen == jseen == list(range(len(sig) - 1))
        assert got.shape == x.shape and torch.isfinite(got).all()
        _close(got, want)
        if name in jk.RNG_SAMPLERS:
            parts = {p for _, p in jax_noise["calls"]}
            assert jax_noise["calls"] and parts == ({0, 1} if name == "dpmpp_sde" else {0})

    def test_step_noise_depends_on_seed_step_and_part_only(self):
        like = torch.zeros(3, 4)
        g = torch.Generator().manual_seed(11)
        a = pk.step_noise(g, 2, (3, 4), like)
        torch.randn(5, generator=g)  # advancing the request generator changes nothing
        assert torch.equal(a, pk.step_noise(g, 2, (3, 4), like))
        others = [pk.step_noise(g, 3, (3, 4), like), pk.step_noise(g, 2, (3, 4), like, part=1),
                  pk.step_noise(torch.Generator().manual_seed(12), 2, (3, 4), like)]
        assert all(not torch.equal(a, o) for o in others)
        assert a.dtype == torch.float32 and abs(float(a.mean())) < 1.0


class TestDDIM:
    @pytest.mark.parametrize("prediction", ["eps", "v"])
    def test_ddim_matches_jax(self, prediction):
        x, ctx, unc, y, uy = _inputs(6)
        kw = dict(steps=4, cfg_scale=3.0, prediction=prediction, cfg_rescale=0.3)
        T = torch.from_numpy
        want = jddim.ddim_sample(jmodel, jnp.asarray(x), jnp.asarray(ctx),
                                 uncond_context=jnp.asarray(unc), y=jnp.asarray(y),
                                 uncond_kwargs={"y": jnp.asarray(uy)}, **kw)
        got = pddim.ddim_sample(pmodel, T(x), T(ctx), uncond_context=T(unc), y=T(y),
                                uncond_kwargs={"y": T(uy)}, **kw)
        _close(got, want)
        ts = np.asarray([900, 500, 120, 3], np.int32)
        acp = jsched.scaled_linear_schedule(1000, 0.001, 0.02)
        want = jddim.ddim_sample(jmodel, jnp.asarray(x), jnp.asarray(ctx), ts=jnp.asarray(ts),
                                 alphas_cumprod=acp, prediction=prediction)
        got = pddim.ddim_sample(pmodel, T(x), T(ctx), ts=T(ts), prediction=prediction,
                                alphas_cumprod=T(np.asarray(acp)))
        _close(got, want)
        with pytest.raises(ValueError, match="prediction"):
            pddim.ddim_sample(pmodel, T(x), T(ctx), prediction="flow")


RUNS = {
    "dpmpp_2m-karras": dict(sampler="dpmpp_2m", steps=4),
    "euler-normal": dict(sampler="euler", steps=3, karras=False),
    "heun-scheduler-simple": dict(sampler="heun", steps=3, scheduler="simple"),
    "euler_ancestral-cfg-rescale": dict(sampler="euler_ancestral", steps=3, cfg=True,
                                        cfg_rescale=0.5),
    "dpmpp_sde-cfg": dict(sampler="dpmpp_sde", steps=2, cfg=True),
    "img2img-dpmpp_2m": dict(sampler="dpmpp_2m", steps=3, denoise=0.6, init=True),
    "img2img-beta-rescaled": dict(sampler="euler", steps=199, denoise=0.995, init=True,
                                  scheduler="beta"),
    "img2img-ddim_uniform": dict(sampler="lms", steps=3, denoise=0.5, init=True,
                                 scheduler="ddim_uniform"),
    "inpaint-uni_pc": dict(sampler="uni_pc", steps=3, denoise=0.7, init=True, mask=True),
    "inpaint-full-denoise-lcm": dict(sampler="lcm", steps=2, init=True, mask=True),
    "sigmas": dict(sampler="dpm_2", steps=2, sigmas=[6.0, 1.5, 0.0]),
    "sigmas-init": dict(sampler="euler", steps=2, sigmas=[2.0, 0.7, 0.0], init=True),
    "v-ddpm": dict(sampler="ddpm", steps=3, prediction="v"),
    "acp-dpmpp_3m_sde": dict(sampler="dpmpp_3m_sde", steps=3, acp=True, cfg=True),
    "multi-cond-euler": dict(sampler="euler", steps=2, multi=True, cfg=True),
    "flow-euler-guidance": dict(sampler="euler", steps=3, prediction="flow", shift=3.0,
                                guidance=3.5),
    "flow-euler_ancestral-rf": dict(sampler="euler_ancestral", steps=3, prediction="flow",
                                    scheduler="karras", shift=1.5),
    "flow-img2img-inpaint": dict(sampler="dpmpp_2m", steps=3, prediction="flow", denoise=0.5,
                                 init=True, mask=True),
    "flow-sigmas-init": dict(sampler="heun", steps=2, prediction="flow",
                             sigmas=[0.8, 0.4, 0.0], init=True),
    "ddim": dict(sampler="ddim", steps=4, cfg=True),
    "ddim-v-img2img": dict(sampler="ddim", steps=3, prediction="v", denoise=0.4, init=True),
    "ddim-inpaint-acp": dict(sampler="ddim", steps=3, denoise=0.8, init=True, mask=True,
                             acp=True),
}


class TestRunSampler:
    @pytest.mark.parametrize("case", list(RUNS))
    def test_branch_matches_jax(self, case, jax_noise):
        kw = dict(RUNS[case])
        x, ctx, unc, y, uy = _inputs(8)
        init = np.random.default_rng(9).normal(size=x.shape).astype(np.float32)
        mask = (np.arange(SHAPE[1])[None, :, None, None] < 3).astype(np.float32)
        common = {k: kw[k] for k in ("sampler", "steps", "karras", "scheduler", "denoise",
                                     "prediction", "shift", "guidance", "cfg_rescale")
                  if k in kw}
        jkw, pkw = dict(common, y=jnp.asarray(y)), dict(common, y=torch.from_numpy(y))
        T = torch.from_numpy
        for flag, name, value in (("init", "init_latent", init), ("mask", "latent_mask", mask)):
            if kw.get(flag):
                jkw[name], pkw[name] = jnp.asarray(value), T(value)
        if "sigmas" in kw:
            jkw["sigmas"], pkw["sigmas"] = jnp.asarray(kw["sigmas"]), kw["sigmas"]
        if kw.get("cfg"):
            jkw.update(cfg_scale=2.5, uncond_context=jnp.asarray(unc),
                       uncond_kwargs={"y": jnp.asarray(uy)})
            pkw.update(cfg_scale=2.5, uncond_context=T(unc), uncond_kwargs={"y": T(uy)})
        if kw.get("acp"):
            acp = np.asarray(jsched.scaled_linear_schedule(1000, 0.001, 0.02))
            jkw["alphas_cumprod"], pkw["alphas_cumprod"] = jnp.asarray(acp), T(acp)
        if kw.get("multi"):
            e = np.random.default_rng(10).normal(size=(1, 2, 8)).astype(np.float32)
            jkw.update(extra_conds=[{"context": jnp.asarray(e), "area": (2, 3, 1, 0)}],
                       cond_strength=0.8)
            pkw.update(extra_conds=[{"context": T(e), "area": (2, 3, 1, 0)}], cond_strength=0.8)
        # The JAX runner hands the stochastic samplers fold_in(rng, 1) of its
        # default key(0); the port's default generator is seeded 0.
        jax_noise["base"] = jax.random.fold_in(jax.random.key(0), 1)
        jax_noise["split"] = kw["sampler"] == "dpmpp_sde"
        seen = []
        want = jax_run_sampler(jmodel, jnp.asarray(x), jnp.asarray(ctx), **jkw)
        got = prunner.run_sampler(pmodel, T(x), T(ctx), callback=lambda i, z: seen.append(i),
                                  **pkw)
        assert seen and seen == list(range(len(seen)))
        assert got.shape == x.shape and got.dtype == torch.float32
        _close(got, want)

    def test_error_cases(self):
        T = torch.from_numpy
        x, ctx, *_ = (T(a) for a in _inputs(11))
        for kw, exc, match in (
                (dict(sampler="ddim", extra_conds=[{"context": ctx}]), ValueError,
                 "k-sampler family only"),
                (dict(sampler="flow_euler", cond_area=(1, 1, 0, 0)), ValueError,
                 "k-sampler family only"),
                (dict(sampler="ddim", prediction="flow"), ValueError, "no flow form"),
                (dict(sampler="ddim", sigmas=[1.0, 0.0]), ValueError, "timestep-indexed"),
                (dict(sampler="ddpm", prediction="flow"), ValueError, "rectified-flow"),
                (dict(sampler="euler", prediction="flow",
                      alphas_cumprod=psched.scaled_linear_schedule()), ValueError,
                 "no flow meaning"),
                (dict(sampler="euler", denoise=1.5), ValueError, "denoise"),
                (dict(sampler="euler", latent_mask=x), ValueError, "init_latent"),
                (dict(sampler="nope"), ValueError, "unknown sampler"),
                (dict(sampler="euler", compile_loop=True, latent_mask=x), ValueError,
                 "init_latent"),
                (dict(sampler="ddim", lora={"a": 1}), TypeError, "addressable")):
            with pytest.raises(exc, match=match):
                prunner.run_sampler(pmodel, x, ctx, steps=2, **kw)
        for kw in (dict(sampler="ddim", extra_conds=[{"context": jnp.asarray(ctx.numpy())}]),
                   dict(sampler="ddpm", prediction="flow")):
            with pytest.raises(ValueError):
                jax_run_sampler(jmodel, jnp.asarray(x.numpy()), jnp.asarray(ctx.numpy()),
                                steps=2, **kw)

    def test_default_rng_is_seeded_zero(self, monkeypatch):
        seeds = []

        def spy(rng, i, shape, like, part=0):
            seeds.append(rng.initial_seed())
            return torch.zeros(tuple(shape))

        monkeypatch.setattr(pk, "step_noise", spy)
        x, ctx, *_ = (torch.from_numpy(a) for a in _inputs(12))
        prunner.run_sampler(pmodel, x, ctx, sampler="euler_ancestral", steps=2)
        assert seeds == [0]
        prunner.run_sampler(pmodel, x, ctx, sampler="lcm", steps=3,
                            rng=torch.Generator().manual_seed(5))
        assert seeds == [0, 5, 5]
        assert prunner.SAMPLER_NAMES == ("ddim", *jk.SAMPLERS, "flow_euler")
