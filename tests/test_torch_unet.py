"""Parity of the PyTorch port's SD-family UNet (``models/unet.py``), its ldm
checkpoint converter (``models/convert_unet.py``) and ``convert_jax``'s UNet tree
carrier against the JAX package on the CPU.

The same numpy weights (a flax tree made from a seed for the JAX module's abstract
parameters, no JAX ``init`` run) go to both sides, the port through
``convert_jax.from_jax_unet_params``; the same NHWC latents, timesteps, contexts and
pooled vectors go in. Configs are tiny (32/64/128 channels, one res block per
level). Both sides run in f32 (the JAX side under the suite's ``highest`` matmul
precision) and must agree to rtol/atol 2e-4; the converters exactly.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from comfyui_parallelanything_tpu.models import convert_unet as jcu  # noqa: E402
from comfyui_parallelanything_tpu.models import unet as ju  # noqa: E402
from comfyui_parallelanything_tpu_torch.models import convert_unet as pcu  # noqa: E402
from comfyui_parallelanything_tpu_torch.models import unet as pu  # noqa: E402
from comfyui_parallelanything_tpu_torch.models.convert_jax import (  # noqa: E402
    from_jax_unet_params,
)

from test_convert_unet import _ldm_sd  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
# SDXL-like: the tiny config of tests/test_golden_unet.py (its deepest level has
# attention, so it has a middle transformer) with the adm vector, SDXL's
# heads = channels // 64 rule and one transformer block per stage.
SDXL_LIKE = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                 attention_levels=(1,), transformer_depth=(0, 1), num_heads=-1,
                 context_dim=48, norm_groups=8, adm_in_channels=24)
# SD1.5-like: attention at the upper level only, none at the deepest, so no middle
# transformer (as sd15_config() has none); widths 64/128 are 2x and 4x the base
# width, the two FreeU stages.
SD15_LIKE = dict(model_channels=32, channel_mult=(2, 4), num_res_blocks=1,
                 attention_levels=(0,), transformer_depth=(1, 0), num_heads=4,
                 context_dim=48, norm_groups=8)
CONFIGS = {"sd15_like": SD15_LIKE, "sdxl_like": SDXL_LIKE}
# Parameters of the JAX package's full-size UNet2D per config, counted from its
# abstract tree (jax.eval_shape of init on a 1×8×8×4 sample): tracing the four
# full-size modules takes longer than this file may.
JAX_PARAM_COUNTS = {"sd15_config": 824_760_004, "sd21_config": 830_494_404,
                    "sdxl_config": 2_567_463_684, "sdxl_refiner_config": 2_259_526_660}


def _numpy_tree(abstract, seed):
    """Random weights for an abstract flax tree: kernels N(0, 1/fan_in), norm
    scales and biases off their init values."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = path[-1].key
        if name == "kernel":
            if a.ndim == 4:
                fan_in = int(np.prod(a.shape[:-1]))
            elif path[-2].key.endswith("_o"):
                fan_in = a.shape[0] * a.shape[1]
            else:
                fan_in = a.shape[0]
            return (rng.normal(size=a.shape) / np.sqrt(fan_in)).astype(np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + 0.1 * rng.normal(size=a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, abstract)


def _configs(kw):
    return ju.UNetConfig(**kw, dtype=jnp.float32), pu.UNetConfig(**kw, dtype=torch.float32)


def _inputs(seed, jcfg, batch=2, hw=(8, 8), ctx_len=5):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, *hw, jcfg.in_channels)).astype(np.float32)
    t = np.asarray([981.0, 17.5, 500.0][:batch], np.float32)
    ctx = rng.normal(size=(batch, ctx_len, jcfg.context_dim)).astype(np.float32)
    kw = {}
    if jcfg.adm_in_channels is not None:
        kw["y"] = rng.normal(size=(batch, jcfg.adm_in_channels)).astype(np.float32)
    return x, t, ctx, kw


@functools.cache
def _pair(name):
    """(JAX model, port model, numpy tree) for one of ``CONFIGS``, built once."""
    jcfg, pcfg = _configs(CONFIGS[name])
    x, t, ctx, kw = _inputs(0, jcfg, batch=1)
    abstract = jax.eval_shape(ju.UNet2D(jcfg).init, jax.random.key(0), x, t, ctx,
                              **kw)["params"]
    tree = _numpy_tree(abstract, seed=len(name))
    jm = ju.build_unet(jcfg, params=jax.tree.map(jnp.asarray, tree))
    pm = pu.build_unet(pcfg, device="cpu", state_dict=from_jax_unet_params(tree))
    return jm, pm, tree


def _jax(jm, x, t, ctx, kw, **extra):
    return np.asarray(jm(jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
                         **{k: jnp.asarray(v) for k, v in kw.items()}, **extra))


def _port(pm, x, t, ctx, kw, **extra):
    T = torch.from_numpy
    return pm(T(x), T(t), T(ctx), **{k: T(v) for k, v in kw.items()}, **extra)


def _control_residuals(cfg, x, seed):
    """One NHWC residual per skip, shaped like the skip it joins, and one for the
    middle block's output."""
    chans, hw = [cfg.model_channels], [x.shape[1]]
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            chans.append(cfg.model_channels * mult)
            hw.append(hw[-1])
        if level != len(cfg.channel_mult) - 1:
            chans.append(cfg.model_channels * mult)
            hw.append(hw[-1] // 2)
    rng = np.random.default_rng(seed)
    ins = [rng.normal(size=(x.shape[0], s, s, c)).astype(np.float32) * 0.3
           for s, c in zip(hw, chans)]
    mid = rng.normal(size=(x.shape[0], hw[-1], hw[-1], chans[-1])).astype(np.float32) * 0.3
    return {"input": ins, "middle": [mid]}


@functools.cache
def _freeu_control_case():
    """The SD1.5-like UNet with FreeU (v2) and ControlNet residuals: the port model,
    the inputs and the JAX output. One JAX program serves both the FreeU and the
    control test (each compile costs seconds on one core)."""
    jm, pm, tree = _pair("sd15_like")
    freeu = (1.1, 1.2, 0.6, 0.4, 2)
    jf = ju.build_unet(dataclasses.replace(jm.config, freeu=freeu), params=jm.params)
    pf = pu.build_unet(dataclasses.replace(pm.config, freeu=freeu), device="cpu",
                       state_dict=from_jax_unet_params(tree))
    x, t, ctx, kw = _inputs(3, jm.config)
    control = _control_residuals(pm.config, x, seed=4)
    want = _jax(jf, x, t, ctx, kw, control={k: [jnp.asarray(a) for a in v]
                                           for k, v in control.items()})
    return pf, x, t, ctx, kw, control, want


class TestUNet:
    # Every JAX forward here is a jit compile of a few seconds on one core, so the
    # tests share shapes: one program per config, plus one with control residuals
    # and one with FreeU.

    @pytest.mark.parametrize("name", sorted(CONFIGS))
    def test_forward_matches_jax(self, name):
        jm, pm, _ = _pair(name)
        x, t, ctx, kw = _inputs(1, jm.config)
        want = _jax(jm, x, t, ctx, kw)
        got = _port(pm, x, t, ctx, kw)
        assert got.shape == want.shape == x.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        assert hasattr(pm.module, "mid_attn") == (name == "sdxl_like")
        assert pu.middle_depth(pm.config) == ju.middle_depth(jm.config)

    @pytest.mark.parametrize("name", sorted(CONFIGS))
    def test_staged_pipeline_spec_matches_forward(self, name):
        jm, pm, _ = _pair(name)
        x, t, ctx, kw = _inputs(2, jm.config)
        spec, jspec = pm.pipeline_spec, jm.pipeline_spec
        assert [s.label for s in spec.segments] == [s.label for s in jspec.segments]
        assert [s.param_keys for s in spec.segments] == [s.param_keys for s in jspec.segments]
        assert (spec.prepare_keys, spec.finalize_keys) == (jspec.prepare_keys,
                                                           jspec.finalize_keys)
        names = {n.split(".")[0] for n, _ in pm.module.named_parameters()}
        assert names == set(spec.prepare_keys) | set(spec.finalize_keys) | {
            k for s in spec.segments for k in s.param_keys}
        T = torch.from_numpy
        with torch.no_grad():
            carry = spec.prepare(pm.module, T(x), T(t), T(ctx), **{k: T(v) for k, v in kw.items()})
            for seg in spec.segments:
                carry = seg.fn(pm.module, carry)
            staged = spec.finalize(pm.module, carry, x.shape)
        torch.testing.assert_close(staged, _port(pm, x, t, ctx, kw), rtol=0, atol=0)
        np.testing.assert_allclose(staged.numpy(), _jax(jm, x, t, ctx, kw), **TOL)

    def test_control_residuals_match_jax(self):
        pf, x, t, ctx, kw, control, want = _freeu_control_case()
        T = torch.from_numpy
        got = _port(pf, x, t, ctx, kw, control={k: [T(a) for a in v] for k, v in control.items()})
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        # The residuals count, and a control with a residual too few is refused.
        assert (got - _port(pf, x, t, ctx, kw)).abs().max() > 1e-2
        with pytest.raises(ValueError, match="ControlNet/UNet config mismatch"):
            _port(pf, x, t, ctx, kw, control={"input": [T(a) for a in control["input"][1:]]})

    def test_freeu_matches_jax(self):
        pf, x, t, ctx, kw, control, want = _freeu_control_case()
        _, pm, _ = _pair("sd15_like")
        T = torch.from_numpy
        ctrl = {k: [T(a) for a in v] for k, v in control.items()}
        np.testing.assert_allclose(_port(pf, x, t, ctx, kw, control=ctrl).numpy(), want, **TOL)
        assert (_port(pf, x, t, ctx, kw, control=ctrl)
                - _port(pm, x, t, ctx, kw, control=ctrl)).abs().max() > 1e-2  # on != off

    @pytest.mark.parametrize("version", [1, 2])
    def test_apply_freeu_matches_jax(self, version):
        cfg_kw = dict(SD15_LIKE, freeu=(1.3, 1.4, 0.9, 0.2, version))
        jcfg, pcfg = _configs(cfg_kw)
        rng = np.random.default_rng(5 + version)
        for c in (64, 128, 96):  # the b2/s2 stage, the b1/s1 stage, neither
            h = rng.normal(size=(2, 6, 5, c)).astype(np.float32)
            skip = rng.normal(size=(2, 6, 5, c)).astype(np.float32)
            wh, ws = ju._apply_freeu(jcfg, jnp.asarray(h), jnp.asarray(skip))
            gh, gs = pu._apply_freeu(pcfg, *(torch.from_numpy(a).permute(0, 3, 1, 2)
                                             for a in (h, skip)))
            np.testing.assert_allclose(gh.permute(0, 2, 3, 1).numpy(), np.asarray(wh), **TOL)
            np.testing.assert_allclose(gs.permute(0, 2, 3, 1).numpy(), np.asarray(ws), **TOL)

    def test_fourier_filter_matches_jax(self):
        x = np.random.default_rng(6).normal(size=(2, 7, 6, 3)).astype(np.float32)
        for threshold, scale in ((1, 0.3), (2, 1.7)):
            want = np.asarray(ju._fourier_filter(jnp.asarray(x), threshold, scale))
            got = pu._fourier_filter(torch.from_numpy(x).permute(0, 3, 1, 2), threshold, scale)
            np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, **TOL)


def _block_pair(jmodule, pmodule, seed, *sample):
    abstract = jax.eval_shape(jmodule.init, jax.random.key(0), *sample)["params"]
    tree = _numpy_tree(abstract, seed)
    pmodule.load_state_dict(from_jax_unet_params(tree))
    return jax.tree.map(jnp.asarray, tree)


class TestBlocks:
    jcfg, pcfg = _configs(dict(SDXL_LIKE, num_heads=2))

    def _nhwc(self, seed, shape):
        return np.random.default_rng(seed).normal(size=shape).astype(np.float32)

    @pytest.mark.parametrize("io", [(32, 32), (32, 64)], ids=["same", "shortcut"])
    def test_res_block(self, io):
        cin, cout = io
        x, emb = self._nhwc(1, (2, 6, 5, cin)), self._nhwc(2, (2, 128))
        jb, pb = ju.ResBlock(self.jcfg, cout), pu.ResBlock(self.pcfg, cin, cout)
        p = _block_pair(jb, pb, 3, jnp.asarray(x), jnp.asarray(emb))
        want = np.asarray(jax.jit(jb.apply)({"params": p}, jnp.asarray(x), jnp.asarray(emb)))
        got = pb(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(emb))
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(), want, **TOL)

    @pytest.mark.parametrize("cross", [True, False], ids=["cross", "self-only"])
    def test_transformer_block(self, cross):
        # Without a context, attn2 attends over the tokens themselves, so its k/v
        # take the tokens' width.
        x = self._nhwc(4, (2, 30, 64))
        ctx = self._nhwc(5, (2, 7, 48)) if cross else None
        pcfg = self.pcfg if cross else dataclasses.replace(self.pcfg, context_dim=64)
        jb, pb = ju.TransformerBlock(self.jcfg, 64), pu.TransformerBlock(pcfg, 64)
        jctx = None if ctx is None else jnp.asarray(ctx)
        p = _block_pair(jb, pb, 6, jnp.asarray(x), jctx)
        want = np.asarray(jax.jit(jb.apply)({"params": p}, jnp.asarray(x), jctx))
        got = pb(torch.from_numpy(x), None if ctx is None else torch.from_numpy(ctx))
        np.testing.assert_allclose(got.detach().numpy(), want, **TOL)

    def test_spatial_transformer_down_and_upsample(self):
        x, ctx = self._nhwc(7, (2, 6, 4, 64)), self._nhwc(8, (2, 5, 48))
        jb, pb = ju.SpatialTransformer(self.jcfg, 64, 2), pu.SpatialTransformer(self.pcfg, 64, 2)
        p = _block_pair(jb, pb, 9, jnp.asarray(x), jnp.asarray(ctx))
        want = np.asarray(jax.jit(jb.apply)({"params": p}, jnp.asarray(x), jnp.asarray(ctx)))
        got = pb(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(ctx))
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(), want, **TOL)
        for jcls, pcls, shape in ((ju.Downsample, pu.Downsample, (2, 7, 6, 32)),
                                  (ju.Upsample, pu.Upsample, (2, 3, 4, 32))):
            x = self._nhwc(10, shape)
            jb, pb = jcls(self.jcfg, 32), pcls(self.pcfg, 32)
            p = _block_pair(jb, pb, 11, jnp.asarray(x))
            want = np.asarray(jax.jit(jb.apply)({"params": p}, jnp.asarray(x)))
            got = pb(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            assert got.shape == want.shape
            np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


class TestConfigsAndConverter:
    @pytest.mark.parametrize("name", ["sd15_config", "sd21_config", "sdxl_config",
                                      "sdxl_refiner_config"])
    def test_configs_and_full_size_parameters_match_jax(self, name):
        jcfg, pcfg = getattr(ju, name)(), getattr(pu, name)()
        jd, pd = dataclasses.asdict(jcfg), dataclasses.asdict(pcfg)
        jd.pop("dtype"), pd.pop("dtype")
        assert jd == pd and pcfg.dtype == torch.bfloat16
        with torch.device("meta"):
            module = pu.UNet2D(pcfg)
        assert sum(p.numel() for p in module.parameters()) == JAX_PARAM_COUNTS[name]
        assert module.out_conv.weight.dtype == torch.float32
        assert module.in_1_0_attn.blocks[0].attn1_q.weight.dtype == torch.bfloat16

    @pytest.mark.parametrize("name", sorted(CONFIGS))
    @pytest.mark.parametrize("linear_proj", [False, True], ids=["conv-proj", "linear-proj"])
    def test_convert_sd_unet_checkpoint_matches_jax(self, name, linear_proj):
        jm, pm, tree = _pair(name)
        ldm = _ldm_sd(jm.config, tree)
        if linear_proj:  # SDXL stores proj_in/proj_out as linears
            ldm = {k: v[:, :, 0, 0] if ".proj_" in k and v.ndim == 4 else v
                   for k, v in ldm.items()}
        ldm = {f"model.diffusion_model.{k}": v for k, v in ldm.items()}
        want = from_jax_unet_params(jax.tree.map(
            np.asarray, jcu.convert_sd_unet_checkpoint(jcu.strip_prefix(ldm), jm.config)))
        got = pcu.convert_sd_unet_checkpoint(pcu.strip_prefix(ldm), pm.config)
        assert sorted(got) == sorted(want) == sorted(pm.module.state_dict())
        for k in want:
            assert got[k].dtype == torch.float32
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
        assert pcu.strip_prefix({"a.weight": 1}) == {"a.weight": 1}
