"""Parity of the PyTorch port's rest of the UNet family against the JAX package on
the CPU: ControlNet (``models/controlnet.py``: ``ControlNet2D``, ``apply_control``
with strength, the start/end percent window, the hint's bilinear resize and
stacked nets), its ldm and diffusers converters (``models/convert_unet.py``), the
9-channel inpaint input (``unet.apply_inpaint_conditioning``) and SD2.x-unCLIP's
adm vector (``unet.unclip_adm``).

The same numpy weights (made from a seed for the JAX modules' abstract parameter
trees, no JAX ``init`` run; every zero convolution random, since a zero one makes
the ControlNet an exact no-op) go to both sides, the port through
``convert_jax.from_jax_unet_params``. Configs are tiny (32/64 channels, one res
block per level, attention and a middle transformer at the deeper level). Both
sides run in f32 (the JAX side under the suite's ``highest`` matmul precision) and
must agree to rtol/atol 2e-4; the converters exactly. The unCLIP augmentation is
fed the normal draws the JAX function takes (``jax.random.normal`` of
``fold_in(key(0), i)``).
"""

import functools
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from comfyui_parallelanything_tpu.models import controlnet as jcn  # noqa: E402
from comfyui_parallelanything_tpu.models import convert_unet as jcu  # noqa: E402
from comfyui_parallelanything_tpu.models import unet as ju  # noqa: E402
from comfyui_parallelanything_tpu_torch import parallelize  # noqa: E402
from comfyui_parallelanything_tpu_torch.models import controlnet as pcn  # noqa: E402
from comfyui_parallelanything_tpu_torch.models import convert_unet as pcu  # noqa: E402
from comfyui_parallelanything_tpu_torch.models import unet as pu  # noqa: E402
from comfyui_parallelanything_tpu_torch.models.convert_jax import (  # noqa: E402
    from_jax_unet_params,
)
from comfyui_parallelanything_tpu_torch.ops.kernels import flash_attention as fa  # noqa: E402

from test_controlnet import _diffusers_from_ldm, _ldm_controlnet_sd  # noqa: E402
from test_torch_unet import _numpy_tree  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
TINY = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=1, attention_levels=(1,),
            transformer_depth=(0, 1), num_heads=4, context_dim=64, norm_groups=8)


def _configs(**kw):
    return (ju.UNetConfig(**TINY, **kw, dtype=jnp.float32),
            pu.UNetConfig(**TINY, **kw, dtype=torch.float32))


def _inputs(seed, in_ch=4):
    """Batch 2, latent 8², timesteps inside (progress 0.5) and outside (0.97) of a
    (0.1, 0.9) window."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 8, 8, in_ch)).astype(np.float32)
    t = np.asarray([499.5, 30.0], np.float32)
    ctx = rng.normal(size=(2, 5, 64)).astype(np.float32)
    return x, t, ctx


def _hint(seed, hw):
    return np.random.default_rng(seed).uniform(size=(1, hw, hw, 3)).astype(np.float32)


@functools.cache
def _nets():
    """The JAX and port base UNet and two ControlNets, and the ControlNets' trees."""
    jcfg, pcfg = _configs()
    x, t, ctx = _inputs(0)
    unet_tree = _numpy_tree(jax.eval_shape(ju.UNet2D(jcfg).init, jax.random.key(0), x, t,
                                           ctx)["params"], 1)
    jbase = ju.build_unet(jcfg, params=jax.tree.map(jnp.asarray, unet_tree))
    pbase = pu.build_unet(pcfg, device="cpu", state_dict=from_jax_unet_params(unet_tree))
    abstract = jax.eval_shape(jcn.ControlNet2D(jcfg).init, jax.random.key(0), x,
                              _hint(0, 64), t, ctx)["params"]
    nets, trees = [], []
    for seed in (2, 3):
        tree = _numpy_tree(abstract, seed)
        trees.append(tree)
        nets.append((jcn.build_controlnet(jcfg, params=jax.tree.map(jnp.asarray, tree)),
                     pcn.build_controlnet(pcfg, device="cpu",
                                          state_dict=from_jax_unet_params(tree))))
    return (jbase, pbase), nets, trees


def _compose(base, net, hint, **kw):
    """One apply_control on each side: (JAX model, port model)."""
    return (jcn.apply_control(base[0], net[0], jnp.asarray(hint), **kw),
            pcn.apply_control(base[1], net[1], hint, **kw))


@functools.cache
def _controlled():
    """Base + net 0 at strength 0.7 inside the (0.1, 0.9) window with a 48² hint
    (resized to 64²), then net 1 (64² hint) stacked on it."""
    base, nets, _ = _nets()
    one = _compose(base, nets[0], _hint(4, 48), strength=0.7, start_percent=0.1,
                   end_percent=0.9)
    two = _compose(one, nets[1], _hint(5, 64))
    return one, two


def _run(pair, seed=6):
    x, t, ctx = _inputs(seed)
    want = np.asarray(pair[0](jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx)))
    T = torch.from_numpy
    return pair[1](T(x), T(t), T(ctx)), want


class TestControlNet:
    @pytest.mark.parametrize("stacked", [False, True], ids=["one-net", "two-nets"])
    def test_controlled_forward_matches_jax(self, stacked):
        one, two = _controlled()
        got, want = _run(two if stacked else one)
        assert got.shape == want.shape == (2, 8, 8, 4)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        base = _nets()[0][1]
        x, t, ctx = (torch.from_numpy(a) for a in _inputs(6))
        plain = base(x, t, ctx)
        # The window gates the second sample (progress 0.97) off; the first takes
        # the residuals. A stacked net acts on both.
        assert (got[0] - plain[0]).abs().max() > 1e-2
        if stacked:
            assert (got[1] - plain[1]).abs().max() > 1e-2
        else:
            torch.testing.assert_close(got[1], plain[1], rtol=0, atol=0)

    def test_controlnet_residuals_match_jax(self):
        _, nets, _ = _nets()
        x, t, ctx = _inputs(7)
        hint = np.repeat(_hint(8, 64), 2, axis=0)
        want = jax.jit(nets[0][0].apply)(nets[0][0].params, jnp.asarray(x), jnp.asarray(t),
                                         jnp.asarray(ctx), hint=jnp.asarray(hint))
        T = torch.from_numpy
        got = nets[0][1].module(T(x), T(hint), T(t), T(ctx))
        assert [r.shape for r in got["input"]] == [r.shape for r in want["input"]]
        for g, w in zip(got["input"] + got["middle"], list(want["input"]) + list(want["middle"])):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)

    def test_strength_scales_and_zero_init_is_a_no_op(self):
        (_, pbase), nets, _ = _nets()
        x, t, ctx = (torch.from_numpy(a) for a in _inputs(9))
        hint = _hint(10, 64)
        res = {s: pcn.apply_control(pbase, nets[0][1], hint, strength=s).module.residuals(
            x, t, ctx) for s in (1.0, 0.5)}
        for full, half in zip(res[1.0]["input"] + res[1.0]["middle"],
                              res[0.5]["input"] + res[0.5]["middle"]):
            torch.testing.assert_close(half, 0.5 * full, rtol=0, atol=0)
            assert full.abs().max() > 0
        fresh = pcn.build_controlnet(pbase.config, device="cpu",
                                     generator=torch.Generator().manual_seed(0))
        untrained = pcn.apply_control(pbase, fresh, hint)
        torch.testing.assert_close(untrained(x, t, ctx), pbase(x, t, ctx), rtol=0, atol=0)

    def test_hint_contracts(self):
        (jbase, pbase), nets, _ = _nets()
        x, t, ctx = _inputs(11)
        T = torch.from_numpy
        per_sample = np.concatenate([_hint(12, 64)] * 3)
        jm, pm_ = _compose((jbase, pbase), nets[0], per_sample)
        with pytest.raises(ValueError, match="pass ONE hint image"):
            jm.apply(jm.params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
        with pytest.raises(ValueError, match="pass ONE hint image"):
            pm_(T(x), T(t), T(ctx))
        with pytest.raises(ValueError, match="must be 8x the latent grid"):
            nets[0][1].module(T(x), T(_hint(13, 32)), T(t), T(ctx))

    def test_composition_parallelizes_as_one_model(self):
        one, _ = _controlled()
        pmodel = parallelize(one[1], [("cpu:0", 50), ("cpu:1", 50)])
        x, t, ctx = (torch.from_numpy(a) for a in _inputs(6))
        torch.testing.assert_close(pmodel(x, t, ctx), one[1](x, t, ctx), rtol=1e-5, atol=1e-5)
        assert pmodel.n_devices == 2 and one[1].name.endswith("+control")

    def test_full_size_controlled_sd15_attention_takes_the_expected_variants(self, monkeypatch):
        # SD1.5 + a ControlNet of the same config at 512² (64² latent), batch 2 (CFG),
        # on the meta device: the base's 20 sm90 + 10 wide calls plus the trunk's 8 +
        # 4 (its input blocks; no middle transformer, as sd15_config() has none), and
        # a 9-channel inpaint UNet's 20 + 10.
        from comfyui_parallelanything_tpu_torch.models import unet as unet_mod

        seen = Counter()

        def spy(q, k, v, scale=None):
            seen[fa.kernel_variant(q, k, v, scale)] += 1
            return torch.empty_like(q)

        monkeypatch.setattr(unet_mod, "attention", spy)
        with torch.device("meta"):
            base = pu.UNet2D(pu.sd15_config())
            composed = pcn.ControlledModel(base, pcn.ControlNet2D(pu.sd15_config()),
                                           torch.empty(1, 512, 512, 3), 1.0, 0.0, 1.0)
            out = composed(torch.empty(2, 64, 64, 4), torch.empty(2), torch.empty(2, 77, 768))
            assert out.shape == (2, 64, 64, 4) and dict(seen) == {"sm90": 28, "wide": 14}
            seen.clear()
            inpaint = pu.InpaintConditioned(pu.UNet2D(pu.sd15_config(in_channels=9)),
                                            torch.empty(1, 64, 64, 1),
                                            torch.empty(1, 64, 64, 4))
            out = inpaint(torch.empty(2, 64, 64, 4), torch.empty(2), torch.empty(2, 77, 768))
        assert out.shape == (2, 64, 64, 4) and dict(seen) == {"sm90": 20, "wide": 10}


class TestControlNetConverters:
    def test_convert_controlnet_checkpoint_matches_jax(self):
        (jbase, pbase), nets, trees = _nets()
        ldm = _ldm_controlnet_sd(jbase.config, trees[0])
        want = from_jax_unet_params(jax.tree.map(
            np.asarray, jcu.convert_controlnet_checkpoint(ldm, jbase.config)))
        got = pcu.convert_controlnet_checkpoint(ldm, pbase.config)
        assert sorted(got) == sorted(want) == sorted(nets[0][1].module.state_dict())
        for k in want:
            assert got[k].dtype == torch.float32
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)

    def test_diffusers_controlnet_to_ldm_matches_jax(self):
        (jbase, _), _, trees = _nets()
        ldm = _ldm_controlnet_sd(jbase.config, trees[1])
        diffusers = _diffusers_from_ldm(jbase.config, ldm)
        want = jcu.diffusers_controlnet_to_ldm(diffusers)
        got = pcu.diffusers_controlnet_to_ldm(diffusers)
        assert sorted(got) == sorted(want) == sorted(ldm)
        for k in want:
            assert got[k] is want[k], k
        bad = dict(diffusers, **{"time_embedding.cond_proj.weight": np.zeros((4, 4))})
        for fn in (jcu.diffusers_controlnet_to_ldm, pcu.diffusers_controlnet_to_ldm):
            with pytest.raises(KeyError, match="unrecognized diffusers controlnet key"):
                fn(bad)
            with pytest.raises(ValueError, match="not a diffusers ControlNet"):
                fn(ldm)


class TestInpaintConditioning:
    @functools.cache
    def _pair(self):
        jcfg, pcfg = _configs(in_channels=9)
        x, t, ctx = _inputs(0, in_ch=9)
        tree = _numpy_tree(jax.eval_shape(ju.UNet2D(jcfg).init, jax.random.key(0), x, t,
                                          ctx)["params"], 14)
        return (ju.build_unet(jcfg, params=jax.tree.map(jnp.asarray, tree)),
                pu.build_unet(pcfg, device="cpu", state_dict=from_jax_unet_params(tree)))

    def test_nine_channel_input_matches_jax(self):
        jbase, pbase = self._pair()
        rng = np.random.default_rng(15)
        mask = (rng.uniform(size=(1, 8, 8, 1)) > 0.5).astype(np.float32)
        masked = rng.normal(size=(1, 8, 8, 4)).astype(np.float32)
        jm = ju.apply_inpaint_conditioning(jbase, jnp.asarray(mask), jnp.asarray(masked))
        pm_ = pu.apply_inpaint_conditioning(pbase, mask, masked)
        got, want = _run((jm, pm_), seed=16)
        assert got.shape == (2, 8, 8, 4) and pm_.name.endswith("+inpaint")
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        x, t, ctx = (torch.from_numpy(a) for a in _inputs(16))
        manual = torch.cat([x, torch.from_numpy(mask).expand(2, -1, -1, -1),
                            torch.from_numpy(masked).expand(2, -1, -1, -1)], dim=-1)
        torch.testing.assert_close(got, pbase(manual, t, ctx), rtol=0, atol=0)

    def test_per_sample_conditioning_raises_as_in_jax(self):
        jbase, pbase = self._pair()
        x, t, ctx = _inputs(17)
        three = (np.zeros((3, 8, 8, 1), np.float32), np.zeros((3, 8, 8, 4), np.float32))
        jm = ju.apply_inpaint_conditioning(jbase, *map(jnp.asarray, three))
        with pytest.raises(ValueError, match="ONE mask"):
            jm.apply(jm.params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
        with pytest.raises(ValueError, match="ONE mask"):
            pu.apply_inpaint_conditioning(pbase, *three)(*map(torch.from_numpy, (x, t, ctx)))


def _jax_draws(monkeypatch):
    """The port's unCLIP draws replaced by the JAX function's: normal of
    ``fold_in(key(0), i)`` for the i-th augmentation."""
    def draw(generator, i, shape, device):
        key = jax.random.fold_in(jax.random.key(0), i)
        return torch.from_numpy(np.array(jax.random.normal(key, tuple(shape), jnp.float32)))

    monkeypatch.setattr(pu, "unclip_noise", draw)


class TestUnclipAdm:
    @pytest.mark.parametrize("aug", [0.0, 0.25, 0.5004, 0.9, 1.0, 1.7, -0.3])
    def test_one_tag_matches_jax(self, monkeypatch, aug):
        _jax_draws(monkeypatch)
        emb = np.random.default_rng(18).normal(size=(2, 24)).astype(np.float32)
        tag = {"embeds": emb, "noise_augmentation": aug, "strength": 0.8}
        want = np.asarray(ju.unclip_adm([{**tag, "embeds": jnp.asarray(emb)}], 64))
        got = pu.unclip_adm([tag], 64, device="cpu")
        assert got.shape == (1, 64) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        # The level and its embedding: round(999·aug), aug clamped to [0, 1].
        level = round(999 * min(max(aug, 0.0), 1.0))
        noise = pu.unclip_noise(None, 0, (1, 24), "cpu")
        noised, lvl_emb = pu.unclip_augment(torch.from_numpy(emb[:1]), aug, noise, 40)
        a = pu.unclip_alphas_cumprod()[level]
        torch.testing.assert_close(noised, a.sqrt() * torch.from_numpy(emb[:1])
                                   + (1 - a).sqrt() * noise)
        torch.testing.assert_close(lvl_emb, pu.timestep_embedding(torch.tensor([float(level)]),
                                                                  40))
        torch.testing.assert_close(got, 0.8 * torch.cat([noised, lvl_emb], dim=-1))

    def test_two_tags_re_augment_at_the_merge_level(self, monkeypatch):
        _jax_draws(monkeypatch)
        rng = np.random.default_rng(19)
        tags = [{"embeds": rng.normal(size=(1, 24)).astype(np.float32),
                 "noise_augmentation": 0.1, "strength": 1.0},
                {"embeds": rng.normal(size=(24,)).astype(np.float32),
                 "noise_augmentation": 0.6, "strength": 0.5}]
        want = np.asarray(ju.unclip_adm(
            [{**t, "embeds": jnp.asarray(t["embeds"])} for t in tags], 64, merge_augmentation=0.2))
        got = pu.unclip_adm(tags, 64, merge_augmentation=0.2, device="cpu")
        # Numpy embeds and no device: the card, which this machine may not have.
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError):
                pu.unclip_adm(tags, 64)
        np.testing.assert_allclose(got.numpy(), want, **TOL)

    def test_alpha_bar_table_and_seeded_draws(self):
        n = 1000
        t = np.arange(n, dtype=np.float64)

        def bar(s):
            return np.cos((s + 0.008) / 1.008 * np.pi / 2.0) ** 2

        want = np.cumprod(1.0 - np.clip(1.0 - bar((t + 1) / n) / bar(t / n), 0.0, 0.999))
        np.testing.assert_allclose(pu.unclip_alphas_cumprod().numpy(), want, rtol=1e-6,
                                   atol=0)
        tags = [{"embeds": torch.ones((1, 24)), "noise_augmentation": 0.5}]
        a = pu.unclip_adm(tags, 64, generator=torch.Generator().manual_seed(3))
        b = pu.unclip_adm(tags, 64, generator=torch.Generator().manual_seed(3))
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        torch.testing.assert_close(pu.unclip_adm(tags, 64), pu.unclip_adm(tags, 64), rtol=0,
                                   atol=0)
