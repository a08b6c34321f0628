"""Parity of the PyTorch port's ``run_sampler`` (flow_euler) and ``FluxPipeline``
against the JAX package on the CPU, on the tiny FLUX pipeline of
``tests/test_pipelines.py`` (FLUX 1 + 1 blocks of width 32, CLIP 2 × 48, T5 2 × 32,
a 2-level 16-channel VAE).

Both sides take the same numpy weights (made from a seed for the JAX models'
abstract parameter trees), the port through ``convert_jax``; the tokenizers share
one vocab. The pipeline's initial noise is the one ``jax.random.normal`` drew,
patched into ``pipelines.initial_noise`` (torch's generators cannot reproduce
JAX's keys). Both sides run in f32 (the JAX side under the suite's ``highest``
matmul precision) and must agree to rtol/atol 2e-4.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from comfyui_parallelanything_tpu import pipelines as jpipe  # noqa: E402
from comfyui_parallelanything_tpu.models import flux as jflux  # noqa: E402
from comfyui_parallelanything_tpu.models import text_encoders as jte  # noqa: E402
from comfyui_parallelanything_tpu.models import vae as jvae  # noqa: E402
from comfyui_parallelanything_tpu.sampling.runner import (  # noqa: E402
    run_sampler as jax_run_sampler,
)
from comfyui_parallelanything_tpu_torch import parallelize  # noqa: E402
from comfyui_parallelanything_tpu_torch import pipelines as ppipe  # noqa: E402
from comfyui_parallelanything_tpu_torch.models import flux as pflux  # noqa: E402
from comfyui_parallelanything_tpu_torch.models import text_encoders as pte  # noqa: E402
from comfyui_parallelanything_tpu_torch.models import vae as pvae  # noqa: E402
from comfyui_parallelanything_tpu_torch.models.convert_jax import (  # noqa: E402
    from_jax_params,
    from_jax_text_params,
    from_jax_vae_params,
)
from comfyui_parallelanything_tpu_torch.sampling.runner import run_sampler  # noqa: E402
from comfyui_parallelanything_tpu_torch.utils.tokenizer import CLIPBPETokenizer  # noqa: E402

from test_tokenizer import _tiny_tokenizer  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
CLIP = dict(vocab_size=64, hidden_size=48, num_layers=2, num_heads=4, max_len=8,
            projection_dim=16)
T5 = dict(vocab_size=64, d_model=32, num_layers=2, num_heads=4, d_kv=8, d_ff=64)
FLUX = dict(in_channels=64, hidden_size=32, num_heads=2, depth=1, depth_single_blocks=1,
            context_in_dim=32, vec_in_dim=16, axes_dim=(4, 6, 6), guidance_embed=True)
VAE = dict(z_channels=16, base_channels=32, channel_mult=(1, 2), num_res_blocks=1,
           norm_groups=8, use_quant_conv=False)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _numpy_tree(abstract, seed, conv=False):
    """Random weights for an abstract flax tree (no JAX init is run): kernels
    N(0, 1/fan_in) (``conv``: every kernel is a convolution's (kh, kw, in, out)),
    tables N(0, 1), vectors off their init values."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(a.shape[:-1])) if conv else a.shape[0]
            return jnp.asarray(rng.normal(size=a.shape) / np.sqrt(fan_in), jnp.float32)
        base = 1.0 if name in ("scale", "query_norm", "key_norm") else 0.0
        spread = 0.1 if a.ndim == 1 else 1.0
        return jnp.asarray(base + spread * rng.normal(size=a.shape), jnp.float32)

    return jax.tree_util.tree_map_with_path(leaf, abstract)


def _abstract(module, *sample):
    return jax.eval_shape(module.init, jax.random.key(0), *sample)["params"]


@pytest.fixture(scope="module")
def pipes():
    jtok = _tiny_tokenizer()
    merges = sorted(jtok.ranks, key=jtok.ranks.get)
    ptok = CLIPBPETokenizer(jtok.vocab, merges, max_len=8)
    f32 = dict(dtype=jnp.float32)
    fcfg = jflux.FluxConfig(**FLUX, **f32)
    jdit = jflux.build_flux(fcfg, params=_numpy_tree(
        jflux.flux_abstract_params(fcfg, sample_shape=(1, 8, 8, 16), txt_len=8), 0))
    vcfg = jvae.VAEConfig(**VAE, **f32)
    jv = jvae.build_vae(vcfg, params=_numpy_tree(
        _abstract(jvae.AutoencoderKL(vcfg), jnp.zeros((1, 16, 16, 3))), 1, conv=True))
    ccfg = jte.CLIPTextConfig(**CLIP, eos_id=jtok.eos_id, **f32)
    jclip = jte.build_clip_text(ccfg, params=_numpy_tree(
        _abstract(jte.CLIPTextModel(ccfg), jnp.zeros((1, 8), jnp.int32)), 2))
    tcfg = jte.T5Config(**T5, **f32)
    jt5 = jte.build_t5_encoder(tcfg, params=_numpy_tree(
        _abstract(jte.T5Encoder(tcfg), jnp.zeros((1, 8), jnp.int32)), 3))
    jp = jpipe.FluxPipeline(dit=jdit, vae=jv, clip=jclip, t5=jt5, tokenizer=jtok,
                            t5_tokenizer=jtok)
    cpu = dict(device="cpu")
    pdit = pflux.build_flux(pflux.FluxConfig(**FLUX, dtype=torch.float32),
                            state_dict=from_jax_params(_np(jdit.params)), **cpu)
    pv = pvae.build_vae(pvae.VAEConfig(**VAE, dtype=torch.float32),
                        state_dict=from_jax_vae_params(_np(jv.params)), **cpu)
    pclip = pte.build_clip_text(
        pte.CLIPTextConfig(**CLIP, eos_id=ptok.eos_id, dtype=torch.float32),
        state_dict=from_jax_text_params(_np(jclip.params)), **cpu)
    pt5 = pte.build_t5_encoder(pte.T5Config(**T5, dtype=torch.float32),
                               state_dict=from_jax_text_params(_np(jt5.params)), **cpu)
    pp = ppipe.FluxPipeline(dit=parallelize(pdit, [("cpu", 100)]), vae=pv, clip=pclip,
                            t5=pt5, tokenizer=ptok, t5_tokenizer=ptok)
    return jp, pp


def _jax_noise(key, shape):
    return np.array(jax.random.normal(key, shape, jnp.float32))


@pytest.fixture
def jax_noise(monkeypatch):
    """Patch the port's noise draw with JAX's draw from key(0) (the JAX pipeline's
    default) at the requested shape; returns the generators the port passed."""
    seen = []

    def patched(shape, generator, device):
        seen.append(generator)
        return torch.from_numpy(_jax_noise(jax.random.key(0), shape)).to(device)

    monkeypatch.setattr(ppipe, "initial_noise", patched)
    return seen


def _image(seed, shape=(1, 16, 16, 3)):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


class TestFluxPipeline:
    @pytest.mark.parametrize(
        "kw",
        [dict(steps=2, guidance=3.5), dict(steps=1, guidance=None),
         dict(steps=1, guidance=None, negative_prompt="world", cfg_scale=3.0)],
        ids=["txt2img", "schnell-no-guidance", "true-cfg"],
    )
    def test_prompt_to_image_matches_jax(self, pipes, jax_noise, kw):
        jp, pp = pipes
        want = np.asarray(jp("hello world", height=16, width=16, **kw))
        got = pp("hello world", height=16, width=16, **kw)
        assert jax_noise == [None]
        assert got.shape == (1, 16, 16, 3) and got.dtype == torch.float32
        assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0
        np.testing.assert_allclose(got.numpy(), want, **TOL)

    def test_img2img_and_inpaint_match_jax(self, pipes, jax_noise, monkeypatch):
        jp, pp = pipes
        init = _image(1)
        kw = dict(height=16, width=16, steps=2, init_image=init)
        want = np.asarray(jp("hello", denoise=0.5, **{**kw, "init_image": jnp.asarray(init)}))
        got = pp("hello", denoise=0.5, **kw)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        mask = (np.arange(16)[None, :, None] < 8).repeat(16, axis=2).astype(np.float32)
        want_inpaint = np.asarray(jp("hello", mask=jnp.asarray(mask), **{**kw,
                                     "init_image": jnp.asarray(init)}))
        got = pp("hello", mask=mask, **kw)
        np.testing.assert_allclose(got.numpy(), want_inpaint, **TOL)
        # A batch-1 init serves every prompt of a batch (both rows get the batch-1 noise).
        one = torch.from_numpy(_jax_noise(jax.random.key(0), (1, 8, 8, 16)))
        monkeypatch.setattr(ppipe, "initial_noise", lambda shape, g, d: one.repeat(2, 1, 1, 1))
        two = pp(["hello", "hello"], denoise=0.5, **kw)
        np.testing.assert_allclose(two.numpy(), np.concatenate([want, want]), **TOL)

    def test_contracts(self, pipes):
        _, pp = pipes
        with pytest.raises(ValueError, match="multiples of 4"):
            pp("hello", steps=1, height=14, width=16)
        with pytest.raises(ValueError, match="denoise < 1"):
            pp("hello", steps=1, height=16, width=16, denoise=0.5)
        with pytest.raises(ValueError, match="denoise=1.0"):
            pp("hello", steps=1, height=16, width=16, init_image=_image(2))
        with pytest.raises(ValueError, match="requires init_image"):
            pp("hello", steps=1, height=16, width=16, mask=np.ones((1, 16, 16)))
        with pytest.raises(ValueError, match="negative_prompt"):
            pp(["a", "b"], negative_prompt=["n"], cfg_scale=2.0, steps=1, height=16,
               width=16)
        with pytest.raises(ValueError, match="is \\(8, 16\\)"):
            pp("hello", steps=1, height=16, width=16, denoise=0.5,
               init_image=_image(3, (1, 8, 16, 3)))

    def test_default_noise_is_seeded(self, pipes):
        gen = torch.Generator().manual_seed(0)
        want = torch.randn((1, 8, 8, 16), generator=gen)
        got = ppipe.initial_noise((1, 8, 8, 16), None, "cpu")
        assert got.dtype == torch.float32 and torch.equal(got, want)


@pytest.fixture(scope="module")
def dits(pipes):
    jp, pp = pipes
    return jp.dit, pp.dit


def _latents(seed, batch=1):
    rng = np.random.default_rng(seed)
    noise = rng.normal(size=(batch, 8, 8, 16)).astype(np.float32)
    ctx = rng.normal(size=(batch, 8, 32)).astype(np.float32)
    y = rng.normal(size=(batch, 16)).astype(np.float32)
    init = rng.normal(size=(batch, 8, 8, 16)).astype(np.float32)
    return noise, ctx, y, init


class TestRunSampler:
    @pytest.mark.parametrize(
        "kw",
        [dict(steps=3, shift=1.15, guidance=3.5),
         dict(steps=2, denoise=0.6, init=True),
         dict(steps=2, denoise=0.5, init=True, mask=True),
         dict(steps=2, denoise=1.0, init=True, mask=True),
         dict(steps=2, sigmas=[0.9, 0.4, 0.0]),
         dict(steps=2, sigmas=[0.7, 0.3, 0.0], init=True),
         dict(steps=2, cfg=True)],
        ids=["txt2img", "img2img", "inpaint", "inpaint-full-denoise", "sigmas",
             "sigmas-init", "cfg-uncond-y"],
    )
    def test_flow_euler_matches_jax(self, dits, kw):
        jdit, pdit = dits
        noise, ctx, y, init = _latents(5)
        T = torch.from_numpy
        common = dict(sampler="flow_euler", steps=kw["steps"], shift=kw.get("shift", 1.0),
                      guidance=kw.get("guidance"), denoise=kw.get("denoise", 1.0))
        jkw, pkw = dict(common), dict(common)
        if "sigmas" in kw:
            jkw["sigmas"] = jnp.asarray(kw["sigmas"])
            pkw["sigmas"] = kw["sigmas"]
        if kw.get("init"):
            jkw["init_latent"], pkw["init_latent"] = jnp.asarray(init), T(init)
        if kw.get("mask"):
            m = (np.arange(8)[None, :, None, None] < 5).astype(np.float32)
            jkw["latent_mask"], pkw["latent_mask"] = jnp.asarray(m), T(m)
        if kw.get("cfg"):
            unc = _latents(6)
            jkw.update(cfg_scale=2.5, uncond_context=jnp.asarray(unc[1]),
                       uncond_kwargs={"y": jnp.asarray(unc[2])})
            pkw.update(cfg_scale=2.5, uncond_context=T(unc[1]), uncond_kwargs={"y": T(unc[2])})
        seen = []
        want = np.asarray(jax_run_sampler(jdit, jnp.asarray(noise), jnp.asarray(ctx),
                                          y=jnp.asarray(y), **jkw))
        got = run_sampler(pdit, T(noise), T(ctx), y=T(y),
                          callback=lambda i, x: seen.append(i), **pkw)
        assert seen == list(range(kw["steps"]))
        np.testing.assert_allclose(got.numpy(), want, **TOL)

    def test_what_is_not_ported_raises(self, dits):
        # Every sampler name runs now (tests/test_torch_samplers.py), and so does the
        # whole-loop compiled path (on the CPU the same loop body, uncaptured: equal
        # to the eager loop) and per-request LoRA (the merged model drives the loop);
        # combined conditioning on flow_euler is refused as the JAX runner refuses it.
        _, pdit = dits
        noise, ctx, y, init = (torch.from_numpy(a) for a in _latents(7))
        base = dict(steps=1, y=y)
        for sampler in ("flow_euler", "dpmpp_2m"):
            np.testing.assert_array_equal(
                run_sampler(pdit, noise, ctx, sampler=sampler, compile_loop=True, **base).numpy(),
                run_sampler(pdit, noise, ctx, sampler=sampler, **base).numpy())
        from comfyui_parallelanything_tpu_torch.models.lora import lora_model

        w = pdit._lead_replica().img_in.weight
        lora = {"img_in.weight": (torch.full((1, w.shape[1]), 0.1), torch.ones(w.shape[0], 1))}
        np.testing.assert_array_equal(
            run_sampler(pdit, noise, ctx, sampler="flow_euler", lora=lora, **base).numpy(),
            run_sampler(lora_model(pdit, lora), noise, ctx, sampler="flow_euler", **base).numpy())
        for kw, match in ((dict(sampler="nope"), "unknown sampler"),
                          (dict(sampler="flow_euler", denoise=0.0), "denoise"),
                          (dict(sampler="flow_euler", latent_mask=noise), "init_latent"),
                          (dict(sampler="flow_euler", prediction="v"), "velocity"),
                          (dict(sampler="flow_euler", extra_conds=[{}]),
                           "k-sampler family only")):
            with pytest.raises(ValueError, match=match):
                run_sampler(pdit, noise, ctx, **base, **kw)


# --- StableDiffusionPipeline: tiny SD1.5 (eps), SD2 (v, penultimate) and SDXL
# (two towers, pooled + size vector) UNets of two levels; the pipelines share the
# FLUX pipelines' CLIP (also as SDXL's second tower) and one 4-channel VAE, so
# JAX compiles each encoder once.
SD_VAE = dict(VAE, z_channels=4, use_quant_conv=True)
SD_UNET = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=1, attention_levels=(1,),
               transformer_depth=(0, 1), norm_groups=8)
SD_CONFIGS = {
    "sd15": dict(SD_UNET, num_heads=4, context_dim=48),
    "sd2-v": dict(SD_UNET, num_heads=-1, context_dim=48, prediction="v"),
    # OpenCLIP-G penultimate ⊕ CLIP-L penultimate (48 + 48), pooled (16) ⊕ 6 × 256.
    "sdxl": dict(SD_UNET, num_heads=-1, context_dim=96, adm_in_channels=16 + 6 * 256),
}


@pytest.fixture(scope="module")
def sd_pipes(pipes):
    from comfyui_parallelanything_tpu.models import unet as junet
    from comfyui_parallelanything_tpu_torch.models import unet as punet
    from comfyui_parallelanything_tpu_torch.models.convert_jax import from_jax_unet_params

    jflux, pflux = pipes
    vcfg = jvae.VAEConfig(**SD_VAE, dtype=jnp.float32)
    jv = jvae.build_vae(vcfg, params=_numpy_tree(
        _abstract(jvae.AutoencoderKL(vcfg), jnp.zeros((1, 16, 16, 3))), 11, conv=True))
    pv = pvae.build_vae(pvae.VAEConfig(**SD_VAE, dtype=torch.float32), device="cpu",
                        state_dict=from_jax_vae_params(_np(jv.params)))
    out = {}
    for i, (name, kw) in enumerate(SD_CONFIGS.items()):
        jcfg = junet.UNetConfig(**kw, dtype=jnp.float32)
        y = (jnp.zeros((1, jcfg.adm_in_channels)),) if jcfg.adm_in_channels else ()
        tree = _numpy_tree(_abstract(junet.UNet2D(jcfg), jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)),
                                     jnp.zeros((1, 8, jcfg.context_dim)), *y), 20 + i, conv=True)
        ju = junet.build_unet(jcfg, params=tree)
        pu = punet.build_unet(punet.UNetConfig(**kw, dtype=torch.float32), device="cpu",
                              state_dict=from_jax_unet_params(_np(tree)))
        towers = dict(clip_layer="penultimate") if name == "sd2-v" else {}
        jg = dict(clip_g=jflux.clip, tokenizer_g=jflux.tokenizer) if name == "sdxl" else {}
        pg = dict(clip_g=pflux.clip, tokenizer_g=pflux.tokenizer) if name == "sdxl" else {}
        out[name] = (
            jpipe.StableDiffusionPipeline(unet=ju, vae=jv, clip=jflux.clip,
                                          tokenizer=jflux.tokenizer, **jg, **towers),
            ppipe.StableDiffusionPipeline(unet=parallelize(pu, [("cpu", 100)]), vae=pv,
                                          clip=pflux.clip, tokenizer=pflux.tokenizer, **pg,
                                          **towers))
    return out


class TestStableDiffusionPipeline:
    @pytest.mark.parametrize("name", list(SD_CONFIGS))
    def test_prompt_to_image_matches_jax(self, sd_pipes, jax_noise, name):
        jp, pp = sd_pipes[name]
        kw = dict(height=16, width=16, steps=2, cfg_scale=5.0)
        want = np.asarray(jp("hello world", "world", **kw))
        got = pp("hello world", "world", **kw)
        assert jax_noise == [None]
        assert got.shape == (1, 16, 16, 3) and got.dtype == torch.float32
        assert pp.is_sdxl == (name == "sdxl")
        np.testing.assert_allclose(got.numpy(), want, **TOL)

    def test_img2img_inpaint_and_ancestral_match_jax(self, sd_pipes, jax_noise, monkeypatch):
        from comfyui_parallelanything_tpu_torch.sampling import k_samplers as pk

        def jax_step_noise(rng, i, shape, like, part=0):
            key = jax.random.fold_in(jax.random.fold_in(jax.random.key(0), 1), i)
            return torch.from_numpy(np.array(jax.random.normal(key, shape, jnp.float32)))

        monkeypatch.setattr(pk, "step_noise", jax_step_noise)
        jp, pp = sd_pipes["sd15"]
        init = _image(4)
        mask = (np.arange(16)[None, :, None] < 8).repeat(16, axis=2).astype(np.float32)
        kw = dict(height=16, width=16, steps=2, cfg_scale=5.0)
        for call in (dict(denoise=0.5, sampler="euler_ancestral"),
                     dict(mask=mask, sampler="ddim", denoise=0.8),
                     dict(scheduler="beta", sampler="dpmpp_2m_sde")):
            init_kw = {} if "denoise" not in call and "mask" not in call else {"init_image": init}
            want = np.asarray(jp("hello", "", **kw, **{
                k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                for k, v in {**call, **init_kw}.items()}))
            got = pp("hello", "", **kw, **call, **init_kw)
            np.testing.assert_allclose(got.numpy(), want, **TOL)

    def test_contracts(self, sd_pipes):
        _, pp = sd_pipes["sd15"]
        with pytest.raises(ValueError, match="multiples of 2"):
            pp("hello", steps=1, height=15, width=16)
        with pytest.raises(ValueError, match="FluxPipeline"):
            pp("hello", steps=1, height=16, width=16, sampler="flow_euler")
        with pytest.raises(ValueError, match="clip_layer"):
            ppipe.StableDiffusionPipeline(unet=pp.unet, vae=pp.vae, clip=pp.clip,
                                          tokenizer=pp.tokenizer, clip_layer="x")(
                "hello", steps=1, height=16, width=16)
        with pytest.raises(ValueError, match="negative_prompt"):
            pp(["a", "b"], ["n"], steps=1, height=16, width=16)
