"""The port's nodes (``nodes.py``) one by one against the JAX package's, on the tiny
SD1.5 world of ``test_torch_graphs_sd15`` (the same files, the same patched configs
and injected noise): the checkpoint and CLIP loaders read the same safetensors
files into the same weights (exactly, through ``convert_jax``), the int8 load keeps
int8 on the device; text encode (with an embed-cache hit that skips the encoder),
the latent, VAE, upscale and mask nodes, conditioning combine, the custom-sampling
nodes, ControlNet apply and inpaint conditioning agree at f32 rtol/atol 2e-4;
``TPUKSampler`` / ``TPUKSamplerAdvanced`` on the same noise (non-ancestral
samplers) at the graph tests' 1e-3; ``_shift_from_prefs`` and the seed semantics.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import test_torch_graphs_sd15 as g  # noqa: E402
from comfyui_parallelanything_tpu import nodes as jn  # noqa: E402
from comfyui_parallelanything_tpu_torch import nodes as pn  # noqa: E402
from comfyui_parallelanything_tpu_torch.models.convert_jax import (  # noqa: E402
    from_jax_text_params,
    from_jax_unet_params,
    from_jax_vae_params,
)

TOL = dict(rtol=2e-4, atol=2e-4)
INITIAL_NOISE = pn.initial_noise  # the world below patches it for the parity tests


@pytest.fixture(scope="module")
def graph_env(tmp_path_factory):
    """The graph tests' world, built once for the module (so the JAX programs of the
    loaded models compile once too)."""
    with pytest.MonkeyPatch.context() as mp:
        yield g.build_graph_env(str(tmp_path_factory.mktemp("world")), mp)


def close(got, want, tol=TOL, what=""):
    g.assert_close(got, want, what, tol)


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def loaded(graph_env):
    """Both packages' loader nodes on the same files: (port, JAX) MODEL, VAE, CLIP."""
    pm, pv = pn.TPUCheckpointLoader().load(graph_env["ckpt"], "sd15", device="cpu")
    jm, jv = jn.TPUCheckpointLoader().load(graph_env["ckpt"], "sd15")
    clip_kw = dict(encoder_type="clip-l", vocab_path=graph_env["vocab"],
                   merges_path=graph_env["merges"], max_len=g.CLIP["max_len"])
    (pc,) = pn.TPUCLIPLoader().load(graph_env["clip"], device="cpu", **clip_kw)
    (jc,) = jn.TPUCLIPLoader().load(graph_env["clip"], **clip_kw)
    return (pm, pv, pc), (jm, jv, jc)


def _same_state(got: dict, want: dict):
    assert set(got) == set(want)
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)


def test_loaders_read_the_same_weights(graph_env, loaded):
    (pm, pv, pc), (jm, jv, jc) = loaded
    _same_state(pm.module.state_dict(), from_jax_unet_params(_np_tree(jm.params)))
    _same_state(pv.module.state_dict(), from_jax_vae_params(_np_tree(jv.params)))
    _same_state(pc["encoder"].module.state_dict(),
                from_jax_text_params(_np_tree(jc["encoder"].params)))
    assert pc["model_key"] == jc["model_key"]  # the embed cache's key, same recipe
    assert pc["tokenizer"](["a lighthouse"])[0].tolist() == \
        np.asarray(jc["tokenizer"](["a lighthouse"])[0]).tolist()


def test_int8_load_keeps_int8_on_the_device(graph_env, loaded):
    (pm, _, _), _ = loaded
    qm, qv = pn.TPUCheckpointLoader().load(graph_env["ckpt"], "sd15", quantize="int8",
                                           device="cpu")
    assert qv is not None
    int8 = [p for p in qm.module.parameters() if p.dtype == torch.int8]
    assert int8 and all(p.device.type == "cpu" for p in qm.module.parameters())
    from comfyui_parallelanything_tpu_torch.models.quantize import param_bytes

    assert param_bytes(qm.module) < param_bytes(pm.module)
    with pytest.raises(NotImplementedError, match="item 10"):
        pn.TPUCheckpointLoader().load(graph_env["ckpt"], "wan-1.3b", device="cpu")


def test_text_encode_matches_and_a_cache_hit_skips_the_encoder(loaded):
    from comfyui_parallelanything_tpu_torch.models import embed_cache

    (_, _, pc), (_, _, jc) = loaded
    embed_cache.cache.clear()
    (got,) = pn.TPUTextEncode().encode(pc, "a watercolor lighthouse")
    (want,) = jn.TPUTextEncode().encode(jc, "a watercolor lighthouse")
    for k in ("context", "penultimate", "pooled"):
        close(got[k], want[k], what=k)
    (skip2,) = pn.TPUTextEncode().encode(pc, "a watercolor lighthouse", clip_skip=2)
    close(skip2["context"], want["penultimate"], what="clip_skip 2")
    calls = []
    enc = pc["encoder"]
    real = type(enc).__call__
    type(enc).__call__ = lambda self, *a, **k: calls.append(1) or real(self, *a, **k)
    try:
        (again,) = pn.TPUTextEncode().encode(pc, "a watercolor lighthouse")
        assert not calls and again["context"] is got["context"]  # banked, not recomputed
        pn.TPUTextEncode().encode(pc, "a different prompt")
        assert calls == [1]
    finally:
        type(enc).__call__ = real
        embed_cache.cache.clear()


def test_latent_nodes_match(graph_env):
    (got,) = pn.TPUEmptyLatent().generate(24, 16, 3, device="cpu")
    (want,) = jn.TPUEmptyLatent().generate(24, 16, 3)
    close(got["samples"], want["samples"])
    lat = np.random.default_rng(1).standard_normal((2, 6, 4, 4)).astype(np.float32)
    mask = (np.random.default_rng(2).uniform(size=(2, 3, 2)) > 0.5).astype(np.float32)
    (pmask,) = pn.TPUSetLatentNoiseMask().set_mask({"samples": torch.from_numpy(lat)}, mask)
    (jmask,) = jn.TPUSetLatentNoiseMask().set_mask({"samples": jnp.asarray(lat)}, mask)
    close(pmask["noise_mask"], jmask["noise_mask"], what="noise_mask")
    for method in ("bilinear", "nearest", "lanczos3"):
        (pu,) = pn.TPULatentUpscale().upscale(pmask, 1.5, method)
        (ju,) = jn.TPULatentUpscale().upscale(jmask, 1.5, method)
        close(pu["samples"], ju["samples"], what=method)
        close(pu["noise_mask"], ju["noise_mask"], what=method)
    (pw,) = pn.TPULatentUpscale().upscale(pmask, 2.0, scale_w=0.5)
    assert pw["samples"].shape == (2, 12, 2, 4)
    img = np.random.default_rng(3).uniform(size=(1, 10, 12, 3)).astype(np.float32)
    for method in ("bilinear", "lanczos3"):
        (ps,) = pn.TPUImageScale().scale(torch.from_numpy(img), 16, 8, method)
        (js,) = jn.TPUImageScale().scale(jnp.asarray(img), 16, 8, method)
        close(ps, js, what=method)


def test_vae_and_inpaint_nodes_match(loaded):
    (_, pv, _), (_, jv, _) = loaded
    img = np.random.default_rng(4).uniform(size=(1, 16, 16, 3)).astype(np.float32)
    # The posterior mean; the seeded draw runs in test_torch_graphs_img2img.py.
    (pe,) = pn.TPUVAEEncode().encode(pv, torch.from_numpy(img))
    (je,) = jn.TPUVAEEncode().encode(jv, jnp.asarray(img))
    close(pe["samples"], je["samples"], what="encode")
    (pd,) = pn.TPUVAEDecode().decode(pv, pe)
    (jd,) = jn.TPUVAEDecode().decode(jv, je)
    close(pd, jd, what="decode")
    mask = np.zeros((1, 16, 16), np.float32)
    mask[:, 4:12, 2:9] = 1.0
    neg = {"context": torch.zeros(1, 2, 3)}
    pp, pneg, plat = pn.TPUInpaintModelConditioning().encode(
        {"context": torch.ones(1, 2, 3)}, neg, pv, torch.from_numpy(img), torch.from_numpy(mask))
    jp, _, jlat = jn.TPUInpaintModelConditioning().encode(
        {"context": jnp.ones((1, 2, 3))}, {"context": jnp.zeros((1, 2, 3))}, jv,
        jnp.asarray(img), jnp.asarray(mask))
    close(plat["samples"], jlat["samples"], what="inpaint latent")
    close(plat["noise_mask"], jlat["noise_mask"], what="inpaint mask")
    for k in ("mask", "masked_latent"):
        close(pp["inpaint"][k], jp["inpaint"][k], what=k)
    assert pneg["inpaint"] is pp["inpaint"]


def test_conditioning_combine_matches():
    rng = np.random.default_rng(5)

    def cond(width, pooled):
        c = {"context": rng.standard_normal((1, 4, width)).astype(np.float32),
             "penultimate": rng.standard_normal((1, 4, width)).astype(np.float32),
             "pooled": rng.standard_normal((1, pooled)).astype(np.float32)}
        return c, {k: torch.from_numpy(v) for k, v in c.items()}

    (jl, pl), (jg, pg), (jt, pt) = cond(768, 768), cond(1280, 1280), cond(4096, 8)
    for mode, c in (("sdxl", None), ("flux", None), ("sd3", (jt, pt))):
        a, b = ((jt, pt), (jl, pl)) if mode == "flux" else ((jl, pl), (jg, pg))
        (got,) = pn.TPUConditioningCombine().combine(a[1], b[1], mode, width=832, height=1216,
                                                     conditioning_c=c and c[1])
        (want,) = jn.TPUConditioningCombine().combine(
            {k: jnp.asarray(v) for k, v in a[0].items()},
            {k: jnp.asarray(v) for k, v in b[0].items()}, mode, width=832, height=1216,
            conditioning_c=c and {k: jnp.asarray(v) for k, v in c[0].items()})
        close(got["context"], want["context"], what=mode)
        close(got["pooled"], want["pooled"], what=mode)


class _Flow:
    model_config = type("Cfg", (), {"prediction": "flow"})()


class _Eps:
    model_config = type("Cfg", (), {"prediction": "eps"})()


def test_custom_sampling_nodes_match():
    for model in (_Eps(), _Flow()):
        for sched, steps, denoise in (("karras", 6, 1.0), ("normal", 5, 0.6)):
            (ps,) = pn.TPUBasicScheduler().get_sigmas(model, sched, steps, denoise, shift=3.0)
            (js,) = jn.TPUBasicScheduler().get_sigmas(model, sched, steps, denoise, shift=3.0)
            close(ps, js, dict(rtol=1e-6, atol=1e-6), what=f"{sched} {steps}")
    (hi, lo) = pn.TPUSplitSigmas().split(ps, 3)
    (jhi, jlo) = jn.TPUSplitSigmas().split(js, 3)
    close(hi, jhi)
    close(lo, jlo)
    (pf,) = pn.TPUFlipSigmas().flip(ps)
    (jf,) = jn.TPUFlipSigmas().flip(js)
    close(pf, jf, dict(rtol=1e-6, atol=1e-6))
    assert float(ps[-1]) == 0.0 and float(pf[0]) == pytest.approx(1e-4)
    assert pn.TPURandomNoise().get_noise(9) == jn.TPURandomNoise().get_noise(9)
    assert pn.TPUDisableNoise().get_noise() == jn.TPUDisableNoise().get_noise()
    assert pn.TPUKSamplerSelect().get_sampler("heun") == jn.TPUKSamplerSelect().get_sampler("heun")
    c = {"context": 1}
    assert pn.TPUFluxGuidance().append(c, 2.5) == jn.TPUFluxGuidance().append(c, 2.5)
    assert pn.TPUCFGGuider().get_guider("m", c, c, 6) == jn.TPUCFGGuider().get_guider("m", c, c, 6)
    assert pn.TPUBasicGuider().get_guider("m", c) == jn.TPUBasicGuider().get_guider("m", c)


def test_controlnet_apply_stacks_like_jax():
    img = np.ones((8, 8, 3), np.float32)
    (p1,) = pn.TPUControlNetApply().apply({"context": 0}, {"model": "a"}, torch.from_numpy(img),
                                          0.5, 0.1, 0.9)
    (p2,) = pn.TPUControlNetApply().apply(p1, {"model": "b"}, torch.from_numpy(img))
    (j1,) = jn.TPUControlNetApply().apply({"context": 0}, {"model": "a"}, jnp.asarray(img),
                                          0.5, 0.1, 0.9)
    (j2,) = jn.TPUControlNetApply().apply(j1, {"model": "b"}, jnp.asarray(img))
    assert [s["model"] for s in p2["control"]] == [s["model"] for s in j2["control"]]
    for ps, js in zip(p2["control"], j2["control"]):
        assert {k: v for k, v in ps.items() if k != "hint"} == \
            {k: v for k, v in js.items() if k != "hint"}
        assert tuple(ps["hint"].shape) == tuple(js["hint"].shape) == (1, 8, 8, 3)
    assert pn._collect_control(p2) == p2["control"]


def test_shift_and_cfg_rescale_come_from_sampler_prefs():
    class M:
        sampler_prefs = {"shift": 3.0, "cfg_rescale": 0.5}

    for shift in (1.15, 2.0):
        assert pn._shift_from_prefs(M(), shift) == jn._shift_from_prefs(M(), shift)
    assert pn._shift_from_prefs(M(), 1.15) == 3.0 and pn._shift_from_prefs(M(), 2.0) == 2.0
    assert pn._shift_from_prefs(object(), 1.15) == 1.15
    # The flow schedule node reads the shift the same way.
    flow = _Flow()
    flow.sampler_prefs = {"shift": 3.0}
    (a,) = pn.TPUBasicScheduler().get_sigmas(flow, "normal", 4, 1.0)
    (b,) = pn.TPUBasicScheduler().get_sigmas(_Flow(), "normal", 4, 1.0, shift=3.0)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_samplers_match_jax_on_the_same_noise(loaded):
    (pm, _, _), (jm, _, _) = loaded
    rng = np.random.default_rng(6)
    ctx = rng.standard_normal((1, 5, g.CLIP["hidden_size"])).astype(np.float32)
    uctx = rng.standard_normal((1, 5, g.CLIP["hidden_size"])).astype(np.float32)
    lat = rng.standard_normal((1, 4, 4, 4)).astype(np.float32)
    pos, neg = {"context": torch.from_numpy(ctx)}, {"context": torch.from_numpy(uctx)}
    jpos, jneg = {"context": jnp.asarray(ctx)}, {"context": jnp.asarray(uctx)}
    kw = dict(seed=3, steps=2, cfg=5.0, sampler_name="dpmpp_2m", scheduler="karras")
    (got,) = pn.TPUKSampler().sample(pm, pos, {"samples": torch.from_numpy(lat)}, negative=neg,
                                     denoise=0.7, **kw)
    (want,) = jn.TPUKSampler().sample(jm, jpos, {"samples": jnp.asarray(lat)}, negative=jneg,
                                      denoise=0.7, **kw)
    close(got["samples"], want["samples"], g.TOL, "KSampler")
    adv = dict(add_noise="enable", noise_seed=3, steps=4, cfg=5.0, sampler_name="euler",
               scheduler="normal", start_at_step=1, end_at_step=3,
               return_with_leftover_noise="disable")
    (got,) = pn.TPUKSamplerAdvanced().sample(pm, positive=pos, negative=neg,
                                             latent_image={"samples": torch.from_numpy(lat)},
                                             **adv)
    (want,) = jn.TPUKSamplerAdvanced().sample(jm, positive=jpos, negative=jneg,
                                              latent_image={"samples": jnp.asarray(lat)}, **adv)
    close(got["samples"], want["samples"], g.TOL, "KSamplerAdvanced")


def test_seed_noise_is_the_same_on_every_device_and_differs_by_seed():
    # Drawn on the host from the seed, then moved: one seed, one noise, wherever the
    # latent lives (here the CPU stand-ins ``cpu`` and ``cpu:1``).
    noise = INITIAL_NOISE
    a = noise(42, (1, 4, 4, 4), pn.resolve_device("cpu"))
    b = noise(42, (1, 4, 4, 4), pn.resolve_device("cpu:1"))
    c = noise(43, (1, 4, 4, 4), pn.resolve_device("cpu"))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.allclose(a, c)
    # The stock 64-bit seed range folds into the generator's signed one.
    torch.testing.assert_close(noise(2**64 - 1, (3,), "cpu"), noise(2**63 - 1, (3,), "cpu"),
                               rtol=0, atol=0)
    if torch.cuda.is_available():
        torch.testing.assert_close(noise(42, (1, 4, 4, 4), "cuda:0").cpu(), a)


def test_node_names_are_the_jax_packages():
    from comfyui_parallelanything_tpu_torch import NODE_CLASS_MAPPINGS, NODE_DISPLAY_NAME_MAPPINGS

    from comfyui_parallelanything_tpu_torch import nodes_compat

    left_out = {"TPUEmptyVideoLatent"}  # the Wan family, ROADMAP Queue 1 item 10
    # Every JAX name, native and stock (nodes_compat's shims); the Wan shims that
    # raise count as registered.
    names = set(jn.NODE_CLASS_MAPPINGS) - left_out
    assert set(NODE_CLASS_MAPPINGS) == names
    assert {k: jn.NODE_DISPLAY_NAME_MAPPINGS[k] for k in names} == NODE_DISPLAY_NAME_MAPPINGS
    stock = set(nodes_compat.stock_node_mappings())
    assert len(stock) == 107
    # Native names win over a shim of the same name.
    for name in names - stock:
        assert NODE_CLASS_MAPPINGS[name].__module__ == pn.__name__, name
    for name, cls in NODE_CLASS_MAPPINGS.items():
        jcls = jn.NODE_CLASS_MAPPINGS[name]
        assert (cls.RETURN_TYPES, cls.FUNCTION) == (jcls.RETURN_TYPES, jcls.FUNCTION), name
        pin, jin = cls.INPUT_TYPES(), jcls.INPUT_TYPES()
        for group in ("required", "optional"):
            assert set(pin.get(group, {})) == set(jin.get(group, {})), (name, group)
