"""The port's stock-name shims that need no loaded model (``nodes_compat.py``)
against the JAX package's, on the same numpy inputs: the image, mask, latent,
conditioning, schedule and sampler-wire shims, and the model patches' tags.
Exact for masks, crops, flips, rotations, pads, batches, concats and tags; rtol/atol
1e-5 for resizes, blurs, sharpens, feathers, interpolations, blends and the
schedules. Also ``SaveLatent`` → ``LoadLatent`` (round trip, and files crossing
between the two packages in the stock NCHW layout), the file-reading shims
(``LoadImage``, ``LoadImageMask``), the save shims, ``SamplerCustom`` on a toy model
with injected noise, and FreeU's parameter sharing."""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_quick_jax import quick_jax_compiles  # noqa: E402,F401
from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from comfyui_parallelanything_tpu import nodes as jn  # noqa: E402
from comfyui_parallelanything_tpu_torch import nodes as pn  # noqa: E402
from comfyui_parallelanything_tpu_torch import nodes_compat as pc  # noqa: E402

EXACT = None
F32 = dict(rtol=1e-5, atol=1e-5)
RNG = np.random.default_rng(0)


def _u(*shape):
    return RNG.uniform(0, 1, shape).astype(np.float32)


def _n(*shape):
    return RNG.standard_normal(shape).astype(np.float32)


IMG = _u(2, 12, 16, 3)
IMG_SMALL = _u(1, 6, 8, 3)
MASK = (_u(2, 12, 16) > 0.5).astype(np.float32)
SOFT_MASK = _u(1, 6, 8)
LAT = _n(2, 6, 8, 4)
LAT_B = _n(1, 4, 5, 4)
LAT_MASK = _u(2, 6, 8, 1)
COND = {"context": _n(1, 5, 8), "pooled": _n(1, 6)}
COND_B = {"context": _n(1, 3, 8), "pooled": _n(1, 6)}


def lat(samples, mask=None):
    return {"samples": samples} if mask is None else {"samples": samples, "noise_mask": mask}


def _to(side, v):
    """Numpy leaves → the side's arrays (jnp or torch), through dicts/tuples."""
    if isinstance(v, np.ndarray):
        return jnp.asarray(v) if side == "jax" else torch.from_numpy(v.copy())
    if isinstance(v, dict):
        return {k: _to(side, x) for k, x in v.items()}
    if isinstance(v, tuple):
        return tuple(_to(side, x) for x in v)
    return v


def _np(v):
    if torch.is_tensor(v):
        return v.detach().cpu().numpy()
    if isinstance(v, jax.Array):
        return np.asarray(v)
    if isinstance(v, dict):
        return {k: _np(x) for k, x in v.items()}
    if isinstance(v, (tuple, list)):
        return type(v)(_np(x) for x in v)
    return v


def assert_same(got, want, tol, path="out"):
    got, want = _np(got), _np(want)
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            assert_same(got[k], want[k], tol, f"{path}.{k}")
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            assert_same(a, b, tol, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        got = np.asarray(got)
        assert got.shape == want.shape, (path, got.shape, want.shape)
        if tol is None:
            np.testing.assert_array_equal(got, want, err_msg=path)
        else:
            np.testing.assert_allclose(got, want, err_msg=path, **tol)
    else:
        assert got == want, (path, got, want)


# (case id, stock name, method kwargs (numpy leaves), tolerance, port-only kwargs)
CASES = [
    ("composite_mask", "ImageCompositeMasked",
     dict(destination=IMG, source=IMG_SMALL, x=5, y=3, mask=SOFT_MASK), F32, {}),
    ("composite_clip_edge", "ImageCompositeMasked",
     dict(destination=IMG, source=IMG_SMALL, x=12, y=9), F32, {}),
    ("composite_resize", "ImageCompositeMasked",
     dict(destination=IMG, source=IMG_SMALL, x=0, y=0, resize_source=True, mask=MASK), F32, {}),
    ("latent_composite_feather", "LatentComposite",
     dict(samples_to=lat(LAT), samples_from=lat(LAT_B), x=8, y=8, feather=16), F32, {}),
    ("pad_outpaint_feather", "ImagePadForOutpaint",
     dict(image=IMG, left=8, top=0, right=16, bottom=4, feathering=3), F32, {}),
    ("pad_outpaint_no_feather", "ImagePadForOutpaint",
     dict(image=IMG, left=8, top=8, right=0, bottom=0, feathering=7), EXACT, {}),
    *[(f"scale_{m}", "ImageScale",
       dict(image=IMG, upscale_method=m, width=21, height=9, crop="disabled"), F32, {})
      for m in ("nearest-exact", "bilinear", "area", "bicubic", "lanczos")],
    ("scale_center_crop", "ImageScale",
     dict(image=IMG, upscale_method="bilinear", width=10, height=10, crop="center"), F32, {}),
    ("scale_zero_width", "ImageScale",
     dict(image=IMG, upscale_method="bicubic", width=0, height=24), F32, {}),
    ("scale_by", "ImageScaleBy", dict(image=IMG, upscale_method="bicubic", scale_by=1.5),
     F32, {}),
    ("scale_megapixels", "ImageScaleToTotalPixels",
     dict(image=IMG, upscale_method="bilinear", megapixels=0.0004), F32, {}),
    ("crop", "ImageCrop", dict(image=IMG, width=7, height=20, x=10, y=3), EXACT, {}),
    ("blur", "ImageBlur", dict(image=IMG, blur_radius=2, sigma=1.3), F32, {}),
    ("sharpen", "ImageSharpen", dict(image=IMG, sharpen_radius=1, sigma=0.8, alpha=1.5),
     F32, {}),
    ("invert", "ImageInvert", dict(image=IMG), EXACT, {}),
    ("image_batch", "ImageBatch", dict(image1=IMG, image2=IMG[:1]), EXACT, {}),
    ("image_batch_resize", "ImageBatch", dict(image1=IMG, image2=IMG_SMALL), F32, {}),
    ("solid_mask", "SolidMask", dict(value=0.3, width=7, height=5), EXACT, {"device": "cpu"}),
    ("invert_mask", "InvertMask", dict(mask=SOFT_MASK), EXACT, {}),
    ("image_to_mask", "ImageToMask", dict(image=IMG, channel="green"), EXACT, {}),
    ("image_to_mask_alpha", "ImageToMask", dict(image=IMG, channel="alpha"), EXACT, {}),
    ("mask_to_image", "MaskToImage", dict(mask=SOFT_MASK), EXACT, {}),
    ("grow_mask", "GrowMask", dict(mask=MASK, expand=2, tapered_corners=True), EXACT, {}),
    ("shrink_mask", "GrowMask", dict(mask=MASK, expand=-1, tapered_corners=False), EXACT,
     {}),
    ("feather_mask", "FeatherMask", dict(mask=SOFT_MASK, left=2, top=1, right=3, bottom=4),
     F32, {}),
    *[(f"mask_composite_{op}", "MaskComposite",
       dict(destination=MASK, source=SOFT_MASK, x=4, y=2, operation=op), EXACT, {})
      for op in ("multiply", "add", "subtract", "and", "or", "xor")],
    *[(f"latent_upscale_{m}", "LatentUpscale",
       dict(samples=lat(LAT, LAT_MASK), upscale_method=m, width=96, height=64), F32, {})
      for m in ("nearest-exact", "nearest", "bilinear", "area")],
    ("latent_upscale_by", "LatentUpscaleBy",
     dict(samples=lat(LAT), upscale_method="nearest", scale_by=2.0), EXACT, {}),
    ("set_noise_mask", "SetLatentNoiseMask", dict(samples=lat(LAT), mask=SOFT_MASK), F32, {}),
    ("latent_blend", "LatentBlend",
     dict(samples1=lat(LAT), samples2=lat(LAT_B), blend_factor=0.3), F32, {}),
    ("latent_batch", "LatentBatch", dict(samples1=lat(LAT), samples2=lat(LAT[:1])), EXACT, {}),
    ("latent_add", "LatentAdd", dict(samples1=lat(LAT), samples2=lat(LAT[::-1].copy())),
     EXACT, {}),
    ("latent_subtract", "LatentSubtract", dict(samples1=lat(LAT), samples2=lat(LAT_B)), F32,
     {}),
    ("latent_interpolate", "LatentInterpolate",
     dict(samples1=lat(LAT), samples2=lat(LAT_B), ratio=0.35), F32, {}),
    ("latent_multiply", "LatentMultiply", dict(samples=lat(LAT), multiplier=-1.25), EXACT,
     {}),
    *[(f"latent_flip_{m[0]}", "LatentFlip", dict(samples=lat(LAT, LAT_MASK), flip_method=m),
       EXACT, {}) for m in ("x-axis: vertically", "y-axis: horizontally")],
    *[(f"latent_rotate_{r[:3]}", "LatentRotate", dict(samples=lat(LAT, LAT_MASK), rotation=r),
       EXACT, {}) for r in ("90 degrees", "180 degrees", "270 degrees")],
    ("latent_crop", "LatentCrop", dict(samples=lat(LAT, LAT_MASK), width=96, height=16, x=16,
                                       y=512), EXACT, {}),
    ("repeat_latent", "RepeatLatentBatch", dict(samples=lat(LAT, LAT_MASK[:1]), amount=3),
     EXACT, {}),
    ("latent_from_batch", "LatentFromBatch",
     dict(samples=lat(np.concatenate([LAT, LAT]), LAT_MASK), batch_index=1, length=2), EXACT,
     {}),
    ("timestep_range", "ConditioningSetTimestepRange",
     dict(conditioning={**COND, "extras": (COND_B,)}, start=0.2, end=0.7), EXACT, {}),
    ("zero_out", "ConditioningZeroOut",
     dict(conditioning={**COND, "penultimate": _n(1, 5, 8), "extras": (COND_B,)}), EXACT,
     {}),
    ("combine", "ConditioningCombine",
     dict(conditioning_1={**COND, "extras": (COND_B,)}, conditioning_2=COND_B), EXACT, {}),
    ("set_area", "ConditioningSetArea",
     dict(conditioning=COND, width=64, height=32, x=8, y=16, strength=0.8), EXACT, {}),
    ("set_area_pct", "ConditioningSetAreaPercentage",
     dict(conditioning=COND, width=0.5, height=0.25, x=0.1, y=0.3, strength=1.2), EXACT, {}),
    ("set_mask", "ConditioningSetMask",
     dict(conditioning=COND, mask=SOFT_MASK, strength=0.6, set_cond_area="mask bounds"),
     EXACT, {}),
    ("average", "ConditioningAverage",
     dict(conditioning_to={**COND, "extras": (COND,)}, conditioning_from=COND_B,
          conditioning_to_strength=0.4), F32, {}),
    ("concat", "ConditioningConcat", dict(conditioning_to=COND, conditioning_from=COND_B),
     EXACT, {}),
    ("flux_guidance", "FluxGuidance", dict(conditioning=COND, guidance=2.5), EXACT, {}),
    ("unclip", "unCLIPConditioning",
     dict(conditioning=COND, clip_vision_output={"image_embeds": _n(1, 6)}, strength=0.7,
          noise_augmentation=0.1), EXACT, {}),
    ("karras", "KarrasScheduler", dict(steps=7, sigma_max=14.6, sigma_min=0.03, rho=7.0),
     F32, {}),
    ("exponential", "ExponentialScheduler", dict(steps=7, sigma_max=14.6, sigma_min=0.03),
     F32, {}),
    ("sd_turbo", "SDTurboScheduler", dict(model=None, steps=3, denoise=0.75), F32, {}),
    ("basic_scheduler", "BasicScheduler",
     dict(model=None, scheduler="karras", steps=6, denoise=0.6), F32, {}),
    ("split_sigmas", "SplitSigmas", dict(sigmas=np.linspace(5, 0, 6, dtype=np.float32),
                                         step=2), EXACT, {}),
    ("flip_sigmas", "FlipSigmas", dict(sigmas=np.linspace(5, 0, 6, dtype=np.float32)), EXACT,
     {}),
    ("ksampler_select", "KSamplerSelect", dict(sampler_name="lms"), EXACT, {}),
    *[(f"named_{n}", n, {}, EXACT, {}) for n in (
        "SamplerEulerAncestral", "SamplerDPMPP_2M_SDE", "SamplerDPMPP_SDE",
        "SamplerDPMPP_3M_SDE", "SamplerLMS")],
    ("random_noise", "RandomNoise", dict(noise_seed=2**63 + 7), EXACT, {}),
    ("disable_noise", "DisableNoise", {}, EXACT, {}),
    ("clip_skip", "CLIPSetLastLayer", dict(clip={"type": "clip"}, stop_at_clip_layer=-2),
     EXACT, {}),
]


def jax_reference(name, kwargs):
    """The JAX shim ``name`` on ``kwargs`` traced as one jit program over the array
    leaves: one compile, where the eager shim compiles each of its ops for each new
    shape. The conditioning shims (whose Python scalars a program would return as
    arrays) and shims that take or return what jit cannot carry (strings, seeds past
    int64, sampler wires) run eagerly."""
    cls = jn.NODE_CLASS_MAPPINGS[name]
    fn = getattr(cls(), cls.FUNCTION)
    if "Conditioning" in name:
        return fn(**_to("jax", kwargs))
    leaves, treedef = jax.tree.flatten(_to("jax", kwargs))
    idx = [i for i, x in enumerate(leaves) if isinstance(x, jax.Array)]

    def program(*arrays):
        ls = list(leaves)
        for i, a in zip(idx, arrays):
            ls[i] = a
        return fn(**jax.tree.unflatten(treedef, ls))

    try:
        return jax.jit(program)(*(leaves[i] for i in idx))
    except (TypeError, OverflowError):
        return fn(**_to("jax", kwargs))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_shim_matches_jax(case):
    _, name, kwargs, tol, port_only = case
    pcls = pn.NODE_CLASS_MAPPINGS[name]
    want = jax_reference(name, kwargs)
    got = getattr(pcls(), pcls.FUNCTION)(**_to("torch", kwargs), **port_only)
    assert_same(got, want, tol)


@pytest.mark.parametrize("method", ["bicubic", "bislerp"])
def test_latent_upscale_cubic_entries(method):
    """The JAX shim passes these two stock menu entries on to ``TPULatentUpscale``,
    whose menu lacks them, and raises; the port resizes by cubic, held against
    ``jax.image.resize``'s cubic (the noise mask bilinear, as for every entry)."""
    kw = dict(samples=lat(LAT, LAT_MASK), upscale_method=method, width=96, height=64)
    with pytest.raises(ValueError, match="method must be one of"):
        jn.NODE_CLASS_MAPPINGS["LatentUpscale"]().upscale(**_to("jax", kw))
    (got,) = pn.NODE_CLASS_MAPPINGS["LatentUpscale"]().upscale(**_to("torch", kw))
    want = {"samples": jax.image.resize(jnp.asarray(LAT), (2, 8, 12, 4), method="cubic"),
            "noise_mask": jax.image.resize(jnp.asarray(LAT_MASK), (2, 8, 12, 1),
                                           method="bilinear")}
    assert_same(got, want, F32)


def _models():
    """A JAX and a port DiffusionModel carrying the same prefs and config."""
    from comfyui_parallelanything_tpu.models.api import DiffusionModel as JModel
    from comfyui_parallelanything_tpu_torch.models.api import DiffusionModel as PModel

    prefs = {"cfg_rescale": 0.2}
    jm = JModel(apply=None, params={}, config=dataclasses.make_dataclass(
        "Cfg", [("prediction", str, "eps")])(), sampler_prefs=dict(prefs),
        source={"path": "x"})
    pm = PModel(module=torch.nn.Identity(), config=jm.config, sampler_prefs=dict(prefs),
                source={"path": "x"})
    return jm, pm


@pytest.mark.parametrize("name,kwargs", [
    ("RescaleCFG", dict(multiplier=0.6)),
    ("ModelSamplingSD3", dict(shift=2.5)),
    ("ModelSamplingFlux", dict(max_shift=1.2, base_shift=0.4, width=768, height=1344)),
    ("ModelSamplingDiscrete", dict(sampling="v_prediction", zsnr=True)),
])
def test_model_patches_tag_like_jax(name, kwargs):
    jm, pm = _models()
    (jout,) = getattr(jn.NODE_CLASS_MAPPINGS[name](), "patch")(jm, **kwargs)
    (pout,) = getattr(pn.NODE_CLASS_MAPPINGS[name](), "patch")(pm, **kwargs)
    assert pout.sampler_prefs == pytest.approx(jout.sampler_prefs)
    assert pout.config.prediction == jout.config.prediction
    assert pout.source == jout.source == {"path": "x"}
    assert pout is not pm and pm.sampler_prefs == {"cfg_rescale": 0.2}
    assert pm.config.prediction == "eps"  # the input MODEL is left as it was


def test_patches_survive_parallelize_and_a_parallel_model_is_copied(cpu_devices):
    from comfyui_parallelanything_tpu_torch.models import build_unet, sd15_config
    from comfyui_parallelanything_tpu_torch.parallel.orchestrator import parallelize

    cfg = sd15_config(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                      transformer_depth=(1, 0), attention_levels=(0,), num_heads=4,
                      norm_groups=8, context_dim=16, dtype=torch.float32)
    model = build_unet(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    (tagged,) = pc.RescaleCFG().patch(model, 0.7)
    pm = parallelize(tagged, [("cpu:0", 50), ("cpu:1", 50)])
    assert pm.sampler_prefs == {"cfg_rescale": 0.7}
    (shifted,) = pc.ModelSamplingSD3().patch(pm, 3.0)
    assert shifted.sampler_prefs == {"cfg_rescale": 0.7, "shift": 3.0}
    assert pm.sampler_prefs == {"cfg_rescale": 0.7} and shifted._module is pm._module
    # FreeU: a new module over the same tensors; the loader's MODEL keeps its config.
    (freeu,) = pc.FreeU().patch(model, 1.1, 1.2, 0.9, 0.2)
    assert freeu.config.freeu == (1.1, 1.2, 0.9, 0.2, 1) and model.config.freeu is None
    assert freeu.module is not model.module
    assert all(a.data_ptr() == b.data_ptr() for a, b in
               zip(model.module.parameters(), freeu.module.parameters()))
    assert freeu.pipeline_spec is not None and freeu.source is None
    with pytest.raises(ValueError, match="FreeU patches SD-family UNET"):
        pc.FreeU_V2().patch(pm, 1.3, 1.4, 0.9, 0.2)
    # ModelMergeSimple lerps tensor by tensor, as the JAX shim lerps its pytrees.
    other = build_unet(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    (merged,) = pc.ModelMergeSimple().merge(model, other, 0.3)
    from comfyui_parallelanything_tpu.models.api import DiffusionModel as JModel

    sd_a = {k: v.numpy() for k, v in model.module.state_dict().items()}
    sd_b = {k: v.numpy() for k, v in other.module.state_dict().items()}
    (jmerged,) = jn.NODE_CLASS_MAPPINGS["ModelMergeSimple"]().merge(
        JModel(apply=None, params=sd_a, name="a"), JModel(apply=None, params=sd_b), 0.3)
    assert_same(merged.module.state_dict(), jmerged.params, F32)
    assert merged.source == {"merged": True} and merged.name == "sd-unet+merge"
    with pytest.raises(ValueError, match="BEFORE ModelMergeSimple"):
        pc.LoraLoader().load_lora(merged, None, "x.safetensors", device="cpu")


def test_save_and_load_latent_cross_packages(tmp_path, monkeypatch):
    from safetensors.numpy import load_file, save_file

    from comfyui_parallelanything_tpu_torch.models.loader import load_safetensors

    monkeypatch.setenv("PA_OUTPUT_DIR", str(tmp_path / "out"))
    monkeypatch.setenv("PA_INPUT_DIR", str(tmp_path / "out"))
    x = np.linspace(-2, 2, 2 * 3 * 5 * 4, dtype=np.float32).reshape(2, 3, 5, 4)
    save_j, load_j = jn.NODE_CLASS_MAPPINGS["SaveLatent"], jn.NODE_CLASS_MAPPINGS["LoadLatent"]
    ui = pc.SaveLatent().save(lat(torch.from_numpy(x)), "latents/run")
    port_file = os.path.join("latents", ui["ui"]["latents"][0])
    jui = save_j().save(lat(jnp.asarray(x)), "latents/run")
    jax_file = os.path.join("latents", jui["ui"]["latents"][0])
    assert port_file != jax_file  # the counter moved on past the port's file
    # The port's file is stock NCHW, read by the safetensors package and JAX's node.
    on_disk = load_file(str(tmp_path / "out" / port_file))
    np.testing.assert_array_equal(on_disk["latent_tensor"], np.moveaxis(x, -1, 1))
    assert on_disk["latent_format_version_0"].shape == (0,)
    (j_read,) = load_j().load(port_file)
    np.testing.assert_array_equal(np.asarray(j_read["samples"]), x)
    (p_read,) = pc.LoadLatent().load(port_file, device="cpu")
    np.testing.assert_array_equal(p_read["samples"].numpy(), x)
    # JAX's file: an NCHW header, read by the port as the JAX node reads it. (Its bytes
    # are the moved-axis view's memory order, not NCHW: the safetensors package writes
    # a non-contiguous numpy view unpermuted, so the JAX round trip does not give x
    # back; the port writes a contiguous copy.)
    assert load_safetensors(str(tmp_path / "out" / jax_file))["latent_tensor"].shape == \
        (2, 4, 3, 5)
    (p_read,) = pc.LoadLatent().load(jax_file, device="cpu")
    (j_self,) = load_j().load(jax_file)
    np.testing.assert_array_equal(p_read["samples"].numpy(), np.asarray(j_self["samples"]))
    # A legacy dump (no version marker) is scaled by 1/0.18215 on both sides.
    save_file({"latent_tensor": np.moveaxis(x, -1, 1) * 0.18215},
              str(tmp_path / "out" / "legacy.latent"))
    (p_old,) = pc.LoadLatent().load("legacy.latent", device="cpu")
    (j_old,) = load_j().load("legacy.latent")
    np.testing.assert_allclose(p_old["samples"].numpy(), np.asarray(j_old["samples"]),
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="not found"):
        pc.LoadLatent().load("missing.latent", device="cpu")


def test_image_file_shims_match_jax(tmp_path, monkeypatch):
    from PIL import Image

    monkeypatch.setenv("PA_INPUT_DIR", str(tmp_path))
    monkeypatch.setenv("PA_OUTPUT_DIR", str(tmp_path / "out"))
    rgba = (RNG.uniform(0, 1, (6, 9, 4)) * 255).astype(np.uint8)
    Image.fromarray(rgba, "RGBA").save(tmp_path / "in.png")
    for name, kw in (("LoadImage", dict(image="in.png")),
                     ("LoadImageMask", dict(image="in.png", channel="alpha")),
                     ("LoadImageMask", dict(image="in.png", channel="blue"))):
        jcls, pcls = jn.NODE_CLASS_MAPPINGS[name], pn.NODE_CLASS_MAPPINGS[name]
        want = getattr(jcls(), jcls.FUNCTION)(**kw)
        got = getattr(pcls(), pcls.FUNCTION)(**kw, device="cpu")
        assert_same(got, want, EXACT)
    (paths,) = pc.PreviewImage().preview(torch.from_numpy(IMG))
    assert len(paths) == 2 and all(os.sep + "temp" + os.sep in p for p in paths)
    (webp,) = pc.SaveAnimatedWEBP().save_images(torch.from_numpy(IMG), "clip", fps=4.0)
    assert os.path.exists(webp[0]) and webp[0].endswith("clip_00000.webp")


def test_sampler_custom_matches_jax(monkeypatch):
    """``SamplerCustom`` on a toy model (the same affine function on both sides)
    with the same injected start noise, against the JAX shim."""
    from comfyui_parallelanything_tpu.models.api import DiffusionModel as JModel
    from comfyui_parallelanything_tpu_torch.models.api import DiffusionModel as PModel

    noise = _n(1, 4, 4, 4)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape=(), dtype=jnp.float32: jnp.asarray(noise, dtype))
    monkeypatch.setattr(pn, "initial_noise", lambda seed, shape, device: torch.from_numpy(noise))

    class Toy(torch.nn.Module):
        def forward(self, x, t, context=None, **kw):
            return x * 0.05 + context.float().mean(dim=(1, 2)).reshape(-1, 1, 1, 1)

    def apply(p, x, t, context=None, **kw):
        return x * 0.05 + jnp.mean(context, axis=(1, 2)).reshape((-1, 1, 1, 1))

    cfg = dataclasses.make_dataclass("Cfg", [("prediction", str, "eps")])()
    jm, pm = JModel(apply=apply, params={}, config=cfg), PModel(module=Toy(), config=cfg)
    pos, neg, latent = {"context": _n(1, 3, 5)}, {"context": _n(1, 3, 5)}, lat(_n(1, 4, 4, 4))
    args = dict(add_noise=True, noise_seed=11, cfg=3.0, positive=pos, negative=neg,
                sampler={"sampler": "euler"}, latent_image=latent)
    (sig,) = jn.NODE_CLASS_MAPPINGS["BasicScheduler"]().run(model=jm, scheduler="normal",
                                                           steps=3, denoise=1.0)
    want = jn.NODE_CLASS_MAPPINGS["SamplerCustom"]().sample(
        jm, **_to("jax", {**args, "sigmas": np.asarray(sig)}))
    got = pc.SamplerCustom().sample(pm, **_to("torch", {**args, "sigmas": np.asarray(sig)}))
    assert_same(got, want, dict(rtol=1e-5, atol=1e-5))
