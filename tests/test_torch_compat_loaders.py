"""The port's stock-name loader shims (``nodes_compat.py``) against the JAX
package's, over one ``$PA_MODELS_DIR`` of seeded tiny files in the ComfyUI folder
layout (``checkpoints/``, ``clip/``, ``vae/``, ``unet/``, ``loras/``,
``upscale_models/``, ``controlnet/``, ``clip_vision/``): both packages load the same
files into the same weights (exactly, through ``convert_jax``; LoRA-baked tensors at
f32 rounding, 1e-6) and encode the same conditioning (2e-4). The SD1.5 world and its
patched configs are ``test_torch_graphs_sd15``'s; OpenCLIP-G, OpenCLIP-H, T5 and the
SD2.1-unCLIP UNet are patched to tiny widths in both packages. The Wan shims raise
naming ROADMAP item 10."""

import dataclasses
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
import test_torch_graphs_sd15 as g  # noqa: E402
import test_torch_vision as tv  # noqa: E402
from comfyui_parallelanything_tpu import nodes as jn  # noqa: E402
from comfyui_parallelanything_tpu_torch import nodes as pn  # noqa: E402
from comfyui_parallelanything_tpu_torch import nodes_compat as pc  # noqa: E402
from comfyui_parallelanything_tpu_torch.models import convert_jax as cj  # noqa: E402
from comfyui_parallelanything_tpu_torch.models.loader import (  # noqa: E402
    load_safetensors,
    save_safetensors,
)

EXACT = dict(rtol=0, atol=0)
COND = dict(rtol=2e-4, atol=2e-4)
BAKED = dict(rtol=1e-6, atol=1e-6)
PROMPT = "a watercolor lighthouse at dawn"
CKPT = chip_smoke.STOCK_CKPT
# The stock CLIP loaders tokenize at 77, so every tower here has 77 positions.
L_TOWER = dict(g.CLIP, max_len=77)
G_TOWER = dict(vocab_size=49408, hidden_size=64, num_layers=2, num_heads=4, max_len=77,
               act="gelu", projection_dim=64, eos_id=49407)
H_TOWER = dict(G_TOWER, hidden_size=48, projection_dim=32, penultimate_ln=True)
T5 = dict(vocab_size=100, d_model=128, num_layers=2, num_heads=4, d_kv=16, d_ff=64)
UNCLIP_UNET = dict(g.UNET, context_dim=1024)
ADM = 16


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def same_state(got: dict, want: dict, tol=EXACT, what=""):
    """The port's state against a JAX tree's conversion, each JAX leaf cast to the
    port's storage dtype (the port stores what flax computes with, e.g. a sniffed
    tower's bf16 linears)."""
    assert set(got) == set(want), (what, sorted(set(got) ^ set(want))[:4])
    for k, v in want.items():
        torch.testing.assert_close(got[k].cpu(), v.to(got[k].dtype), msg=f"{what} {k}", **tol)


def _state(module) -> dict:
    return {k: v.detach() for k, v in module.state_dict().items()}


def _tiny_configs(mp):
    """CLIP-L (77 positions), OpenCLIP-G/-H, T5, SD2.x and the VAE sniffer's SD
    preset patched to tiny widths in both packages."""
    import comfyui_parallelanything_tpu.models as jmodels
    import comfyui_parallelanything_tpu.models.text_encoders as jte
    import comfyui_parallelanything_tpu.models.vae as jvae
    import comfyui_parallelanything_tpu_torch.models as pmodels
    import comfyui_parallelanything_tpu_torch.models.text_encoders as pte

    # VAELoader's sniffer reads the VAE module's own preset.
    mp.setattr(jvae, "sd_vae_config", jmodels.sd_vae_config)
    mp.setattr(g.pvae, "sd_vae_config", pmodels.sd_vae_config)

    for mod, te, dt in ((jmodels, jte, jnp.float32), (pmodels, pte, torch.float32)):
        cfg_l = te.CLIPTextConfig(**L_TOWER, dtype=dt)
        cfg_g = te.CLIPTextConfig(**G_TOWER, dtype=dt)
        cfg_h = te.CLIPTextConfig(**H_TOWER, dtype=dt)
        cfg_t5 = te.T5Config(**T5, dtype=dt)
        for m in (mod, te):
            mp.setattr(m, "open_clip_g_config", lambda c=cfg_g: c, raising=False)
            mp.setattr(m, "open_clip_h_config", lambda c=cfg_h: c, raising=False)
        mp.setattr(te, "t5_xxl_config", lambda c=cfg_t5: c)
        mp.setattr(te, "clip_l_config", lambda c=cfg_l: c)
        real = mod.sd21_config
        unet_kw = dict(UNCLIP_UNET, dtype=dt)
        mp.setattr(mod, "sd21_config", lambda real=real, kw=unet_kw, **o: real(**kw, **o))


def _open_clip_text_layout(cfg, gen, prefix):
    """A tiny text tower of the port in OpenCLIP's resblocks layout (the inverse of
    ``convert_open_clip_checkpoint``)."""
    from comfyui_parallelanything_tpu_torch.models import build_clip_text

    s = _state(build_clip_text(cfg, device="cpu", generator=gen).module)
    out = {"token_embedding.weight": s["tok_emb.weight"],
           "positional_embedding": s["pos_emb"], "ln_final.weight": s["final_ln.weight"],
           "ln_final.bias": s["final_ln.bias"],
           "text_projection": s["text_proj.weight"].T.contiguous()}
    for i in range(cfg.num_layers):
        t, d = f"transformer.resblocks.{i}.", f"layers.{i}."
        for leaf in ("weight", "bias"):
            out[f"{t}attn.in_proj_{leaf}"] = torch.cat([s[f"{d}{n}.{leaf}"] for n in "qkv"])
            for mine, theirs in (("out", "attn.out_proj"), ("fc1", "mlp.c_fc"),
                                 ("fc2", "mlp.c_proj"), ("ln1", "ln_1"), ("ln2", "ln_2")):
                out[f"{t}{theirs}.{leaf}"] = s[f"{d}{mine}.{leaf}"]
    return {prefix + k: v + 0.01 * torch.randn(v.shape, generator=gen) for k, v in out.items()}


def _t5_file(path, gen):
    from test_torch_text import _t5_layout

    sd = _t5_layout(dict(T5), np.random.default_rng(int(torch.randint(100, (1,), generator=gen))),
                    per_layer_bias=False)
    save_safetensors(path, {k: torch.from_numpy(v * 0.2) for k, v in sd.items()})


def _t5_tokenizer(path):
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace

    vocab = {"[UNK]": 0, "</s>": 1, "a": 5, "watercolor": 6, "lighthouse": 7, "at": 8,
             "dawn": 9}
    t = Tokenizer(WordLevel(vocab, unk_token="[UNK]"))
    t.pre_tokenizer = Whitespace()
    t.save(path)


def _unclip_checkpoint(path, world_ckpt, gen):
    """A tiny SD2.1-unCLIP single file: the UNet (1024-wide context, a 16-wide adm
    head) in the ldm layout, the world's VAE, an OpenCLIP-H text tower and an
    OpenCLIP ViT under ``embedder.model.visual.``."""
    from comfyui_parallelanything_tpu_torch.models import build_unet

    cfg = dataclasses.replace(g.pmodels.sd21_config(prediction="v"), adm_in_channels=ADM)
    unet = build_unet(cfg, device="cpu", generator=gen)
    sd = {f"model.diffusion_model.{k}": v
          for k, v in chip_smoke.ldm_unet_layout(cfg, _state(unet.module)).items()}
    sd.update({k: v for k, v in load_safetensors(world_ckpt).items()
               if k.startswith("first_stage_model.")})
    sd.update(_open_clip_text_layout(g.pmodels.open_clip_h_config(), gen,
                                     "cond_stage_model.model."))
    hf = tv.random_hf_tower("gelu", seed=7)
    sd.update({f"embedder.model.visual.{k}": v
               for k, v in tv.openclip_visual_layout(hf, tv.TINY["num_layers"]).items()})
    save_safetensors(path, sd)


def _lora_file(path, world_ckpt, gen):
    """A rank-2 kohya LoRA over one UNet attention projection and one CLIP-L
    projection (``lora_te_`` keys) of the world's checkpoint."""
    sd = load_safetensors(world_ckpt)
    unet_key = next(k for k in sd if k.endswith("attn1.to_q.weight")
                    and "input_blocks" in k).removeprefix("model.diffusion_model.")
    out = {}
    for key, shape in ((unet_key, sd[f"model.diffusion_model.{unet_key}"].shape),
                       ("lora_te_text_model_encoder_layers_0_self_attn_q_proj.weight",
                        (g.CLIP["hidden_size"],) * 2)):
        base = key.removesuffix(".weight")
        out[f"{base}.lora_down.weight"] = torch.randn((2, shape[1]), generator=gen)
        out[f"{base}.lora_up.weight"] = torch.randn((shape[0], 2), generator=gen)
    save_safetensors(path, out)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The tmp ``$PA_MODELS_DIR`` and both packages patched; yields the paths."""
    from comfyui_parallelanything_tpu_torch.models import build_controlnet
    from comfyui_parallelanything_tpu_torch.models.convert_unet import (
        convert_controlnet_checkpoint,
    )
    from comfyui_parallelanything_tpu_torch.models.upscale import UpscaleConfig, build_upscaler

    with pytest.MonkeyPatch.context() as mp:
        tmp = str(tmp_path_factory.mktemp("stock"))
        paths = g.build_graph_env(tmp, mp)
        _tiny_configs(mp)
        gen = torch.Generator().manual_seed(11)
        clip = g.pmodels.build_clip_text(g.pte.clip_l_config(), device="cpu", generator=gen)
        paths["clip"] = os.path.join(tmp, "clip_l.safetensors")
        save_safetensors(paths["clip"], chip_smoke.hf_clip_layout(
            {k: v + 0.01 * torch.randn(v.shape, generator=gen)
             for k, v in _state(clip.module).items()}))
        root = chip_smoke.stock_models_dir(paths, tmp)
        for sub in ("clip", "vae", "unet", "loras", "upscale_models", "controlnet",
                    "clip_vision"):
            os.makedirs(os.path.join(root, sub))
        sd = load_safetensors(paths["ckpt"])
        save_safetensors(os.path.join(root, "vae", "kl-f8.safetensors"),
                         {k: v for k, v in sd.items() if k.startswith("first_stage_model.")})
        save_safetensors(os.path.join(root, "unet", "bare_unet.safetensors"),
                         {k: v for k, v in sd.items() if k.startswith("model.diffusion_model.")})
        shutil.copy(paths["clip"], os.path.join(root, "clip", "clip_l.safetensors"))
        save_safetensors(os.path.join(root, "clip", "clip_g.safetensors"),
                         _open_clip_text_layout(g.pmodels.open_clip_g_config(), gen, ""))
        _t5_file(os.path.join(root, "clip", "t5xxl_fp16.safetensors"), gen)
        _t5_tokenizer(os.path.join(tmp, "t5_tokenizer.json"))
        _lora_file(os.path.join(root, "loras", "style.safetensors"), paths["ckpt"], gen)
        esrgan = build_upscaler(UpscaleConfig(nf=8, nb=1, gc=4, scale=4), device="cpu",
                                generator=gen)
        chip_smoke.write_upscaler_file(os.path.join(root, "upscale_models", "x4.safetensors"),
                                       esrgan)
        cfg = g.pmodels.sd15_config()
        cn = build_controlnet(cfg, device="cpu", generator=gen)
        save_safetensors(os.path.join(root, "controlnet", "cn.safetensors"),
                         chip_smoke.ldm_unet_layout(cfg, _state(cn.module),
                                                    convert=convert_controlnet_checkpoint))
        save_safetensors(os.path.join(root, "clip_vision", "vit.safetensors"),
                         tv.random_hf_tower(seed=8))
        _unclip_checkpoint(os.path.join(root, "checkpoints", "unclip.safetensors"),
                           paths["ckpt"], gen)
        mp.setenv("PA_MODELS_DIR", root)
        mp.setenv("PA_CLIP_VOCAB", paths["vocab"])
        mp.setenv("PA_CLIP_MERGES", paths["merges"])
        mp.setenv("PA_T5_TOKENIZER_JSON", os.path.join(tmp, "t5_tokenizer.json"))
        yield {**paths, "root": root}


def both(name, *args, **kwargs):
    """The stock node ``name`` run by each package: (port's outputs, JAX's)."""
    pcls, jcls = pn.NODE_CLASS_MAPPINGS[name], jn.NODE_CLASS_MAPPINGS[name]
    want = getattr(jcls(), jcls.FUNCTION)(*args, **kwargs)
    got = getattr(pcls(), pcls.FUNCTION)(*args, **kwargs, device="cpu")
    return got, want


def encode(clip_p, clip_j, text=PROMPT, node="CLIPTextEncode"):
    (cp,) = getattr(pn.NODE_CLASS_MAPPINGS[node](), "run")(clip=clip_p, text=text)
    (cj_,) = getattr(jn.NODE_CLASS_MAPPINGS[node](), "run")(clip=clip_j, text=text)
    return cp, cj_


def same_cond(got: dict, want: dict, what: str):
    for k in ("context", "pooled"):
        if want.get(k) is None:
            assert got.get(k) is None, (what, k)
        else:
            g.assert_close(got[k], want[k], f"{what} {k}", COND)


@pytest.fixture(scope="module")
def checkpoint(world):
    """``CheckpointLoaderSimple`` on the world's checkpoint, by each package, once
    for the module: (port's outputs, JAX's)."""
    return both("CheckpointLoaderSimple", CKPT)


def test_checkpoint_loader_simple_and_clip_skip_match_jax(world, checkpoint):
    (pm, pclip, pvae), (jm, jclip, jvae) = checkpoint
    same_state(_state(pm.module), cj.from_jax_unet_params(_np_tree(jm.params)), what="unet")
    same_state(_state(pvae.module), cj.from_jax_vae_params(_np_tree(jvae.params)), what="vae")
    same_state(_state(pclip["encoder"].module),
               cj.from_jax_text_params(_np_tree(jclip["encoder"].params)), what="clip")
    assert pm.source == jm.source == {"path": os.path.join(world["root"], "checkpoints", CKPT),
                                      "family": "sd15"}
    assert pclip["source_ckpt"] == jclip["source_ckpt"] and pclip["type"] == "clip"
    same_cond(*encode(pclip, jclip), "bundled clip")
    (sp,) = pc.CLIPSetLastLayer().set_last_layer(pclip, -2)
    (sj,) = jn.NODE_CLASS_MAPPINGS["CLIPSetLastLayer"]().set_last_layer(jclip, -2)
    assert sp["clip_skip"] == sj["clip_skip"] == 2
    cp, cjj = encode(sp, sj)
    same_cond(cp, cjj, "clip skip")
    g.assert_close(cp["context"], cp["penultimate"], "penultimate", EXACT)
    # Without the tokenizer tables the wire loads and the encode says what to set.
    os.environ.pop("PA_CLIP_VOCAB")
    try:
        (_, bare, _) = pc.CheckpointLoaderSimple().load(CKPT, device="cpu")
    finally:
        os.environ["PA_CLIP_VOCAB"] = world["vocab"]
    with pytest.raises(ValueError, match="PA_CLIP_VOCAB"):
        pn.NODE_CLASS_MAPPINGS["CLIPTextEncode"]().run(clip=bare, text=PROMPT)


def on_wires(name, port_wire, jax_wire, **kwargs):
    """A stock node without a device input, run by each package on its own wire."""
    pcls, jcls = pn.NODE_CLASS_MAPPINGS[name], jn.NODE_CLASS_MAPPINGS[name]
    return (getattr(pcls(), pcls.FUNCTION)(port_wire, **kwargs),
            getattr(jcls(), jcls.FUNCTION)(jax_wire, **kwargs))


def _towers(wire: dict) -> dict:
    return {k: wire[k] for k in ("l", "g", "t5") if wire.get(k) is not None}


@pytest.mark.parametrize("names,kinds", [
    (("t5xxl_fp16.safetensors", "clip_g.safetensors", "clip_l.safetensors"), None),
    (("clip_l.safetensors", "clip_g.safetensors"), {"l", "g"}),
    (("t5xxl_fp16.safetensors", "clip_l.safetensors"), {"l", "t5"}),
    (("clip_g.safetensors", "t5xxl_fp16.safetensors"), {"g", "t5"}),
], ids=["triple", "dual_l_g", "dual_t5_l", "dual_g_t5"])
def test_sd3_text_loaders_match_jax(world, names, kinds):
    if kinds is None:
        (pw,), (jw,) = both("TripleCLIPLoader", *names)
        kinds = {"l", "g", "t5"}
    else:
        (pw,), (jw,) = both("DualCLIPLoader", *names, type="sd3")
    assert pw["type"] == jw["type"] == "sd3-triple" and set(_towers(pw)) == kinds
    assert set(_towers(jw)) == kinds
    for k in kinds:
        convert = cj.from_jax_text_params
        same_state(_state(pw[k]["encoder"].module),
                   convert(_np_tree(jw[k]["encoder"].params)), what=k)
    same_cond(*encode(pw, jw), "sd3")


def test_text_tower_classification_and_pairings(world):
    root = os.path.join(world["root"], "clip")
    for src, want in (("t5xxl_fp16", "t5"), ("clip_g", "open-clip-g"), ("clip_l", "clip-l")):
        anon = os.path.join(world["tmp"], f"tower_{want}.safetensors")
        shutil.copy(os.path.join(root, f"{src}.safetensors"), anon)
        assert pc._classify_text_tower(anon, anon) == want
        from comfyui_parallelanything_tpu.nodes_compat import _classify_text_tower

        assert _classify_text_tower(anon, anon) == want
    assert pc._classify_text_tower("mystery.safetensors", None) is None
    with pytest.raises(ValueError, match="two t5 files"):
        pc.TripleCLIPLoader().load("t5xxl_fp16.safetensors", "t5xxl_fp16.safetensors",
                                   "clip_l.safetensors", device="cpu")
    with pytest.raises(ValueError, match="two t5 files"):
        pc.DualCLIPLoader().load("t5xxl_fp16.safetensors", "t5xxl_fp16.safetensors",
                                 type="sd3", device="cpu")


def test_sdxl_flux_and_single_loaders_encode_like_jax(world):
    (pw,), (jw,) = both("DualCLIPLoader", "clip_l.safetensors", "clip_g.safetensors",
                        type="sdxl")
    assert pw["type"] == jw["type"] == "sdxl-dual"
    kw = dict(width=1024, height=768, crop_w=8, crop_h=0, target_width=1024,
              target_height=1024, text_g=PROMPT, text_l="a lighthouse")
    (cp,), (cj_,) = on_wires("CLIPTextEncodeSDXL", pw, jw, **kw)
    same_cond(cp, cj_, "sdxl")
    (rp,), (rj,) = on_wires("CLIPTextEncodeSDXLRefiner", pw, jw, ascore=6.0, width=1024,
                            height=1024, text=PROMPT)
    same_cond(rp, rj, "refiner")
    # The flux pairing, wired in the swapped order (a "t5" marker on name 2 only).
    (fw,), (jfw,) = both("DualCLIPLoader", "clip_l.safetensors", "t5xxl_fp16.safetensors",
                         type="flux")
    assert fw["type"] == "flux-dual" and fw["t5"]["type"] == "t5"
    (fp,), (fj,) = on_wires("CLIPTextEncodeFlux", fw, jfw, clip_l="a lighthouse",
                            t5xxl=PROMPT, guidance=2.5)
    same_cond(fp, fj, "flux")
    assert fp["guidance"] == fj["guidance"] == 2.5
    # CLIPLoader: the type menu and the file-name marker pick the tower.
    pcl = pc.CLIPLoader().load("clip_l.safetensors", "stable_diffusion", host_device="cpu")[0]
    jcl = jn.NODE_CLASS_MAPPINGS["CLIPLoader"]().load("clip_l.safetensors", "stable_diffusion")[0]
    same_cond(*encode(pcl, jcl), "CLIPLoader")
    t5 = pc.CLIPLoader().load("t5xxl_fp16.safetensors", "sd3", device="cpu")[0]
    assert t5["type"] == "t5" and t5["tokenizer"].max_len == 256
    assert t5["encoder"].device.type == "cpu"
    os.environ.pop("PA_T5_TOKENIZER_JSON")
    try:
        with pytest.raises(ValueError, match="PA_T5_TOKENIZER_JSON"):
            pc.CLIPLoader().load("t5xxl_fp16.safetensors", "wan", host_device="cpu")
    finally:
        os.environ["PA_T5_TOKENIZER_JSON"] = os.path.join(world["tmp"], "t5_tokenizer.json")


def test_model_file_loaders_match_jax(world):
    (pv,), (jv,) = both("VAELoader", "kl-f8.safetensors")
    same_state(_state(pv.module), cj.from_jax_vae_params(_np_tree(jv.params)), what="vae")
    (pu,), (ju,) = both("UNETLoader", "bare_unet.safetensors", "fp8_e4m3fn")
    same_state(_state(pu.module), cj.from_jax_unet_params(_np_tree(ju.params)), what="unet")
    assert pu.source == ju.source and pu.source["family"] == "sd15"
    (pe,), (je,) = both("UpscaleModelLoader", "x4.safetensors")
    same_state(_state(pe.module), cj.from_jax_upscale_params(_np_tree(je.params)),
               what="esrgan")
    (pcn,), (jcn,) = both("ControlNetLoader", "cn.safetensors")
    same_state(_state(pcn["model"].module),
               cj.from_jax_unet_params(_np_tree(jcn["model"].params)), what="controlnet")
    (pvis,), (jvis,) = both("CLIPVisionLoader", "vit.safetensors")
    same_state(_state(pvis["model"].module),
               cj.from_jax_vision_params(_np_tree(jvis["model"].params)), what="vision")
    for name, arg in (("VAELoader", "none.safetensors"), ("UpscaleModelLoader", ""),
                      ("ControlNetLoader", "none.safetensors"), ("CLIPVisionLoader", "")):
        with pytest.raises(ValueError, match="not found"):
            getattr(pn.NODE_CLASS_MAPPINGS[name](), pn.NODE_CLASS_MAPPINGS[name].FUNCTION)(
                arg, device="cpu")
    # The tiled VAE nodes on the loaded VAE.
    lat = np.random.default_rng(3).standard_normal((1, 8, 8, 4)).astype(np.float32)
    (ip,) = pc.VAEDecodeTiled().decode({"samples": torch.from_numpy(lat)}, pv, tile_size=64)
    (ij,) = jn.NODE_CLASS_MAPPINGS["VAEDecodeTiled"]().decode({"samples": jnp.asarray(lat)}, jv,
                                                              tile_size=64)
    g.assert_close(ip, ij, "tiled decode", COND)


def _flat(model_p, model_j):
    return _state(model_p.module), cj.from_jax_unet_params(_np_tree(model_j.params))


def test_lora_loaders_rebake_from_source_like_jax(world, checkpoint):
    (pm, pclip, _), (jm, jclip, _) = checkpoint
    (lp, lclip), (lj, ljclip) = both("LoraLoader", pm, pclip, "style.safetensors", 0.7, 0.5)
    same_state(*_flat(lp, lj), tol=BAKED, what="baked unet")
    base = _state(pm.module)
    assert any(not torch.equal(base[k], v) for k, v in _state(lp.module).items())
    assert lp.source["loras"] == [(os.path.join(world["root"], "loras", "style.safetensors"),
                                   0.7)] == [tuple(x) for x in lj.source["loras"]]
    # strength_clip bakes the te deltas into the bundled tower.
    same_state(_state(lclip["encoder"].module),
               cj.from_jax_text_params(_np_tree(ljclip["encoder"].params)), tol=BAKED,
               what="baked clip")
    assert lclip["source_ckpt"] == pclip["source_ckpt"]
    same_cond(*encode(lclip, ljclip), "baked clip")
    # Chained links stack: twice at 0.7 is once at 1.4.
    (twice, _), _ = both("LoraLoader", lp, lclip, "style.safetensors", 0.7, 0.0)
    (once, _), _ = both("LoraLoader", pm, pclip, "style.safetensors", 1.4, 0.0)
    same_state(_state(twice.module), _state(once.module), tol=dict(rtol=1e-5, atol=1e-5))
    (mo,), (mj,) = both("LoraLoaderModelOnly", pm, "style.safetensors", 0.7)
    same_state(*_flat(mo, mj), tol=BAKED, what="model only")
    assert mo.source["te_loras"][-1][1] == 0.0
    with pytest.raises(ValueError, match="CheckpointLoaderSimple"):
        pc.LoraLoader().load_lora(object(), pclip, "style.safetensors", device="cpu")
    with pytest.raises(ValueError, match="not found"):
        pc.LoraLoader().load_lora(pm, pclip, "ghost.safetensors", device="cpu")


def test_unclip_checkpoint_loader_matches_jax(world):
    (pm, pclip, pvae, pvis), (jm, jclip, jvae, jvis) = both("unCLIPCheckpointLoader",
                                                            "unclip.safetensors")
    assert pm.source["family"] == jm.source["family"] == "sd21-unclip"
    assert pm.config.adm_in_channels == ADM and pm.config.prediction == "v"
    same_state(*_flat(pm, jm), what="unclip unet")
    same_state(_state(pvae.module), cj.from_jax_vae_params(_np_tree(jvae.params)), what="vae")
    same_state(_state(pclip["encoder"].module),
               cj.from_jax_text_params(_np_tree(jclip["encoder"].params)), what="open-clip-h")
    same_state(_state(pvis["model"].module),
               cj.from_jax_vision_params(_np_tree(jvis["model"].params)), what="vision")
    with pytest.raises(ValueError, match="no bundled image encoder"):
        pc.unCLIPCheckpointLoader().load(CKPT, device="cpu")


def test_wan_shims_raise_naming_item_10(world):
    for call in (lambda: pc.WanImageToVideo().encode({}, {}, None, 832, 480, 81, 1),
                 lambda: pc.EmptyHunyuanLatentVideo().generate(848, 480, 25)):
        with pytest.raises(NotImplementedError, match="item 10"):
            call()
    wan_vae = os.path.join(world["root"], "vae", "wan_vae.safetensors")
    save_safetensors(wan_vae, {"decoder.upsamples.0.weight": torch.zeros(1)})
    with pytest.raises(NotImplementedError, match="item 10"):
        pc.VAELoader().load("wan_vae.safetensors", device="cpu")
