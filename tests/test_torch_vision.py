"""The port's CLIP vision tower (``models/vision.py``) against the JAX package's, on
a tiny ViT: both converters on the same HF-layout and OpenCLIP-layout dicts (equal
exactly, through ``convert_jax.from_jax_vision_params``), the forward on the same
weights (f32, rtol/atol 2e-4), ``clip_preprocess`` (crop and squash, 1e-5),
``sniff_vision_config`` on both layouts, and the ``CLIPVisionEncode`` node."""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from comfyui_parallelanything_tpu.models import vision as jv  # noqa: E402
from comfyui_parallelanything_tpu_torch.models import vision as pv  # noqa: E402
from comfyui_parallelanything_tpu_torch.models.convert_jax import (  # noqa: E402
    from_jax_vision_params,
)

TOL = dict(rtol=2e-4, atol=2e-4)
TINY = dict(image_size=28, patch_size=7, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64, projection_dim=16)
_LAYER = {"ln1": "layer_norm1", "ln2": "layer_norm2", "q": "self_attn.q_proj",
          "k": "self_attn.k_proj", "v": "self_attn.v_proj", "out": "self_attn.out_proj",
          "fc1": "mlp.fc1", "fc2": "mlp.fc2"}


def configs(act="quick_gelu"):
    return (pv.CLIPVisionConfig(**TINY, act=act, dtype=torch.float32),
            jv.CLIPVisionConfig(**TINY, act=act, dtype=jnp.float32))


def hf_vision_layout(state: dict) -> dict:
    """A ``CLIPVisionModel`` state dict of the port in HF's ``vision_model.*``
    layout (the inverse of ``convert_clip_vision_checkpoint``)."""
    pre = "vision_model."
    out = {f"{pre}embeddings.patch_embedding.weight": state["patch_embed.weight"],
           f"{pre}embeddings.class_embedding": state["class_embedding"],
           f"{pre}embeddings.position_embedding.weight": state["pos_emb"],
           "visual_projection.weight": state["visual_proj.weight"]}
    for ln, theirs in (("pre_ln", "pre_layrnorm"), ("post_ln", "post_layernorm")):
        for leaf in ("weight", "bias"):
            out[f"{pre}{theirs}.{leaf}"] = state[f"{ln}.{leaf}"]
    for key, v in state.items():
        if key.startswith("layers."):
            _, i, mine, leaf = key.split(".")
            out[f"{pre}encoder.layers.{i}.{_LAYER[mine]}.{leaf}"] = v
    return out


def openclip_visual_layout(hf: dict, n_layers: int) -> dict:
    """An HF-layout tower in OpenCLIP's ``visual.*`` layout (fused qkv, raw proj)."""
    pre = "vision_model."
    out = {"conv1.weight": hf[f"{pre}embeddings.patch_embedding.weight"],
           "class_embedding": hf[f"{pre}embeddings.class_embedding"],
           "positional_embedding": hf[f"{pre}embeddings.position_embedding.weight"],
           "proj": hf["visual_projection.weight"].T.contiguous()}
    for mine, theirs in (("ln_pre", "pre_layrnorm"), ("ln_post", "post_layernorm")):
        for leaf in ("weight", "bias"):
            out[f"{mine}.{leaf}"] = hf[f"{pre}{theirs}.{leaf}"]
    for i in range(n_layers):
        src, dst = f"{pre}encoder.layers.{i}.", f"transformer.resblocks.{i}."
        for leaf in ("weight", "bias"):
            out[f"{dst}attn.in_proj_{leaf}"] = torch.cat(
                [hf[f"{src}self_attn.{n}_proj.{leaf}"] for n in "qkv"])
            for mine, theirs in (("attn.out_proj", "self_attn.out_proj"),
                                 ("mlp.c_fc", "mlp.fc1"), ("mlp.c_proj", "mlp.fc2"),
                                 ("ln_1", "layer_norm1"), ("ln_2", "layer_norm2")):
                out[f"{dst}{mine}.{leaf}"] = hf[f"{src}{theirs}.{leaf}"]
    return out


def random_hf_tower(act="quick_gelu", seed=0) -> dict:
    """A seeded tiny tower in the HF layout (biases and norms off their defaults)."""
    pcfg, _ = configs(act)
    gen = torch.Generator().manual_seed(seed)
    enc = pv.build_clip_vision(pcfg, device="cpu", generator=gen)
    state = enc.module.state_dict()
    for k, v in state.items():
        if k.endswith("bias") or "ln" in k:
            v.add_(0.1 * torch.randn(v.shape, generator=gen))
    return hf_vision_layout(state)


@functools.cache
def tower(act: str):
    """The seeded HF-layout tower for ``act`` and the JAX model on its converted
    weights: one per activation, shared by the module's tests (the JAX model
    compiles once per input shape)."""
    _, jcfg = configs(act)
    hf = random_hf_tower(act)
    jparams, _ = jv.convert_clip_vision_checkpoint({k: v.numpy() for k, v in hf.items()}, jcfg)
    return hf, jparams, jv.build_clip_vision(jcfg, params=jparams)


@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_forward_matches_jax(act):
    pcfg, _ = configs(act)
    hf, jparams, jm = tower(act)
    state, _ = pv.convert_clip_vision_checkpoint(hf, pcfg)
    # The converters agree exactly.
    want_state = from_jax_vision_params(jparams)
    assert set(want_state) == set(state)
    for k, v in want_state.items():
        torch.testing.assert_close(state[k], v, rtol=0, atol=0, msg=k)
    pm = pv.build_clip_vision(pcfg, device="cpu", state_dict=from_jax_vision_params(jparams))
    images = np.random.default_rng(1).standard_normal((2, 28, 28, 3)).astype(np.float32)
    for name, got, want in zip(("embeds", "last", "penultimate"), pm(torch.from_numpy(images)),
                               jm(jnp.asarray(images))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=name, **TOL)


@pytest.mark.parametrize("shape,crop", [((2, 40, 33, 3), True), ((1, 17, 50, 3), True),
                                        ((1, 30, 30, 3), False), ((20, 36, 3), True)])
def test_clip_preprocess_matches_jax(shape, crop):
    img = np.random.default_rng(2).uniform(0, 1, shape).astype(np.float32)
    got = pv.clip_preprocess(torch.from_numpy(img), size=28, crop=crop)
    # One jit program in place of an eager compile per op.
    want = jax.jit(jv.clip_preprocess, static_argnames=("size", "crop"))(
        jnp.asarray(img), size=28, crop=crop)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_openclip_layout_converts_like_jax_and_sniffs():
    hf = random_hf_tower("gelu", seed=3)
    oc = openclip_visual_layout(hf, TINY["num_layers"])
    jparams, jcfg = jv.convert_clip_vision_checkpoint({k: v.numpy() for k, v in oc.items()})
    state, cfg = pv.convert_clip_vision_checkpoint(oc)
    for k, v in from_jax_vision_params(jparams).items():
        torch.testing.assert_close(state[k], v, rtol=0, atol=0, msg=k)
    # Sniffed from either layout: the same tower on both sides (heads by the
    # fallback rule at this width; act by width).
    hf_cfg = pv.sniff_vision_config(hf)
    assert cfg == hf_cfg
    assert dataclasses.asdict(cfg) | {"dtype": None} == \
        dataclasses.asdict(jcfg) | {"dtype": None}
    assert (cfg.image_size, cfg.patch_size, cfg.hidden_size, cfg.num_layers,
            cfg.intermediate_size, cfg.projection_dim, cfg.act) == (28, 7, 32, 2, 64, 16,
                                                                    "quick_gelu")
    with pytest.raises(KeyError, match="unrecognized"):
        pv.openclip_visual_to_hf({"attnpool.weird": torch.zeros(1)})


@pytest.mark.parametrize("hidden,layers,heads", [(768, 12, 12), (1024, 24, 16),
                                                 (1280, 32, 16), (1664, 48, 16)])
def test_sniff_head_table_matches_jax(hidden, layers, heads):
    def fake(zeros):
        grid = 16 * 16
        return {"vision_model.embeddings.patch_embedding.weight": zeros((hidden, 3, 14, 14)),
                "vision_model.embeddings.position_embedding.weight": zeros((grid + 1, hidden)),
                "vision_model.encoder.layers.0.mlp.fc1.weight": zeros((hidden * 4, hidden)),
                f"vision_model.encoder.layers.{layers - 1}.mlp.fc1.weight":
                    zeros((hidden * 4, hidden))}

    cfg = pv.sniff_vision_config(fake(lambda s: torch.empty(s, device="meta")))
    jcfg = jv.sniff_vision_config(fake(lambda s: np.zeros(s, np.float32)))
    assert cfg.num_heads == jcfg.num_heads == heads
    assert (cfg.image_size, cfg.num_layers, cfg.act) == (jcfg.image_size, jcfg.num_layers,
                                                         jcfg.act)


def test_vision_encode_node_matches_jax():
    from comfyui_parallelanything_tpu import nodes as jn
    from comfyui_parallelanything_tpu_torch import nodes as pn

    pcfg, _ = configs()
    hf, _, jm = tower("quick_gelu")
    jwire = {"model": jm}
    pwire = {"model": pv.load_clip_vision_checkpoint(hf, pcfg, device="cpu")}
    # Batch 2: the forward's shape in test_forward_matches_jax, compiled once.
    img = np.random.default_rng(5).uniform(0, 1, (2, 40, 40, 3)).astype(np.float32)
    for crop in ("center", "none"):
        (want,) = jn.NODE_CLASS_MAPPINGS["CLIPVisionEncode"]().encode(jwire, jnp.asarray(img),
                                                                      crop)
        (got,) = pn.NODE_CLASS_MAPPINGS["CLIPVisionEncode"]().encode(pwire,
                                                                     torch.from_numpy(img), crop)
        assert set(got) == set(want) == {"image_embeds", "last_hidden", "penultimate"}
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **TOL)
