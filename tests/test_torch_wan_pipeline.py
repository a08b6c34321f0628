"""Parity of the PyTorch port's ``WanVideoPipeline`` against the JAX package on the
CPU, on the tiny Wan world of ``tests/test_wan_pipeline.py`` (a Wan DiT of width 48
and depth 1, a 2-level video VAE with a 4-channel latent, 4× spatial and 2×
temporal compression, T5 2 × 32): text→video with CFG, video→video, video
inpainting and the Wan2.2 expert pair, with the same noise on both sides; and the
frame, resolution and model-mismatch errors. Image→video and the Wan nodes are in
``tests/test_torch_wan_i2v.py`` and ``tests/test_torch_wan_nodes.py``, which build
their worlds from this file's helpers.

Weights are numpy draws for the JAX models' abstract trees, the port's through
``convert_jax``; the noise is one seeded numpy draw patched into both packages
(``jax.random.normal`` and the port's ``initial_noise``), which also spares the
file a compile of JAX's threefry sampler. f32 on both sides, rtol/atol 2e-4.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_quick_jax import quick_jax_compiles  # noqa: E402,F401
from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from comfyui_parallelanything_tpu import pipelines as jpipe  # noqa: E402
from comfyui_parallelanything_tpu.models import text_encoders as jte  # noqa: E402
from comfyui_parallelanything_tpu.models import video_vae as jvv  # noqa: E402
from comfyui_parallelanything_tpu.models import wan as jwan  # noqa: E402
from comfyui_parallelanything_tpu_torch import parallelize  # noqa: E402
from comfyui_parallelanything_tpu_torch import pipelines as ppipe  # noqa: E402
from comfyui_parallelanything_tpu_torch.models import text_encoders as pte  # noqa: E402
from comfyui_parallelanything_tpu_torch.models import video_vae as pvv  # noqa: E402
from comfyui_parallelanything_tpu_torch.models import wan as pwan  # noqa: E402
from comfyui_parallelanything_tpu_torch.models.convert_jax import (  # noqa: E402
    from_jax_text_params,
    from_jax_video_vae_params,
    from_jax_wan_params,
)
from comfyui_parallelanything_tpu_torch.utils.tokenizer import CLIPBPETokenizer  # noqa: E402

from test_tokenizer import _tiny_tokenizer  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
ZC = 4
WAN = dict(out_channels=ZC, hidden_size=48, ffn_dim=96, num_heads=4, depth=1, text_dim=32,
           freq_dim=16)
I2V = dict(in_channels=2 * ZC + 4, img_dim=24)
VAE = dict(base_channels=8, channel_mult=(1, 2, 2), num_res_blocks=1,
           temporal_downsample=(False, True), z_channels=ZC, latent_mean=(0.0,) * ZC,
           latent_std=(1.0,) * ZC)
T5 = dict(vocab_size=64, d_model=32, d_kv=8, d_ff=64, num_layers=2, num_heads=4)
CALL = dict(steps=2, height=16, width=16, frames=5)
CFG = dict(negative_prompt="world", cfg_scale=5.0)  # one batch-2 forward: one JAX program
VIDEO = (1, 5, 16, 16, 3)


@pytest.fixture(autouse=True)
def _hermetic(monkeypatch, tmp_path):
    monkeypatch.setenv("PA_PLANNER", "0")
    monkeypatch.setenv("PA_LEDGER_DIR", str(tmp_path / "ledger"))
    monkeypatch.setenv("PA_EVIDENCE_DIR", str(tmp_path / "evidence"))


def _numpy_tree(abstract, seed, conv=False):
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(a.shape[:-1])) if conv else a.shape[0]
            return (rng.normal(size=a.shape) / np.sqrt(fan_in)).astype(np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + 0.1 * rng.normal(size=a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, abstract)


def _wan_pair(seed, **extra):
    jcfg = jwan.WanConfig(**WAN, **{"in_channels": ZC, **extra}, dtype=jnp.float32)
    kw = {"clip_fea": jnp.zeros((1, 5, extra["img_dim"]))} if "img_dim" in extra else {}
    abstract = jax.eval_shape(jwan.WanModel(jcfg).init, jax.random.key(0),
                              jnp.zeros((1, 2, 4, 4, jcfg.in_channels)), jnp.zeros((1,)),
                              jnp.zeros((1, 6, 32)), **kw)["params"]
    tree = _numpy_tree(abstract, seed)
    jm = jwan.build_wan(jcfg, params=jax.tree.map(jnp.asarray, tree))
    pm = pwan.build_wan(pwan.WanConfig(**WAN, **{"in_channels": ZC, **extra},
                                       dtype=torch.float32),
                        device="cpu", state_dict=from_jax_wan_params(tree))
    return jm, pm, tree


def _vae_pair():
    vcfg = jvv.VideoVAEConfig(**VAE, dtype=jnp.float32)
    vtree = _numpy_tree(jax.eval_shape(jvv.VideoAutoencoderKL(vcfg).init, jax.random.key(0),
                                       jnp.zeros((1, 5, 16, 16, 3)))["params"], 1, conv=True)
    jv = jvv.build_video_vae(vcfg, params=jax.tree.map(jnp.asarray, vtree))
    pv = pvv.build_video_vae(pvv.VideoVAEConfig(**VAE, dtype=torch.float32), device="cpu",
                             state_dict=from_jax_video_vae_params(vtree))
    return jv, pv, vtree


def _text_encoders():
    """The JAX and the port's T5 pipeline arguments: encoder and tokenizer each."""
    jtok = _tiny_tokenizer()
    ptok = CLIPBPETokenizer(jtok.vocab, sorted(jtok.ranks, key=jtok.ranks.get), max_len=8)
    tcfg = jte.T5Config(**T5, dtype=jnp.float32)
    ttree = _numpy_tree(jax.eval_shape(jte.T5Encoder(tcfg).init, jax.random.key(0),
                                       jnp.zeros((1, 8), jnp.int32))["params"], 2)
    jt5 = jte.build_t5_encoder(tcfg, params=jax.tree.map(jnp.asarray, ttree))
    pt5 = pte.build_t5_encoder(pte.T5Config(**T5, dtype=torch.float32), device="cpu",
                               state_dict=from_jax_text_params(ttree))
    return dict(t5=jt5, t5_tokenizer=jtok), dict(t5=pt5, t5_tokenizer=ptok)


@pytest.fixture(scope="module")
def world():
    jv, pv, vtree = _vae_pair()
    jtext, ptext = _text_encoders()
    jt2v, pt2v, t2v_tree = _wan_pair(3)
    # The i2v DiT of the contract checks, which fail before any forward: port only.
    pi2v = pwan.build_wan(pwan.WanConfig(**WAN, **I2V, dtype=torch.float32), device="cpu",
                          generator=torch.Generator().manual_seed(4))
    return {
        "t2v": (jpipe.WanVideoPipeline(dit=jt2v, vae=jv, **jtext),
                ppipe.WanVideoPipeline(dit=parallelize(pt2v, [("cpu", 100)]), vae=pv,
                                       **ptext)),
        "i2v_port": ppipe.WanVideoPipeline(dit=pi2v, vae=pv, **ptext),
        "models": {"t2v": (jt2v, pt2v)},
    }


def _numpy_noise(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.fixture
def same_noise(monkeypatch):
    monkeypatch.setattr(jax.random, "normal", lambda key, shape=(), dtype=jnp.float32:
                        jnp.asarray(_numpy_noise(shape), dtype))
    monkeypatch.setattr(ppipe, "initial_noise", lambda shape, generator, device:
                        torch.from_numpy(_numpy_noise(shape)).to(device))


def _video(seed, shape=VIDEO):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


def _same(got, want):
    assert tuple(got.shape) == tuple(np.shape(want)) and got.dtype == torch.float32
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_t2v_with_cfg_matches_jax(world, same_noise):
    jp, pp = world["t2v"]
    kw = dict(CALL, **CFG)
    _same(pp("hello world", **kw), jp("hello world", **kw))


def test_v2v_and_inpaint_match_jax(world, same_noise):
    jp, pp = world["t2v"]
    init = _video(1)
    kw = dict(CALL, **CFG)
    _same(pp("hello", init_video=init, denoise=0.5, **kw),
          jp("hello", init_video=jnp.asarray(init), denoise=0.5, **kw))
    # A (B, T, H, W) mask resized over time to the 3 latent frames.
    mask = (np.arange(16)[None, None, :, None] < 8) * np.ones((1, 5, 16, 16))
    mask = mask.astype(np.float32)
    _same(pp("hello", init_video=init, mask=mask, **kw),
          jp("hello", init_video=jnp.asarray(init), mask=jnp.asarray(mask), **kw))


def test_expert_pair_matches_jax(world, same_noise):
    # Wan2.2 A14B: the t2v DiT as the high-noise expert and a second one for the low
    # noise; with 4 flow steps at shift 5 the boundary 0.875 splits them 2 + 2.
    jp, pp = world["t2v"]
    # The low-noise expert is the t2v DiT with other weights, so the JAX side reuses
    # the t2v DiT's compiled forward.
    jt2v, pt2v = world["models"]["t2v"]
    tree = _numpy_tree(jax.tree.map(np.asarray, jt2v.params), 5)
    jlow = dataclasses.replace(jt2v, params=jax.tree.map(jnp.asarray, tree))
    plow = pwan.build_wan(pt2v.config, device="cpu", state_dict=from_jax_wan_params(tree))
    kw = dict(CALL, **CFG, steps=4)
    j2 = dataclasses.replace(jp, dit_low_noise=jlow)
    p2 = dataclasses.replace(pp, dit_low_noise=plow)
    got = p2("hello", **kw)
    _same(got, j2("hello", **kw))
    # The switch picks its expert on the host each step, so compile_loop=True runs
    # the eager loop: the same video.
    assert torch.equal(p2("hello", compile_loop=True, **kw), got)


def test_contracts(world):
    _, pp = world["t2v"]
    pi = world["i2v_port"]
    with pytest.raises(ValueError, match="1 mod 2"):
        pp("hello", **{**CALL, "frames": 4})
    with pytest.raises(ValueError, match="multiples of 8/8"):
        pp("hello", **{**CALL, "height": 12})
    with pytest.raises(ValueError, match="i2v checkpoint"):
        pp("hello", image=_video(4, (1, 16, 16, 3)), **CALL)
    with pytest.raises(ValueError, match="image is"):
        pi("hello", image=_video(4, (1, 8, 8, 3)), **CALL)
    with pytest.raises(ValueError, match="start image"):
        pi("hello", clip_vision_output={"penultimate": np.zeros((1, 5, 24), np.float32)},
           **CALL)
    with pytest.raises(ValueError, match="init_video"):
        pp("hello", denoise=0.5, **CALL)
    with pytest.raises(ValueError, match="requires init_video"):
        pp("hello", mask=np.ones((1, 5, 16, 16), np.float32), **CALL)
    with pytest.raises(ValueError, match="video latent"):
        pp("hello", init_video=_video(1), mask=np.ones((16, 16), np.float32), **CALL)
    clipless = dataclasses.replace(pi, dit=pwan.build_wan(
        pwan.WanConfig(**WAN, in_channels=2 * ZC + 4, dtype=torch.float32), device="cpu",
        generator=torch.Generator().manual_seed(0)))
    with pytest.raises(ValueError, match="img_emb"):
        clipless("hello", image=_video(4, (1, 16, 16, 3)),
                 clip_vision_output={"penultimate": np.zeros((1, 5, 24), np.float32)},
                 **CALL)
