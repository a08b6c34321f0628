"""Parity of the PyTorch port's causal video VAE (``models/video_vae.py``), its
converter and loader against the JAX package on the CPU, at the JAX tests' tiny
size (base 8 channels, two levels, one res block, 4-channel latent; 4× spatial and
2× temporal compression).

Weights are numpy draws for the JAX module's abstract parameter tree; the port takes
them through ``convert_jax.from_jax_video_vae_params`` or, for the converter case,
through the public Wan2.x VAE layout that ``tests/test_video_vae._official_layout_sd``
writes from the same tree. Both sides run in f32 and must agree to rtol/atol 2e-4.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_quick_jax import quick_jax_compiles  # noqa: E402,F401
from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from comfyui_parallelanything_tpu.models import video_vae as jvv  # noqa: E402
from comfyui_parallelanything_tpu_torch.models import loader as pload  # noqa: E402
from comfyui_parallelanything_tpu_torch.models import video_vae as pvv  # noqa: E402
from comfyui_parallelanything_tpu_torch.models.convert_jax import (  # noqa: E402
    from_jax_video_vae_params,
)
from comfyui_parallelanything_tpu_torch.models.convert_wan_vae import (  # noqa: E402
    convert_wan_vae_checkpoint,
)

from test_video_vae import _official_layout_sd  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
TINY = dict(base_channels=8, channel_mult=(1, 2, 2), num_res_blocks=1,
            temporal_downsample=(False, True), z_channels=4,
            latent_mean=(0.1, -0.2, 0.3, 0.0), latent_std=(1.5, 0.5, 2.0, 1.0))
HW = 16


def _numpy_tree(abstract, seed=0):
    """Random weights: convolution kernels N(0, 1/fan_in), every other leaf off its
    init value (norm scales about 1, biases about 0)."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(a.shape[:-1]))
            return (rng.normal(size=a.shape) / np.sqrt(fan_in)).astype(np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + 0.1 * rng.normal(size=a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, abstract)


def _clip(frames, seed=1):
    return np.random.default_rng(seed).uniform(-1, 1, size=(1, frames, HW, HW, 3)).astype(
        np.float32)


@pytest.fixture(scope="module")
def pair():
    jcfg = jvv.VideoVAEConfig(**TINY, dtype=jnp.float32)
    module = jvv.VideoAutoencoderKL(jcfg)
    abstract = jax.eval_shape(module.init, jax.random.key(0),
                              jnp.zeros((1, 5, HW, HW, 3)))["params"]
    tree = _numpy_tree(abstract)
    jv = jvv.build_video_vae(jcfg, params=jax.tree.map(jnp.asarray, tree))
    pv = pvv.build_video_vae(pvv.VideoVAEConfig(**TINY, dtype=torch.float32), device="cpu",
                             state_dict=from_jax_video_vae_params(tree))
    latents = {t: np.array(jv.encode(jnp.asarray(_clip(t)))) for t in (1, 5)}
    return jv, pv, tree, latents


@pytest.mark.parametrize("frames", [1, 5])
def test_encode_and_decode_match_jax(pair, frames):
    jv, pv, _, latents = pair
    z = pv.encode(torch.from_numpy(_clip(frames)))
    t_lat = pv.cfg.latent_frames(frames)
    assert z.shape == (1, t_lat, HW // 4, HW // 4, 4) and t_lat == (1 if frames == 1 else 3)
    np.testing.assert_allclose(z.numpy(), latents[frames], **TOL)
    want = np.asarray(jv.decode(jnp.asarray(latents[frames])))
    got = pv.decode(torch.from_numpy(latents[frames]))
    assert got.shape == (1, frames, HW, HW, 3)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_config_math_matches_jax():
    j, p = jvv.wan_vae_config(), pvv.wan_vae_config()
    assert (p.spatial_factor, p.temporal_factor) == (j.spatial_factor, j.temporal_factor)
    assert p.latent_mean == j.latent_mean and p.latent_std == j.latent_std
    assert [p.latent_frames(t) for t in (1, 5, 81)] == [j.latent_frames(t) for t in (1, 5, 81)]
    with pytest.raises(ValueError, match="1 mod 4"):
        p.latent_frames(80)


def test_encode_is_causal(pair):
    # Changing pixel frames from t on leaves every latent frame that folds only
    # frames before t unchanged, bit for bit (front-only time padding).
    _, pv, _, _ = pair
    x = _clip(5)
    y = x.copy()
    y[:, 3:] = _clip(2, seed=9)
    a, b = (pv.encode(torch.from_numpy(v)) for v in (x, y))
    assert torch.equal(a[:, :2], b[:, :2])  # latent frames 0 and 1 fold pixels 0..2
    assert not torch.allclose(a[:, 2:], b[:, 2:])
    za = a.clone()
    za[:, 2:] += 1.0
    assert torch.equal(pv.decode(a)[:, :3], pv.decode(za)[:, :3])


def test_decode_tiled_matches_jax(pair):
    jv, pv, _, _ = pair
    # Three latent frames: each 4 × 4 tile reuses the compiled decode of the T = 5 case.
    z = np.random.default_rng(3).normal(size=(1, 3, 6, 6, 4)).astype(np.float32)
    want = np.asarray(jv.decode_tiled(jnp.asarray(z), tile=4, overlap=2))
    got = pv.decode_tiled(torch.from_numpy(z), tile=4, overlap=2)
    assert got.shape == (1, 5, 24, 24, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    small = pv.decode_tiled(torch.from_numpy(z[:, :, :4, :4]), tile=4)  # one tile: no tiling
    torch.testing.assert_close(small, pv.decode(torch.from_numpy(z[:, :, :4, :4])))


def test_converter_and_loader_from_the_public_layout(pair):
    jv, pv, tree, latents = pair
    sd = _official_layout_sd(jv.cfg, tree)
    state = convert_wan_vae_checkpoint(sd, pv.cfg)
    ref = from_jax_video_vae_params(tree)
    assert set(state) == set(ref)
    for k in ref:
        assert torch.equal(state[k], ref[k]), k
    loaded = pload.load_wan_vae_checkpoint({f"vae.{k}": v for k, v in sd.items()}, pv.cfg,
                                           device="cpu")
    np.testing.assert_allclose(loaded.encode(torch.from_numpy(_clip(5))).numpy(),
                               latents[5], **TOL)
    # The attention norm's missing bias zero-fills; a foreign layout raises.
    no_bias = {k: v for k, v in sd.items() if k != "decoder.middle.1.norm.bias"}
    assert not convert_wan_vae_checkpoint(no_bias, pv.cfg)["decoder.mid_attn_1.norm.bias"].any()
    with pytest.raises(ValueError, match="Wan2.x VAE layout"):
        pload.load_wan_vae_checkpoint({"encoder.conv1.weight": sd["encoder.conv1.weight"]},
                                      pv.cfg, device="cpu")


def test_frame_chunks_change_no_value(pair, monkeypatch):
    # Above CHUNK_ELEMS the convolutions, norms and resamples run a chunk of frames at
    # a time (the causal ones with their own frames of context): forced down to a
    # frame or two here, encode and decode give what the whole-clip pass gives.
    _, pv, _, latents = pair
    x = torch.from_numpy(_clip(5))
    z = torch.from_numpy(latents[5])
    whole = pv.encode(x), pv.decode(z)
    monkeypatch.setattr(pvv, "CHUNK_ELEMS", 3000)
    chunked = pv.encode(x), pv.decode(z)
    for got, want in zip(chunked, whole):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
