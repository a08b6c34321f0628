"""Parity of the PyTorch port's Wan nodes against the JAX package on the CPU, on the
tiny Wan world of ``tests/test_torch_wan_pipeline.py`` (whose helpers build it):
``TPUEmptyVideoLatent`` and ``EmptyHunyuanLatentVideo``; ``TPUVAEDecode`` /
``TPUVAEEncode`` on 5-D latents; the Wan checkpoint loader node and ``VAELoader`` on
Wan files in the public layouts; and ``WanImageToVideo`` into ``TPUKSampler``, with
the same noise on both sides. f32 on both sides, rtol/atol 2e-4.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_quick_jax import quick_jax_compiles  # noqa: E402,F401
from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import comfyui_parallelanything_tpu.models as jmodels  # noqa: E402
from comfyui_parallelanything_tpu import nodes as jnodes  # noqa: E402
from comfyui_parallelanything_tpu import nodes_compat as jcompat  # noqa: E402
from comfyui_parallelanything_tpu.models import video_vae as jvv  # noqa: E402
from comfyui_parallelanything_tpu.models import wan as jwan  # noqa: E402
import comfyui_parallelanything_tpu_torch.models as pmodels  # noqa: E402
from comfyui_parallelanything_tpu_torch import nodes as pnodes  # noqa: E402
from comfyui_parallelanything_tpu_torch import nodes_compat as pcompat  # noqa: E402
from comfyui_parallelanything_tpu_torch.models import video_vae as pvv  # noqa: E402
from comfyui_parallelanything_tpu_torch.models import wan as pwan  # noqa: E402
from comfyui_parallelanything_tpu_torch.models.convert_jax import (  # noqa: E402
    from_jax_video_vae_params,
    from_jax_wan_params,
)
from comfyui_parallelanything_tpu_torch.models.loader import save_safetensors  # noqa: E402

from test_convert_wan import _official_layout_sd as _wan_public  # noqa: E402
from test_torch_wan_pipeline import (  # noqa: E402,F401
    I2V,
    TOL,
    WAN,
    VIDEO,
    ZC,
    _hermetic,
    _numpy_noise,
    _same,
    _vae_pair,
    _video,
    _wan_pair,
)
from test_video_vae import _official_layout_sd as _vae_public  # noqa: E402


@pytest.fixture(scope="module")
def world():
    jv, pv, vtree = _vae_pair()
    ji2v, pi2v, i2v_tree = _wan_pair(4, **I2V)
    return {
        "trees": {"i2v": i2v_tree, "vae": vtree},
        "models": {"i2v": (ji2v, pi2v), "vae": (jv, pv)},
    }


def test_empty_video_latent_nodes_match_jax():
    for frames in (1, 9, 81):
        (got,) = pnodes.TPUEmptyVideoLatent().generate(64, 32, frames, 2, device="cpu")
        (want,) = jnodes.TPUEmptyVideoLatent().generate(64, 32, frames, 2)
        assert tuple(got["samples"].shape) == want["samples"].shape
        assert not got["samples"].any()
    with pytest.raises(ValueError, match="1 mod"):
        pnodes.TPUEmptyVideoLatent().generate(64, 32, 8, 1, device="cpu")
    for length in (25, 27, 1):
        (got,) = pcompat.EmptyHunyuanLatentVideo().generate(848, 480, length, device="cpu")
        (want,) = jcompat.EmptyHunyuanLatentVideo().generate(848, 480, length)
        assert tuple(got["samples"].shape) == want["samples"].shape


def test_vae_nodes_handle_video(world):
    jv, pv = world["models"]["vae"]
    z = np.random.default_rng(5).normal(size=(1, 3, 4, 4, ZC)).astype(np.float32)
    (got,) = pnodes.TPUVAEDecode().decode(pv, {"samples": torch.from_numpy(z)})
    (want,) = jnodes.TPUVAEDecode().decode(jv, {"samples": jnp.asarray(z)})
    _same(got, want)
    (tiled,) = pnodes.TPUVAEDecode().decode(pv, {"samples": torch.from_numpy(z)}, tile_size=2)
    assert tiled.shape == VIDEO
    (lat,) = pnodes.TPUVAEEncode().encode(pv, got)
    np.testing.assert_allclose(lat["samples"].numpy(),
                               np.asarray(jv.encode(jnp.asarray(want) * 2.0 - 1.0)), **TOL)


@pytest.fixture
def wan_files(world, tmp_path, monkeypatch):
    """The i2v DiT and the VAE in the public layouts as .safetensors files, and both
    packages' Wan presets patched to the tiny configs."""
    jm, pm = world["models"]["i2v"]
    ckpt = str(tmp_path / "wan_i2v.safetensors")
    save_safetensors(ckpt, {k: torch.from_numpy(np.array(v)) for k, v in
                            _wan_public(jm.config, world["trees"]["i2v"]).items()})
    jv, pv = world["models"]["vae"]
    vae = str(tmp_path / "wan_vae.safetensors")
    save_safetensors(vae, {k: torch.from_numpy(np.array(v)) for k, v in
                           _vae_public(jv.cfg, world["trees"]["vae"]).items()})
    jbase = jwan.WanConfig(**WAN, in_channels=ZC, dtype=jnp.float32)
    pbase = pwan.WanConfig(**WAN, in_channels=ZC, dtype=torch.float32)
    monkeypatch.setattr(jmodels, "wan_1_3b_config", lambda: jbase)
    monkeypatch.setattr(pmodels, "wan_1_3b_config", lambda: pbase)
    monkeypatch.setattr(jvv, "wan_vae_config", lambda: jv.cfg)
    monkeypatch.setattr(pvv, "wan_vae_config", lambda: pv.cfg)
    return ckpt, vae


def _state(module):
    return {k: v.detach() for k, v in module.state_dict().items()}


def test_checkpoint_and_vae_loader_nodes_load_wan_files(world, wan_files):
    ckpt, vae = wan_files
    got, got_vae = pnodes.TPUCheckpointLoader().load(ckpt, "wan-1.3b", vae_path=vae,
                                                     device="cpu")
    want, want_vae = jnodes.TPUCheckpointLoader().load(ckpt, "wan-1.3b", vae_path=vae)
    # The i2v width and the CLIP branch are sniffed from the file.
    assert (got.config.in_channels, got.config.img_dim) == (12, 24)
    assert (want.config.in_channels, want.config.img_dim) == (12, 24)
    ref = from_jax_wan_params(jax.tree.map(np.asarray, want.params))
    state = _state(got.module)
    assert set(state) == set(ref)
    for k in ref:
        assert torch.equal(state[k], ref[k]), k
    ref = from_jax_video_vae_params(jax.tree.map(np.asarray, want_vae.params))
    for loaded in (got_vae, pcompat.VAELoader().load(vae, device="cpu")[0]):
        assert isinstance(loaded, pvv.VideoVAE)
        state = _state(loaded.module)
        for k in ref:
            assert torch.equal(state[k], ref[k]), k
    with pytest.raises(ValueError, match="vae_path"):
        pnodes.TPUCheckpointLoader().load(ckpt, "wan-1.3b", device="cpu")


def test_wan_image_to_video_node_samples_like_jax(world, monkeypatch):
    jm, pm = world["models"]["i2v"]
    jv, pv = world["models"]["vae"]
    monkeypatch.setattr(jax.random, "normal", lambda key, shape=(), dtype=jnp.float32:
                        jnp.asarray(_numpy_noise(shape, 17), dtype))
    monkeypatch.setattr(pnodes, "initial_noise",
                        lambda seed, shape, device: torch.from_numpy(_numpy_noise(shape, 17)))
    ctx = np.random.default_rng(6).normal(size=(1, 6, 32)).astype(np.float32)
    image = _video(7, (1, 16, 16, 3))
    fea = np.random.default_rng(8).normal(size=(1, 5, 24)).astype(np.float32)
    got = pcompat.WanImageToVideo().encode(
        {"context": torch.from_numpy(ctx)}, {"context": torch.zeros(1, 6, 32)}, pv, 16, 16, 5,
        1, start_image=torch.from_numpy(image),
        clip_vision_output={"penultimate": torch.from_numpy(fea)})
    want = jcompat.WanImageToVideo().encode(
        {"context": jnp.asarray(ctx)}, {"context": jnp.zeros((1, 6, 32))}, jv, 16, 16, 5, 1,
        start_image=jnp.asarray(image), clip_vision_output={"penultimate": jnp.asarray(fea)})
    assert got[2]["samples"].shape == want[2]["samples"].shape == (1, 3, 4, 4, ZC)
    np.testing.assert_allclose(got[0]["i2v"]["cond"].numpy(),
                               np.asarray(want[0]["i2v"]["cond"]), **TOL)
    assert got[1]["i2v"] is got[0]["i2v"]
    kw = dict(seed=0, steps=2, cfg=3.0, sampler_name="euler", scheduler="normal")
    (out,) = pnodes.TPUKSampler().sample(pm, got[0], got[2], negative=got[1], **kw)
    (ref,) = jnodes.TPUKSampler().sample(jm, want[0], want[2], negative=want[1], **kw)
    np.testing.assert_allclose(out["samples"].numpy(), np.asarray(ref["samples"]), **TOL)
