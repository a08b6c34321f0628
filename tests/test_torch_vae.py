"""Parity of the PyTorch port's VAE (``models/vae.py``), its tiling and its
checkpoint converter against the JAX package on the CPU, on a tiny config
(2 levels of 32/64 channels, one res block each).

The same numpy weights (a flax tree made from a seed) go to both sides, the port
through ``convert_jax.from_jax_vae_params``; the same NHWC pixels and latents go
in. Both run in f32 (the JAX side under the suite's ``highest`` matmul precision)
and must agree to rtol/atol 2e-4. The posterior sample's noise is the one
``jax.random.normal`` drew, patched into the port, since torch's generators cannot
reproduce JAX's keys.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from comfyui_parallelanything_tpu.models import convert_vae as jcv  # noqa: E402
from comfyui_parallelanything_tpu.models import tiling as jtiling  # noqa: E402
from comfyui_parallelanything_tpu.models import vae as jvae  # noqa: E402
from comfyui_parallelanything_tpu_torch.models import convert_vae as pcv  # noqa: E402
from comfyui_parallelanything_tpu_torch.models import tiling as ptiling  # noqa: E402
from comfyui_parallelanything_tpu_torch.models import vae as pvae  # noqa: E402
from comfyui_parallelanything_tpu_torch.models.convert_jax import (  # noqa: E402
    from_jax_vae_params,
)

TOL = dict(rtol=2e-4, atol=2e-4)
TINY = dict(base_channels=32, channel_mult=(1, 2), num_res_blocks=1, norm_groups=8)
CONFIGS = {
    "sd": dict(TINY, z_channels=4),  # quant convs, no shift
    "flux": dict(TINY, z_channels=16, scaling_factor=0.3611, shift_factor=0.1159,
                 use_quant_conv=False),
}


def _numpy_tree(abstract, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(a.shape[:-1]))
            return (rng.normal(size=a.shape) / np.sqrt(fan_in)).astype(np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + 0.1 * rng.normal(size=a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, abstract)


@pytest.fixture(scope="class", params=sorted(CONFIGS))
def pair(request):
    kw = CONFIGS[request.param]
    jcfg = jvae.VAEConfig(**kw, dtype=jnp.float32)
    abstract = jax.eval_shape(jvae.AutoencoderKL(jcfg).init, jax.random.key(0),
                              jnp.zeros((1, 16, 16, 3)))["params"]
    tree = _numpy_tree(abstract, seed=len(request.param))
    jv = jvae.build_vae(jcfg, params=jax.tree.map(jnp.asarray, tree))
    pv = pvae.build_vae(pvae.VAEConfig(**kw, dtype=torch.float32), device="cpu",
                        state_dict=from_jax_vae_params(tree))
    return jv, pv


def _images(seed, shape):
    return np.random.default_rng(seed).uniform(-1, 1, size=shape).astype(np.float32)


class TestVAE:
    def test_encode_decode_match_jax(self, pair):
        jv, pv = pair
        x = _images(1, (2, 16, 12, 3))
        want = np.asarray(jv.encode(jnp.asarray(x)))
        got = pv.encode(torch.from_numpy(x))
        assert got.shape == want.shape == (2, 8, 6, pv.cfg.z_channels)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        z = np.random.default_rng(2).normal(size=want.shape).astype(np.float32)
        want_img = np.asarray(jv.decode(jnp.asarray(z)))
        got_img = pv.decode(z)  # numpy in: moved to the module's device
        assert got_img.shape == (2, 16, 12, 3)
        np.testing.assert_allclose(got_img.numpy(), want_img, **TOL)

    def test_posterior_sample_matches_jax(self, pair, monkeypatch):
        jv, pv = pair
        x = _images(3, (1, 16, 16, 3))
        # An rbg key: its normal draw compiles in a fraction of threefry's time.
        key = jax.random.key(7, impl="rbg")
        shape = (1, 8, 8, pv.cfg.z_channels)
        drawn = np.array(jax.random.normal(key, shape, jnp.float32))
        calls = []

        def patched(shp, dtype, device, generator):
            calls.append(generator)
            assert tuple(shp) == shape and dtype == torch.float32
            return torch.from_numpy(drawn)

        monkeypatch.setattr(pvae, "posterior_noise", patched)
        gen = torch.Generator().manual_seed(0)
        want = np.asarray(jv.encode(jnp.asarray(x), key))
        got = pv.encode(torch.from_numpy(x), rng=gen)
        assert calls == [gen]
        # mean + exp(logvar / 2)·noise: the posterior mean is held by the test above.
        np.testing.assert_allclose(got.numpy(), want, **TOL)

    @pytest.mark.parametrize("tile,overlap", [(8, 2), (6, 0), (5, 4)])
    def test_decode_tiled_matches_jax(self, pair, tile, overlap):
        jv, pv = pair
        z = np.random.default_rng(4).normal(size=(1, 10, 13, pv.cfg.z_channels)).astype(
            np.float32)
        want = np.asarray(jv.decode_tiled(jnp.asarray(z), tile=tile, overlap=overlap))
        got = pv.decode_tiled(torch.from_numpy(z), tile=tile, overlap=overlap)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, **TOL)

    @pytest.mark.parametrize("tile,overlap", [(8, 2), (10, 4)])
    def test_encode_tiled_matches_jax(self, pair, tile, overlap):
        jv, pv = pair
        x = _images(5, (1, 20, 26, 3))
        want = np.asarray(jv.encode_tiled(jnp.asarray(x), tile=tile, overlap=overlap))
        got = pv.encode_tiled(torch.from_numpy(x), tile=tile, overlap=overlap)
        np.testing.assert_allclose(got.numpy(), want, **TOL)

    def test_maybe_tiled_dispatch_and_contracts(self, pair):
        jv, pv = pair
        x = _images(6, (1, 20, 20, 3))
        np.testing.assert_allclose(
            pvae.encode_maybe_tiled(pv, torch.from_numpy(x), tile=9).numpy(),
            np.asarray(jvae.encode_maybe_tiled(jv, jnp.asarray(x), tile=9)), **TOL)
        z = np.random.default_rng(7).normal(size=(1, 10, 10, pv.cfg.z_channels))
        z = z.astype(np.float32)
        np.testing.assert_allclose(
            pvae.decode_maybe_tiled(pv, torch.from_numpy(z), tile=8).numpy(),
            np.asarray(jvae.decode_maybe_tiled(jv, jnp.asarray(z), tile=8)), **TOL)
        assert pvae.decode_maybe_tiled(pv, torch.from_numpy(z)).shape == (1, 20, 20, 3)
        with pytest.raises(ValueError, match="multiples"):
            pv.encode_tiled(torch.from_numpy(x), tile=7, overlap=2)
        with pytest.raises(ValueError, match="overlap"):
            pv.decode_tiled(torch.from_numpy(z), tile=4, overlap=4)
        assert pv.spatial_factor == jv.spatial_factor == 2


def test_images_masks_and_tiling_helpers_match_jax():
    img = np.random.default_rng(8).uniform(-1.5, 1.5, size=(2, 5, 4, 3)).astype(np.float32)
    out = pvae.vae_output_to_images(torch.from_numpy(img))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jvae.vae_output_to_images(img)))
    np.testing.assert_array_equal(pvae.images_to_vae_input(out).numpy(),
                                  np.asarray(jvae.images_to_vae_input(np.asarray(out))))
    mask = (np.random.default_rng(9).uniform(size=(2, 16, 12)) > 0.5).astype(np.float32)
    for hw, method in (((4, 3), "nearest"), ((4, 3), "bilinear"), ((32, 24), "nearest"),
                       ((16, 12), "nearest")):
        want = np.asarray(jvae.normalize_mask(mask, hw, method))
        got = pvae.normalize_mask(mask, hw, method)
        assert got.shape == want.shape == (2, *hw, 1)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert pvae.normalize_mask(mask[0], (16, 12)).shape == (1, 16, 12, 1)
    for size, tile, stride in ((10, 4, 3), (4, 8, 2), (17, 5, 5), (9, 9, 1)):
        assert ptiling.tile_starts(size, tile, stride) == jtiling.tile_starts(size, tile, stride)
    for tile, overlap, factor in ((8, 2, 8), (5, 0, 2), (6, 3, 1)):
        np.testing.assert_array_equal(ptiling.blend_mask1d(tile, overlap, factor),
                                      jtiling.blend_mask1d(tile, overlap, factor))


def test_family_configs_match_jax():
    import dataclasses

    for name in ("sd_vae_config", "sdxl_vae_config", "sd3_vae_config", "flux_vae_config"):
        j, p = dataclasses.asdict(getattr(jvae, name)()), dataclasses.asdict(getattr(pvae, name)())
        assert j.pop("dtype") == jnp.bfloat16 and p.pop("dtype") == torch.bfloat16
        assert j == p, name


_LDM_RENAMES = [
    (r"^(encoder|decoder)\.(down|up)_(\d+)_block_(\d+)\.", r"\1.\2.\3.block.\4."),
    (r"^encoder\.down_(\d+)_downsample\.", r"encoder.down.\1.downsample."),
    (r"^decoder\.up_(\d+)_upsample\.", r"decoder.up.\1.upsample."),
    (r"\.mid_block_(\d)\.", r".mid.block_\1."),
    (r"\.mid_attn_1\.", r".mid.attn_1."),
]


def _ldm_layout(cfg: pvae.VAEConfig, seed: int) -> dict:
    """A random ldm-layout state dict: the port's keys renamed to ldm's."""
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in pvae.AutoencoderKL(cfg).state_dict().items()}
    rng = np.random.default_rng(seed)
    out = {}
    for key, shape in shapes.items():
        for pat, rep in _LDM_RENAMES:
            key = re.sub(pat, rep, key)
        out[key] = rng.normal(size=shape).astype(np.float32)
    return out


def _assert_same_state(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_convert_vae_matches_jax_converter(name):
    pcfg = pvae.VAEConfig(**CONFIGS[name])
    jcfg = jvae.VAEConfig(**CONFIGS[name])
    sd = _ldm_layout(pcfg, seed=11)
    assert "encoder.down.0.block.0.conv1.weight" in sd and "decoder.mid.attn_1.q.weight" in sd
    want = from_jax_vae_params(jax.tree.map(np.asarray, jcv.convert_vae_checkpoint(sd, jcfg)))
    for prefix in ("", "first_stage_model.", "vae."):
        got = pcv.convert_vae_checkpoint({prefix + k: v for k, v in sd.items()}, pcfg)
        _assert_same_state(got, want)
    pvae.AutoencoderKL(pcfg).load_state_dict(want)
    # Rank-2 attention projections (diffusers-style exports) and bf16 tensors.
    flat = {k: (v[:, :, 0, 0] if re.search(r"attn_1\.(q|k|v|proj_out)\.weight", k) else v)
            for k, v in sd.items()}
    flat = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in flat.items()}
    want16 = from_jax_vae_params(jax.tree.map(np.asarray, jcv.convert_vae_checkpoint(
        {k: v.float().numpy() for k, v in flat.items()}, jcfg)))
    _assert_same_state(pcv.convert_vae_checkpoint(flat, pcfg), want16)
    with pytest.raises(ValueError, match="unconverted"):
        pcv.convert_vae_checkpoint({**sd, "encoder.down.0.attn.0.q.weight": sd["quant_conv.weight"]
                                    if pcfg.use_quant_conv else sd["encoder.conv_in.weight"]},
                                   pcfg)
    with pytest.raises(KeyError):
        pcv.convert_vae_checkpoint({k: v for k, v in sd.items() if "conv_out" not in k}, pcfg)
