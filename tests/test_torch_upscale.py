"""The port's ESRGAN upscaler (``models/upscale.py``) against the JAX package's:
``RRDBNet`` forwards (x4 and the pixel-unshuffling x2) and the tiled
``upscale_image`` on the same numpy weights (the port's through
``convert_jax.from_jax_upscale_params``), the key normalisation and sniffing on
tiny dicts in both public layouts, and the loader on a safetensors file. f32,
rtol/atol 2e-4."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_upscale import _legacy_sd, _modern_sd  # noqa: E402

from comfyui_parallelanything_tpu.models import upscale as ju  # noqa: E402
from comfyui_parallelanything_tpu_torch.models import upscale as pu  # noqa: E402
from comfyui_parallelanything_tpu_torch.models.convert_jax import (  # noqa: E402
    from_jax_upscale_params,
)
from comfyui_parallelanything_tpu_torch.models.loader import save_safetensors  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
TINY = dict(nf=8, nb=2, gc=4)


@functools.cache
def _pair(scale: int):
    """(JAX model, port model, numpy tree) of a tiny RRDBNet at ``scale``; the biases
    are lifted so the output is off the clip at 0."""
    jcfg = ju.UpscaleConfig(**TINY, scale=scale, dtype=jnp.float32)
    hw = 8 * {4: 1, 2: 2, 1: 4}[scale]
    abstract = jax.eval_shape(ju.RRDBNet(jcfg).init, jax.random.key(0),
                              jnp.zeros((1, hw, hw, 3)))["params"]
    rng = np.random.default_rng(scale)

    def leaf(path, a):
        if path[-1].key == "kernel":
            return (rng.normal(size=a.shape) / np.sqrt(np.prod(a.shape[:-1]))).astype(np.float32)
        return (0.05 + 0.1 * rng.normal(size=a.shape)).astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(leaf, abstract)
    jm = ju.build_upscaler(jcfg, params=jax.tree.map(jnp.asarray, tree))
    pm = pu.build_upscaler(pu.UpscaleConfig(**TINY, scale=scale), device="cpu",
                           state_dict=from_jax_upscale_params(tree))
    return jm, pm, tree


def _image(shape, seed=1):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("scale,hw", [(4, (12, 10)), (2, (16, 12))])
def test_forward_matches_jax(scale, hw):
    jm, pm, _ = _pair(scale)
    x = _image((2, *hw, 3))
    want = np.asarray(jm(jnp.asarray(x)))
    got = pm(torch.from_numpy(x))
    assert got.shape == (2, hw[0] * scale, hw[1] * scale, 3)
    assert 0.0 < float(got.mean()) < 1.0
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_tiled_upscale_matches_jax():
    jm, pm, _ = _pair(4)
    x = _image((1, 20, 28, 3), seed=2)
    want = np.asarray(ju.upscale_image(jm, jnp.asarray(x), tile=12, overlap=2))
    got = pu.upscale_image(pm, torch.from_numpy(x), tile=12, overlap=2)
    assert got.shape == (1, 80, 112, 3)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # A 3-D image is one batch; at or under the tile it runs whole.
    whole = pu.upscale_image(pm, torch.from_numpy(x[0, :12, :12]), tile=12)
    np.testing.assert_allclose(whole.numpy(), pm(torch.from_numpy(x[:, :12, :12])).numpy(),
                               rtol=0, atol=0)


def test_modern_and_legacy_layouts_convert_as_jax_does(tmp_path):
    jm, pm, tree = _pair(4)
    jcfg = jm.cfg
    modern = _modern_sd(jcfg, tree)
    legacy = _legacy_sd(jcfg, tree)
    assert sorted(pu.normalize_esrgan_keys(legacy)) == sorted(modern)
    for sd in (modern, legacy):
        state, cfg = pu.convert_upscale_checkpoint(sd)
        jparams, jc = ju.convert_upscale_checkpoint(sd)
        assert (cfg.nf, cfg.nb, cfg.gc, cfg.scale, cfg.in_channels, cfg.out_channels) == (
            jc.nf, jc.nb, jc.gc, jc.scale, jc.in_channels, jc.out_channels)
        want = from_jax_upscale_params(jax.tree.map(np.asarray, jparams))
        assert set(state) == set(want)
        for k in want:
            torch.testing.assert_close(state[k], want[k], rtol=0, atol=0)
    # The loader reads a safetensors file in the public layout.
    path = tmp_path / "esrgan.safetensors"
    save_safetensors(path, {k: torch.from_numpy(np.ascontiguousarray(v))
                                        for k, v in legacy.items()})
    loaded = pu.load_upscale_checkpoint(str(path), device="cpu")
    x = torch.from_numpy(_image((1, 12, 10, 3)))
    torch.testing.assert_close(loaded(x), pm(x), rtol=0, atol=0)


def test_sniffing_and_its_refusals_match_jax():
    def stub(first_in):
        return {"conv_first.weight": np.zeros((8, first_in, 3, 3), np.float32),
                "conv_last.weight": np.zeros((3, 8, 3, 3), np.float32),
                "body.0.rdb1.conv1.weight": np.zeros((4, 8, 3, 3), np.float32)}

    for width in (1, 3, 4, 12, 16, 48):
        got, want = pu.sniff_upscale_config(stub(width)), ju.sniff_upscale_config(stub(width))
        assert (got.scale, got.in_channels, got.nb) == (want.scale, want.in_channels, want.nb)
    with pytest.raises(ValueError, match="conv_first input width 8"):
        pu.sniff_upscale_config(stub(8))
    _, _, tree = _pair(4)
    legacy = _legacy_sd(_pair(4)[0].cfg, tree)
    legacy["model.4.weight"] = legacy.pop("model.10.weight")
    with pytest.raises(ValueError, match="x4 sequential layout"):
        pu.convert_upscale_checkpoint(legacy)
