"""Parity of the PyTorch port's primitive ops, split arithmetic, device chain and
attention dispatch against the JAX package, on the CPU.

Inputs are made with numpy from a seed and fed to both sides; f32 results must
agree to rtol/atol 2e-4 unless a comment says otherwise. The split arithmetic
must agree exactly.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401
hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from comfyui_parallelanything_tpu.ops import basic as jax_basic  # noqa: E402
from comfyui_parallelanything_tpu.ops import rope as jax_rope  # noqa: E402
from comfyui_parallelanything_tpu.parallel import split as jax_split  # noqa: E402
from comfyui_parallelanything_tpu_torch.devices import discovery  # noqa: E402
from comfyui_parallelanything_tpu_torch.devices.memory import (  # noqa: E402
    free_memory_bytes,
    total_memory_bytes,
)
from comfyui_parallelanything_tpu_torch.ops import attention as pt_attn  # noqa: E402
from comfyui_parallelanything_tpu_torch.ops import basic as pt_basic  # noqa: E402
from comfyui_parallelanything_tpu_torch.ops import rope as pt_rope  # noqa: E402
from comfyui_parallelanything_tpu_torch.parallel import split as pt_split  # noqa: E402
from comfyui_parallelanything_tpu_torch.parallel.chain import DeviceChain  # noqa: E402

# The JAX ops package re-exports a function named ``attention`` over the module.
jax_attn = importlib.import_module("comfyui_parallelanything_tpu.ops.attention")

TOL = dict(rtol=2e-4, atol=2e-4)


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


class TestBasicOps:
    def test_rms_normalize(self):
        rng = np.random.default_rng(0)
        x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
        scale = rng.normal(size=(16,)).astype(np.float32)
        want = jax_basic.rms_normalize(jnp.asarray(x), jnp.asarray(scale))
        got = pt_basic.rms_normalize(_t(x), _t(scale))
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL)

    def test_modulate(self):
        rng = np.random.default_rng(1)
        x, shift, scale = (rng.normal(size=s).astype(np.float32)
                           for s in ((2, 7, 32), (2, 1, 32), (2, 1, 32)))
        want = jax_basic.modulate(jnp.asarray(x), jnp.asarray(shift), jnp.asarray(scale))
        got = pt_basic.modulate(_t(x), _t(shift), _t(scale))
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL)

    @pytest.mark.parametrize("dim", [256, 33])
    def test_timestep_embedding(self, dim):
        t = np.array([0.0, 0.25, 0.5, 1.0], np.float32)
        want = jax_basic.timestep_embedding(jnp.asarray(t), dim, time_factor=1000.0)
        got = pt_basic.timestep_embedding(_t(t), dim, time_factor=1000.0)
        assert got.shape == (4, dim) and got.dtype == torch.float32
        # Angles reach 1000 rad; f32 rounding of the frequencies moves them ~1e-4.
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=2e-4, atol=1e-3)

    def test_rope_tables_and_rotation(self):
        rng = np.random.default_rng(2)
        ids = rng.integers(0, 16, size=(2, 9, 3)).astype(np.int32)
        axes = (8, 12, 12)
        jcos, jsin = jax_rope.axis_rope_freqs(jnp.asarray(ids), axes)
        pcos, psin = pt_rope.axis_rope_freqs(_t(ids), axes)
        np.testing.assert_allclose(pcos.numpy(), _np(jcos), **TOL)
        np.testing.assert_allclose(psin.numpy(), _np(jsin), **TOL)
        x = rng.normal(size=(2, 9, 2, 32)).astype(np.float32)
        want = jax_rope.apply_rope(jnp.asarray(x), jcos, jsin)
        got = pt_rope.apply_rope(_t(x), pcos, psin)
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


class TestSplitParity:
    @settings(max_examples=60, deadline=None)
    @given(
        batch=st.integers(0, 64),
        weights=st.lists(st.floats(0.0, 100.0, allow_nan=False), min_size=1, max_size=8),
    )
    def test_integer_splits_match_exactly(self, batch, weights):
        assert pt_split.largest_remainder_split(batch, weights) == \
            jax_split.largest_remainder_split(batch, weights)
        assert pt_split.weighted_batch_split(batch, weights) == \
            jax_split.weighted_batch_split(batch, weights)
        assert pt_split.block_ranges(batch, weights) == jax_split.block_ranges(batch, weights)
        assert pt_split.normalize_weights(weights) == jax_split.normalize_weights(weights)

    @settings(max_examples=40, deadline=None)
    @given(
        pcts=st.lists(st.floats(1.0, 100.0, allow_nan=False), min_size=1, max_size=6),
        data=st.data(),
    )
    def test_blends_match_exactly(self, pcts, data):
        n = len(pcts)
        user = jax_split.normalize_weights(pcts)
        free = data.draw(st.lists(st.integers(0, 2**40), min_size=n, max_size=n))
        step = st.one_of(st.just(0.0), st.floats(1e-3, 10.0))  # 0 = no spec for that device
        times = data.draw(st.lists(step, min_size=n, max_size=n))
        assert pt_split.blend_memory_weights(user, free) == jax_split.blend_memory_weights(user, free)
        assert pt_split.blend_speed_weights(user, times) == jax_split.blend_speed_weights(user, times)

    def test_tree_chunking_matches(self):
        x = np.arange(12, dtype=np.float32).reshape(6, 2)
        tree = {"x": x, "pair": (x, "tag"), "scalar": 3}
        sizes = (1, 3, 2)
        want = jax_split.split_tree(tree, sizes)
        got = pt_split.split_tree({"x": _t(x), "pair": (_t(x), "tag"), "scalar": 3}, sizes)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g["x"].numpy(), w["x"])
            assert g["pair"][1] == "tag" and g["scalar"] == 3
        kw_w = jax_split.split_kwargs({"y": x, "s": 1.0}, 6, sizes)
        kw_g = pt_split.split_kwargs({"y": _t(x), "s": 1.0}, 6, sizes)
        for w, g in zip(kw_w, kw_g):
            np.testing.assert_array_equal(g["y"].numpy(), w["y"])
            assert g["s"] == w["s"]
        out = pt_split.concat_results([c["x"] for c in got])
        np.testing.assert_array_equal(out.numpy(), x)
        assert pt_split.batch_size_of(_t(x)) == jax_split.batch_size_of(x) == 6
        padded = pt_split.pad_leaf(_t(x), 2)
        np.testing.assert_array_equal(padded.numpy(), np.asarray(jax_split.pad_leaf(jnp.asarray(x), 2)))
        assert pt_split.slice_padded({"o": padded}, 6, 8)["o"].shape == (6, 2)
        kw = {"y": x, "mode": "a", "opts": [1]}
        arrays, other = pt_split.partition_kwargs({**kw, "y": _t(x)})
        j_arrays, j_other = jax_split.partition_kwargs(kw)
        assert set(arrays) == set(j_arrays) == {"y"} and other == j_other
        assert pt_split.static_kwargs_key({"mode": "a", "k": 2}) == \
            jax_split.static_kwargs_key({"mode": "a", "k": 2})
        assert pt_split.is_arraylike(_t(x)) and not pt_split.is_arraylike([1])


class TestDevicesAndChain:
    def test_discovery_on_cpu(self):
        assert discovery.available_devices()[-1] == "cpu"
        assert discovery.get_device("cpu") == torch.device("cpu")
        assert discovery.get_device("cpu:7") == torch.device("cpu")
        assert discovery.device_platform("cuda:3") == "cuda"
        for bad in ("cpu:8", "tpu:0", "cpu:x"):
            with pytest.raises(ValueError):
                discovery.get_device(bad)
        assert free_memory_bytes(torch.device("cpu")) == 0
        assert total_memory_bytes(torch.device("cpu")) == 0

    def test_no_silent_cpu_fallback(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
        with pytest.raises(RuntimeError):
            discovery.default_device()
        with pytest.raises(ValueError):
            discovery.get_device("cuda:0")

    def test_chain_semantics(self):
        chain = DeviceChain.from_pairs([("cpu:0", 40), ("cpu:1", 0), ("cpu:1", 40), ("cpu:0", 20)])
        assert chain.devices == ("cpu:0", "cpu:1", "cpu:0")
        dd = chain.deduplicated()
        assert dd.devices == ("cpu:0", "cpu:1") and dd.percentages == (60.0, 40.0)
        assert dd.torch_devices() == (torch.device("cpu"),) * 2
        assert DeviceChain.from_pairs([("nope:0", 50), ("cpu", 50)]).validated().devices == ("cpu",)
        assert DeviceChain.even(["cpu:0", "cuda:0"]).is_homogeneous is False
        assert DeviceChain.from_pairs([("cpu", 0)]).normalized_weights() is None


class TestAttentionDispatch:
    def _qkv(self, seed, b, sq, sk, h, d):
        rng = np.random.default_rng(seed)
        return [rng.normal(size=s).astype(np.float32)
                for s in ((b, sq, h, d), (b, sk, h, d), (b, sk, h, d))]

    @pytest.mark.parametrize("backend", ["xla", "xla_chunked", "pallas"])
    def test_backends_match_jax_xla(self, backend, monkeypatch):
        q, k, v = self._qkv(3, 2, 70, 50, 2, 16)
        want = jax_attn._xla_attention(*map(jnp.asarray, (q, k, v)), scale=16**-0.5)
        if backend == "xla_chunked":  # a tiny threshold walks several query blocks
            monkeypatch.setattr(pt_attn, "_CHUNK_THRESHOLD", 2 * 2 * 16 * 50)
        prev = pt_attn.get_attention_backend()
        pt_attn.set_attention_backend(backend)
        try:
            got = pt_attn.attention(_t(q), _t(k), _t(v))
        finally:
            pt_attn.set_attention_backend(prev)
        assert backend in pt_attn.resolved_backends()
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL)

    def test_auto_routes_cpu_to_xla_family(self, monkeypatch):
        monkeypatch.setattr(pt_attn, "_RESOLVED", set())
        q, k, v = self._qkv(4, 1, 8, 8, 1, 8)
        pt_attn.attention(_t(q), _t(k), _t(v))
        assert pt_attn.resolved_backends() == ("xla",)
        monkeypatch.setattr(pt_attn, "_CHUNK_THRESHOLD", 16)
        pt_attn.attention(_t(q), _t(k), _t(v))
        assert pt_attn.resolved_backends() == ("xla", "xla_chunked")
        with pytest.raises(ValueError):
            pt_attn.set_attention_backend("pallas_jax")
