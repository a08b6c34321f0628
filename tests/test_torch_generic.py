"""Parity of the PyTorch port's wrap-anything genericity (``models/generic.py``)
against the JAX package on the CPU: a model family neither package knows,
``tests/test_generic_wrap.NovelDiT`` (a ``layers`` list of carry → carry blocks
between ``prepare`` and ``finalize``), written once in flax there and once as an
``nn.Module`` here with the same numpy weights. The derived pipeline spec, the
wrapped forward and a batch-1 pipeline over two ``cpu:i`` links must match the JAX
package's (f32, rtol/atol 2e-4)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch import nn  # noqa: E402

from comfyui_parallelanything_tpu import derive_pipeline_spec as jax_derive  # noqa: E402
from comfyui_parallelanything_tpu import wrap_flax_module  # noqa: E402
from comfyui_parallelanything_tpu_torch import parallelize  # noqa: E402
from comfyui_parallelanything_tpu_torch.models.generic import (  # noqa: E402
    BLOCK_LIST_NAMES,
    derive_pipeline_spec,
    wrap_module,
)

from test_generic_wrap import NovelDiT, _inputs  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True)
def _hermetic(monkeypatch, tmp_path):
    monkeypatch.setenv("PA_PLANNER", "0")
    monkeypatch.setenv("PA_LEDGER_DIR", str(tmp_path / "ledger"))
    monkeypatch.setenv("PA_EVIDENCE_DIR", str(tmp_path / "evidence"))


class _Block(nn.Module):
    def __init__(self, width):
        super().__init__()
        self.dense = nn.Linear(width, width)

    def forward(self, carry):
        return {**carry, "h": carry["h"] + F.gelu(self.dense(carry["h"]), approximate="tanh")}


class TorchNovelDiT(nn.Module):
    """``NovelDiT`` as an ``nn.Module``: an embedding, a ``layers`` list, a head."""

    def __init__(self, width=16, depth=4):
        super().__init__()
        self.embed = nn.Linear(4, width)
        self.layers = nn.ModuleList(_Block(width) for _ in range(depth))
        self.head = nn.Linear(width, 4)

    def prepare(self, x, t, context=None, **kwargs):
        h = self.embed(x) * torch.cos(t)[:, None]
        if context is not None:
            h = h + context.sum(dim=(1, 2))[:, None]
        return {"h": h}

    def finalize(self, carry, out_shape):
        return self.head(carry["h"])

    def forward(self, x, timesteps, context=None, **kwargs):
        carry = self.prepare(x, timesteps, context)
        for blk in self.layers:
            carry = blk(carry)
        return self.finalize(carry, tuple(x.shape))


@pytest.fixture(scope="module")
def novel():
    jm = NovelDiT()
    abstract = jax.eval_shape(jm.init, jax.random.key(0), jnp.ones((1, 4)), jnp.ones((1,)))
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32) * 0.3,
                          abstract["params"])
    pm = TorchNovelDiT()
    with torch.no_grad():
        for name, sub in (("embed", pm.embed), ("head", pm.head),
                          *((f"layers_{i}", b.dense) for i, b in enumerate(pm.layers))):
            p = params[name] if "Dense_0" not in params[name] else params[name]["Dense_0"]
            sub.weight.copy_(torch.from_numpy(np.asarray(p["kernel"]).T))
            sub.bias.copy_(torch.from_numpy(np.asarray(p["bias"])))
    return jm, jax.tree.map(jnp.asarray, params), pm.eval()


def _torch(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def test_derived_spec_matches_jax(novel):
    jm, params, pm = novel
    js, ps = jax_derive(jm, params), derive_pipeline_spec(pm)
    assert [s.param_keys for s in ps.segments] == [
        (k.replace("_", ".", 1),) for s in js.segments for k in s.param_keys]
    assert [s.label for s in ps.segments] == [s.label for s in js.segments]
    assert set(ps.prepare_keys) == set(js.prepare_keys) == {"embed", "head"}
    assert ps.finalize_keys == ps.prepare_keys
    assert BLOCK_LIST_NAMES == ("double_blocks", "single_blocks", "transformer_blocks",
                                "layers")


def test_no_convention_no_spec():
    flat = nn.Linear(4, 4)
    assert derive_pipeline_spec(flat) is None
    dm = wrap_module(flat)
    assert dm.pipeline_spec is None and dm.block_lists is None


def test_wrapped_forward_and_stages_match_jax(novel):
    jm, params, pm = novel
    x, t, c = _inputs(2)
    want = np.asarray(wrap_flax_module(jm, params)(x, t, c))
    dm = wrap_module(pm, name="novel")
    assert dm.block_lists == {"layers": 4} and dm.name == "novel"
    np.testing.assert_allclose(dm(*_torch(x, t, c)).numpy(), want, **TOL)
    spec = dm.pipeline_spec
    with torch.no_grad():
        carry = spec.prepare(pm, *_torch(x, t, c))
        for seg in spec.segments:
            carry = seg.fn(pm, carry)
        got = spec.finalize(pm, carry, tuple(x.shape))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_batch_one_rides_the_derived_pipeline(novel):
    jm, params, pm = novel
    x, t, c = _inputs(1)
    ppm = parallelize(wrap_module(pm), [("cpu:0", 50), ("cpu:1", 50)])
    got = ppm(*_torch(x, t, c))
    assert ppm._pipeline_runner is not None and ppm._pipeline_runner.n_stages == 2
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.apply({"params": params}, x, t, c)),
                               **TOL)
