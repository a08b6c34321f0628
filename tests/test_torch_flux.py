"""Parity of the PyTorch port's FLUX model, flow sampler and orchestrator against the
JAX package on the CPU, at a small size (1 double + 1 single block, width 64).

Weights (biases and norm scales included) and inputs are made with numpy from a
seed; the JAX model takes the flax tree and the port takes it through
``convert_jax.from_jax_params``. The JAX
side runs in f32 under the suite's ``highest`` matmul precision, and both sides
must agree to rtol/atol 2e-4.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import comfyui_parallelanything_tpu as jpa  # noqa: E402
from comfyui_parallelanything_tpu.models import flux as jflux  # noqa: E402
from comfyui_parallelanything_tpu.sampling.flow import (  # noqa: E402
    flow_euler_sample as jax_flow_euler_sample,
)
from comfyui_parallelanything_tpu_torch import parallelize  # noqa: E402
from comfyui_parallelanything_tpu_torch.models import flux as pflux  # noqa: E402
from comfyui_parallelanything_tpu_torch.models.convert_jax import from_jax_params  # noqa: E402
from comfyui_parallelanything_tpu_torch.ops import attention as pt_attn  # noqa: E402
from comfyui_parallelanything_tpu_torch.parallel.chain import DeviceChain  # noqa: E402
from comfyui_parallelanything_tpu_torch.parallel.orchestrator import (  # noqa: E402
    ParallelConfig,
    ParallelModel,
)
from comfyui_parallelanything_tpu_torch.sampling.flow import (  # noqa: E402
    flow_euler_sample,
    flow_timesteps,
)

TOL = dict(rtol=2e-4, atol=2e-4)
SMALL = dict(hidden_size=64, num_heads=2, depth=1, depth_single_blocks=1, mlp_ratio=2.0,
             context_in_dim=32, vec_in_dim=16, axes_dim=(8, 12, 12), in_channels=16)
LATENT = (8, 8, 4)  # NHWC per sample: 16 image tokens after the 2×2 patchify
TXT = 6


@pytest.fixture(autouse=True)
def _hermetic(monkeypatch, tmp_path):
    monkeypatch.setenv("PA_PLANNER", "0")
    monkeypatch.setenv("PA_LEDGER_DIR", str(tmp_path / "ledger"))
    monkeypatch.setenv("PA_EVIDENCE_DIR", str(tmp_path / "evidence"))


def _numpy_params(cfg, seed=11):
    """A flax FLUX tree of random numpy weights: kernels N(0, 1/fan_in), biases and
    norm scales off their init values so their conversion is checked too."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = path[-1].key
        if name == "kernel":
            return (rng.normal(size=a.shape) / np.sqrt(a.shape[0])).astype(np.float32)
        base = 1.0 if name.endswith("_norm") else 0.0
        return (base + 0.1 * rng.normal(size=a.shape)).astype(np.float32)

    abstract = jflux.flux_abstract_params(cfg, sample_shape=(1, *LATENT), txt_len=TXT)
    return jax.tree_util.tree_map_with_path(leaf, abstract)


def _pair(guidance_embed: bool):
    jcfg = jflux.flux_dev_config(**SMALL, guidance_embed=guidance_embed, dtype=jnp.float32)
    params = _numpy_params(jcfg)
    jm = jflux.build_flux(jcfg, params=jax.tree.map(jnp.asarray, params))
    pcfg = pflux.flux_dev_config(**SMALL, guidance_embed=guidance_embed, dtype=torch.float32)
    pm = pflux.build_flux(pcfg, device="cpu", state_dict=from_jax_params(params))
    return jm, pm


@pytest.fixture(scope="module")
def dev_pair():
    return _pair(True)


def _inputs(batch, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, *LATENT)).astype(np.float32)
    t = rng.uniform(size=(batch,)).astype(np.float32)
    ctx = rng.normal(size=(batch, TXT, SMALL["context_in_dim"])).astype(np.float32)
    y = rng.normal(size=(batch, SMALL["vec_in_dim"])).astype(np.float32)
    return x, t, ctx, y


def test_build_flux_needs_weights_and_keeps_layer_dtypes():
    with pytest.raises(ValueError):
        pflux.build_flux(pflux.flux_dev_config(**SMALL), device="cpu")
    gen = torch.Generator().manual_seed(0)
    m = pflux.build_flux(pflux.flux_dev_config(**SMALL), device="cpu", generator=gen)
    blk = m.module.double_blocks[0]
    assert blk.img_attn_qkv.weight.dtype == torch.bfloat16
    assert blk.img_mod.lin.weight.dtype == torch.float32
    assert m.module.final_proj.weight.dtype == torch.float32
    assert blk.img_attn_norm.query_norm.dtype == torch.float32
    assert torch.all(blk.img_attn_norm.query_norm == 1)
    assert len(m.pipeline_spec.segments) == 2 and m.block_lists == {
        "double_blocks": 1, "single_blocks": 1}


def test_blocks_match_jax(dev_pair):
    jm, pm = dev_pair
    cfg = jm.config
    rng = np.random.default_rng(5)
    img = rng.normal(size=(2, 16, 64)).astype(np.float32)
    txt = rng.normal(size=(2, TXT, 64)).astype(np.float32)
    vec = rng.normal(size=(2, 64)).astype(np.float32)
    ids = rng.integers(0, 8, size=(2, 16 + TXT, 3)).astype(np.int32)
    cos, sin = jax.tree.map(np.array, jflux.axis_rope_freqs(jnp.asarray(ids), cfg.axes_dim))
    T = torch.from_numpy
    ji, jt = jax.jit(jflux.DoubleBlock(cfg).apply)(
        {"params": jm.params["double_blocks_0"]}, img, txt, vec, (cos, sin))
    pi, pt = pm.module.double_blocks[0](T(img), T(txt), T(vec), (T(cos), T(sin)))
    np.testing.assert_allclose(pi.detach().numpy(), np.asarray(ji), **TOL)
    np.testing.assert_allclose(pt.detach().numpy(), np.asarray(jt), **TOL)
    x = np.concatenate([txt, img], axis=1)
    js = jax.jit(jflux.SingleBlock(cfg).apply)(
        {"params": jm.params["single_blocks_0"]}, x, vec, (cos, sin))
    ps = pm.module.single_blocks[0](T(x), T(vec), (T(cos), T(sin)))
    np.testing.assert_allclose(ps.detach().numpy(), np.asarray(js), **TOL)


@pytest.mark.parametrize(
    "guidance_embed,guidance",
    [(True, [3.5, 1.0]), (True, None), (False, None)],
    ids=["guidance", "default-guidance-4", "no-guidance-embed"],
)
def test_forward_matches_jax(guidance_embed, guidance, dev_pair):
    jm, pm = dev_pair if guidance_embed else _pair(False)
    x, t, ctx, y = _inputs(2, seed=1)
    kw = {} if guidance is None else {"guidance": np.array(guidance, np.float32)}
    want = jm(jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx), y=jnp.asarray(y),
              **{k: jnp.asarray(v) for k, v in kw.items()})
    got = pm(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
             y=torch.from_numpy(y), **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize(
    "links,batch",
    [([("cpu", 100)], 2), ([(f"cpu:{i}", 25) for i in range(4)], 6)],
    ids=["1-way", "4-way-pad-6-to-8"],
)
def test_slice_flow_sampling_through_parallelize(links, batch, dev_pair):
    jm, pm = dev_pair
    x, _, ctx, y = _inputs(batch, seed=2)
    jpm = jpa.parallelize(jm, jpa.DeviceChain.from_pairs(links))
    want = jax_flow_euler_sample(jpm, jnp.asarray(x), jnp.asarray(ctx), steps=2, shift=3.0,
                                 guidance=3.5, y=jnp.asarray(y))
    ppm = parallelize(pm, links)
    assert isinstance(ppm, ParallelModel) and ppm.devices == tuple(d for d, _ in links)
    calls = []
    dp = ppm._data_parallel
    ppm._data_parallel = lambda *a: calls.append(a[0]) or dp(*a)
    got = flow_euler_sample(ppm, torch.from_numpy(x), torch.from_numpy(ctx), steps=2,
                            shift=3.0, guidance=3.5, y=torch.from_numpy(y))
    assert calls == ([] if len(links) == 1 else [batch, batch])
    assert got.shape == x.shape and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_flow_schedule_matches_jax():
    from comfyui_parallelanything_tpu.sampling.flow import flow_timesteps as jts

    np.testing.assert_allclose(flow_timesteps(4, 3.0).numpy(), np.asarray(jts(4, 3.0)), rtol=1e-6)


def test_routing_ladder_and_not_ported_paths(dev_pair, monkeypatch):
    _, pm = dev_pair
    x, t, ctx, y = (torch.from_numpy(a) for a in _inputs(1, seed=3))
    chain4 = DeviceChain.even([f"cpu:{i}" for i in range(4)])
    ppm = parallelize(pm, chain4)
    # batch==1 on 4 devices with a pipeline spec: the blocks placed as a pipeline
    np.testing.assert_allclose(ppm(x, t, ctx, y=y).numpy(), pm(x, t, ctx, y=y).numpy(), **TOL)
    assert ppm._pipeline_runner is not None and ppm._pipeline_runner.n_stages == 2
    single = parallelize(pm, chain4, ParallelConfig(workload_split=False))
    np.testing.assert_allclose(single(x, t, ctx, y=y).numpy(), pm(x, t, ctx, y=y).numpy(), **TOL)
    assert parallelize(pm, [("cpu", 0)]) is pm  # unusable chain: model unchanged
    for cfg in (ParallelConfig(weight_sharding="fsdp"), ParallelConfig(tensor_parallel=2)):
        with pytest.raises(NotImplementedError):
            parallelize(pm, chain4, cfg)
    x2, t2, ctx2, y2 = (torch.from_numpy(a) for a in _inputs(2, seed=4))
    mb = parallelize(pm, chain4, ParallelConfig(pipeline_microbatches=2))
    np.testing.assert_allclose(mb(x2, t2, ctx2, y=y2).numpy(), pm(x2, t2, ctx2, y=y2).numpy(),
                               **TOL)
    assert mb._pipeline_runner is not None
    from comfyui_parallelanything_tpu_torch.parallel import chain as chain_mod

    monkeypatch.setattr(chain_mod, "get_device", lambda s: torch.device("cpu"))
    # A heterogeneous chain runs: two platform groups, each computing its share.
    hybrid = parallelize(pm, [("cpu", 50), ("cuda:0", 50)])
    assert [g.platform for g in hybrid._groups] == ["cpu", "cuda"]
    x3, t3, ctx3, y3 = (torch.from_numpy(a) for a in _inputs(3, seed=5))
    np.testing.assert_allclose(hybrid(x3, t3, ctx3, y=y3).numpy(),
                               pm(x3, t3, ctx3, y=y3).numpy(), **TOL)
    with pytest.raises(NotImplementedError, match="streaming"):
        parallelize(pm, chain4, ParallelConfig(hbm_budget_bytes=1))
    monkeypatch.setenv("PA_PLANNER", "1")
    with pytest.raises(NotImplementedError, match="planner"):
        parallelize(pm, chain4)


def test_step_oom_demotes_to_single_and_cleanup(dev_pair):
    _, pm = dev_pair
    x, t, ctx, y = (torch.from_numpy(a) for a in _inputs(4, seed=4))
    ppm = parallelize(pm, DeviceChain.even([f"cpu:{i}" for i in range(2)]))
    want = pm(x, t, ctx, y=y)

    def oom(*a):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory (injected)")

    ppm._data_parallel = oom
    np.testing.assert_allclose(ppm(x, t, ctx, y=y).numpy(), want.numpy(), **TOL)
    assert ppm.active is False and len(ppm._replicas) == 1
    ppm.cleanup()
    ppm.cleanup()
    np.testing.assert_allclose(ppm(x, t, ctx, y=y).numpy(), want.numpy(), **TOL)

    def boom(*a):
        raise RuntimeError("not an OOM")

    other = parallelize(pm, DeviceChain.even(["cpu:0", "cpu:1"]))
    other._data_parallel = boom
    with pytest.raises(RuntimeError, match="not an OOM"):
        other(x, t, ctx, y=y)
    assert other.active


def test_auto_backend_on_cpu_is_xla(dev_pair, monkeypatch):
    _, pm = dev_pair
    monkeypatch.setattr(pt_attn, "_RESOLVED", set())
    x, t, ctx, y = (torch.from_numpy(a) for a in _inputs(1, seed=6))
    pm(x, t, ctx, y=y)
    assert pt_attn.resolved_backends() == ("xla",)
