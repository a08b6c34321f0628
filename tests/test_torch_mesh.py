"""The PyTorch port's meshes and weight placement (``parallel/mesh.py``) against the
JAX package's on the CPU: ``build_mesh`` and its size check, the axis vocabulary,
replicated and sharded placement over ``cpu:i`` devices (values, shard shapes, bytes
a device holds), the in-flight copy bound of ``streamed_tree_put`` on FLUX-dev's
leaf sizes, ``materialize_params_sharded`` making only shards, and FLUX-dev's
full-size per-device bytes from shapes alone, equal to JAX's ``sharded_byte_math``
on the abstract tree (the ``meta`` device allocates nothing)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from comfyui_parallelanything_tpu.models import flux as jflux  # noqa: E402
from comfyui_parallelanything_tpu.parallel import mesh as jmesh  # noqa: E402
from comfyui_parallelanything_tpu_torch.models import flux as pflux  # noqa: E402
from comfyui_parallelanything_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from comfyui_parallelanything_tpu_torch.parallel.chain import DeviceChain  # noqa: E402

CPU8 = [f"cpu:{i}" for i in range(8)]


def test_axis_names_and_mesh_shapes_equal_jax(cpu_devices):
    assert pmesh.mesh_axis_names() == jmesh.mesh_axis_names()
    for shape in (None, {"data": 2, "seq": 4}, {"data": 2, "model": 2, "seq": 2}):
        j = jmesh.build_mesh(cpu_devices, shape)
        p = pmesh.build_mesh(CPU8, shape)
        assert p.shape == dict(j.shape) and p.axis_names == j.axis_names and p.size == 8
    with pytest.raises(ValueError, match="do not multiply"):
        pmesh.build_mesh(CPU8, {"data": 3})
    with pytest.raises(ValueError, match="zero devices"):
        pmesh.build_mesh([])


def test_mesh_from_a_chain_and_one_device_many_times():
    chain = DeviceChain.from_pairs([("cpu:0", 30), ("cpu:1", 30), ("cpu:0", 40)])
    assert pmesh.build_mesh(chain).shape == {"data": 2}  # the chain's de-duplication
    m = pmesh.build_mesh([torch.device("cpu")] * 4, {"seq": 4})
    assert m.axis_devices("seq") == [torch.device("cpu")] * 4
    assert m == pmesh.build_mesh(["cpu"] * 4, {"seq": 4}) and len({m, m}) == 1


def test_replicated_and_sharded_placement_values():
    rng = np.random.default_rng(0)
    params = {"big": torch.from_numpy(rng.normal(size=(1024, 512)).astype(np.float32)),
              "small": torch.ones(16)}
    mesh = pmesh.build_mesh(CPU8)
    rep = pmesh.place_params(params, mesh)
    assert not rep["big"].sharded  # kept where it lies, not copied
    assert rep["big"].parts[(3,)].data_ptr() == params["big"].data_ptr()
    sh = pmesh.place_params_fsdp(params, mesh)
    big = sh["big"]
    assert big.axis == "data" and big.dim == 0
    assert {big.parts[(i,)].shape for i in range(8)} == {(128, 512)}
    assert big.parts[(0,)].data_ptr() != params["big"].data_ptr()  # its own storage
    assert not sh["small"].sharded
    torch.testing.assert_close(big.gather(mesh, (5,), torch.device("cpu")), params["big"],
                               rtol=0, atol=0)
    assert sh.position_bytes((0,)) == 128 * 512 * 4 + 16 * 4


def test_placement_follows_the_jax_layout_of_a_linear():
    lin = torch.nn.Linear(1024, 256)  # flax kernel (1024, 256): shard the input axis
    mesh = pmesh.build_mesh(CPU8[:4], {"model": 4})
    placed = pmesh.place_params_tp(lin, mesh)
    w = placed["weight"]
    assert w.layout.jax_shape == (1024, 256) and w.dim == 0
    assert w.parts[(1,)].shape == (256, 256)
    torch.testing.assert_close(w.parts[(1,)], lin.weight.detach().t()[256:512],
                               rtol=0, atol=0)
    assert tuple(jmesh.fsdp_spec((1024, 256), "model", 4)) == ("model", None)


def test_streamed_put_bounds_bytes_in_flight_on_flux_dev_leaves(monkeypatch):
    """JAX ``TestStreamedPutPeakBound`` on FLUX-dev's leaf sizes (shapes only): the
    bytes not yet drained never exceed the cap plus one leaf."""
    meta = pflux.build_flux(pflux.flux_dev_config(), device="meta",
                            generator=torch.Generator().manual_seed(0)).module
    sizes = [p.numel() for p in meta.parameters()]  # int8: a byte a weight
    state = {"outstanding": 0, "peak": 0, "drains": 0}

    def drain(devices):
        state["drains"] += 1
        state["outstanding"] = 0

    monkeypatch.setattr(pmesh, "_drain", drain)
    inflight = pmesh._Inflight(pmesh._MAX_INFLIGHT_BYTES)
    for n in sizes:
        state["outstanding"] += n
        state["peak"] = max(state["peak"], state["outstanding"])
        inflight.add(n, torch.device("cpu"))
    cap, total = pmesh._MAX_INFLIGHT_BYTES, sum(sizes)
    assert total > 8 << 30
    assert state["peak"] <= cap + max(sizes) and state["peak"] * 4 < total
    # The function itself: a synchronise each time a copy crosses the cap.
    small = {f"w{i}": torch.full((64, 64), float(i)) for i in range(6)}
    state["drains"] = 0
    out = pmesh.streamed_tree_put(small, lambda _: torch.device("meta"), max_inflight_bytes=1)
    assert state["drains"] == 6 and all(v.is_meta for v in out.values())
    kept = pmesh.streamed_tree_put(small, lambda _: torch.device("cpu"), max_inflight_bytes=1)
    assert state["drains"] == 6 and all(kept[k] is small[k] for k in small)


def test_materialize_makes_only_shards():
    meta = torch.nn.Linear(512, 256, device="meta")
    mesh = pmesh.build_mesh(CPU8[:2], {"data": 2})
    placed = pmesh.materialize_params_sharded(meta, mesh)
    w = placed["weight"]
    assert w.sharded and {w.parts[(i,)].shape for i in range(2)} == {(256, 256)}
    assert all(float(w.parts[(i,)].abs().sum()) == 0 for i in range(2))
    assert placed["bias"].parts[(0,)].shape == (256,)
    with pytest.raises(ValueError, match="meta"):
        pmesh.place_params_fsdp(meta, mesh)


def test_flux_dev_per_device_bytes_from_shapes_equal_jax(cpu_devices):
    cfg = jflux.flux_dev_config(dtype=jnp.bfloat16)
    assert (cfg.depth, cfg.depth_single_blocks) == (19, 38)
    shapes = jflux.flux_abstract_params(cfg, sample_shape=(1, 4, 4, 16), txt_len=4)
    meta = pflux.build_flux(pflux.flux_dev_config(), device="meta",
                            generator=torch.Generator().manual_seed(0)).module
    for n in (2, 4, 8):
        got = pmesh.sharded_byte_math(meta, pmesh.build_mesh(["cpu:0"] * n), "data")
        want = jmesh.sharded_byte_math(shapes, jmesh.build_mesh(cpu_devices[:n]), "data")
        assert got == want
    per_device, total = got
    assert total > 20 * 2**30 and per_device < total / 8 * 1.05 and per_device < 4 * 2**30
    assert sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes)) == sum(
        p.numel() for p in meta.parameters())
