"""FSDP and tensor parallelism of the PyTorch port (``parallel/mesh.py``,
``parallel/sharding.py``, the orchestrator's sharded route) against the JAX
package on the CPU.

The policy: ``fsdp_spec`` on the JAX package's own cases, and for every leaf of a
tiny FLUX the sharded logical axis and the per-device bytes equal JAX's (with a
square weight among the cases, where the raw torch shape would break the tie the
other way; FLUX-dev's full-size byte math is in ``test_torch_mesh.py``). Execution: the
tiny FLUX (hidden 128, so its MLP kernels shard) wrapped with ``fsdp`` and with
``tensor_parallel=2`` on ``cpu:0..3``, directly and through the
``ParallelAnythingAdvanced`` node, against the JAX node's output (rtol/atol 2e-4,
the JAX side in f32 under the suite's ``highest`` precision). The UNet's tensor
parallelism is in ``test_torch_tp_unet.py``. Weights are numpy draws carried by
``models/convert_jax.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_quick_jax import quick_jax_compiles  # noqa: E402,F401
from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from comfyui_parallelanything_tpu import nodes as jnodes  # noqa: E402
from comfyui_parallelanything_tpu.models import flux as jflux  # noqa: E402
from comfyui_parallelanything_tpu.parallel import mesh as jmesh  # noqa: E402
from comfyui_parallelanything_tpu_torch import nodes as pnodes  # noqa: E402
from comfyui_parallelanything_tpu_torch import parallelize  # noqa: E402
from comfyui_parallelanything_tpu_torch.models import flux as pflux  # noqa: E402
from comfyui_parallelanything_tpu_torch.models.convert_jax import (  # noqa: E402
    from_jax_params,
    jax_layouts,
)
from comfyui_parallelanything_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from comfyui_parallelanything_tpu_torch.parallel.orchestrator import (  # noqa: E402
    ParallelConfig,
)

from test_torch_flux import _numpy_params  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
SMALL = dict(hidden_size=128, num_heads=4, depth=1, depth_single_blocks=1, mlp_ratio=4.0,
             context_in_dim=32, vec_in_dim=16, axes_dim=(8, 12, 12), in_channels=16,
             guidance_embed=False)
CPU4 = [f"cpu:{i}" for i in range(4)]
CONFIGS = {"fsdp": dict(weight_sharding="fsdp", tensor_parallel=1),
           "tp2": dict(weight_sharding="replicate", tensor_parallel=2)}


@pytest.fixture(autouse=True)
def _hermetic(monkeypatch, tmp_path):
    monkeypatch.setenv("PA_PLANNER", "0")
    monkeypatch.setenv("PA_LEDGER_DIR", str(tmp_path / "ledger"))
    monkeypatch.setenv("PA_EVIDENCE_DIR", str(tmp_path / "evidence"))


def _inputs(batch=4, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(batch, 8, 8, 4)).astype(np.float32),
            np.linspace(1.0, 0.2, batch).astype(np.float32),
            rng.normal(size=(batch, 16, 32)).astype(np.float32),
            rng.normal(size=(batch, 16)).astype(np.float32))


@pytest.fixture(scope="module")
def flux_pair():
    jcfg = jflux.flux_dev_config(**SMALL, dtype=jnp.float32)
    tree = _numpy_params(jcfg, seed=7)
    jm = jflux.build_flux(jcfg, params=jax.tree.map(jnp.asarray, tree))
    pm = pflux.build_flux(pflux.flux_dev_config(**SMALL, dtype=torch.float32), device="cpu",
                          state_dict=from_jax_params(tree))
    return jm, tree, pm


@pytest.fixture(scope="module")
def jax_node_outputs(flux_pair):
    """The JAX ``ParallelAnythingAdvanced`` node's output per config on 4 devices."""
    jm = flux_pair[0]
    x, t, ctx, y = (jnp.asarray(a) for a in _inputs())
    wire = [{"device": d, "percentage": 25.0} for d in CPU4]
    out = {}
    for name, extra in CONFIGS.items():
        (jpm,) = jnodes.ParallelAnythingAdvanced().setup_parallel(jm, wire, **extra)
        out[name] = np.asarray(jpm(x, t, ctx, y=y))
        jpm.cleanup()
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _port_name(jax_path: str) -> str:
    """A FLUX leaf's path → the port's state-dict name (``convert_jax``'s rename)."""
    (name,) = from_jax_params(_nest(jax_path)).keys()
    return name


def _nest(path: str):
    out = cur = {}
    parts = path.split("/")
    for p in parts[:-1]:
        cur[p] = {}
        cur = cur[p]
    cur[parts[-1]] = np.zeros((1,) * 2, np.float32)
    return out


# -- the policy ---------------------------------------------------------------------


@pytest.mark.parametrize("shape,n,min_size", [
    ((512, 1024), 8, 2**16), ((2048, 256), 8, 2**16), ((64,), 8, 2**16),
    ((1000, 999), 8, 1), ((999, 1001), 8, 1), ((), 8, 2**16), ((3072, 3072), 2, 2**16),
    ((3072, 3, 24, 128), 2, 2**16), ((3072, 3, 24, 128), 8, 2**16), ((3, 3, 320, 640), 3, 1)])
def test_fsdp_spec_equals_jax(shape, n, min_size):
    assert pmesh.fsdp_spec(shape, "data", n, min_size) == tuple(
        jmesh.fsdp_spec(shape, "data", n, min_size))


@pytest.mark.parametrize("n,min_size", [(2, 2**16), (4, 2**16), (2, 2**10), (4, 2**10)])
def test_every_flux_leaf_shards_the_jax_axis_with_jax_bytes(flux_pair, cpu_devices, n,
                                                            min_size):
    jm, tree, pm = flux_pair
    leaves = _flat(tree)
    jmesh_ = jmesh.build_mesh(cpu_devices[:n], {"data": n})
    pmesh_ = pmesh.build_mesh(CPU4[:n], {"data": n})
    specs = pmesh.sharded_shardings(pm.module, pmesh_, "data", min_size)
    layouts = jax_layouts(pm.module)
    ties = 0
    for path, arr in leaves.items():
        name = _port_name(path)
        want = tuple(jmesh.fsdp_spec(arr.shape, "data", n, min_size))
        assert layouts[name].jax_shape == arr.shape, (path, name)
        assert specs[name] == want, (path, name)
        if want and arr.ndim == 2 and arr.shape[0] == arr.shape[1]:
            ties += 1
            # The raw torch shape (out, in) would shard the other (output) axis.
            assert want.index("data") == 0
    assert min_size > 2**10 or ties
    shapes = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, jnp.float32), tree)
    assert pmesh.sharded_byte_math(pm.module, pmesh_, "data", 4, min_size) == \
        jmesh.sharded_byte_math(shapes, jmesh_, "data", 4, min_size)


# -- execution against the JAX package ----------------------------------------------


@pytest.mark.parametrize("config", list(CONFIGS))
def test_parallelize_matches_the_jax_node(flux_pair, jax_node_outputs, config):
    pm = parallelize(flux_pair[2], [(d, 25) for d in CPU4], ParallelConfig(**CONFIGS[config]))
    g = pm._groups[0]
    assert g.mesh.shape == ({"data": 4} if config == "fsdp" else {"data": 2, "model": 2})
    assert any(e.sharded for e in g.placed.entries.values())
    got = pm(*(torch.from_numpy(a) for a in _inputs()[:3]),
             y=torch.from_numpy(_inputs()[3]))
    np.testing.assert_allclose(got.numpy(), jax_node_outputs[config], **TOL)
    pm.cleanup()


@pytest.mark.parametrize("config", list(CONFIGS))
def test_advanced_node_passes_sharding_through(flux_pair, jax_node_outputs, config):
    wire = [{"device": d, "percentage": 25.0} for d in CPU4]
    (pm,) = pnodes.ParallelAnythingAdvanced().setup_parallel(flux_pair[2], wire,
                                                             **CONFIGS[config])
    assert pm.is_sharded and pm.config.tensor_parallel == CONFIGS[config]["tensor_parallel"]
    x, t, ctx, y = (torch.from_numpy(a) for a in _inputs())
    np.testing.assert_allclose(pm(x, t, ctx, y=y).numpy(), jax_node_outputs[config], **TOL)
    pm.cleanup()


def test_fsdp_devices_hold_a_quarter_and_gather_per_module(flux_pair):
    module = flux_pair[2].module
    pm = parallelize(flux_pair[2], [(d, 25) for d in CPU4], ParallelConfig(weight_sharding="fsdp"))
    placed = pm._groups[0].placed
    per_pos = [placed.position_bytes(p) for p in placed.mesh.positions()]
    sharded = sum(p.numel() * p.element_size() for n, p in module.named_parameters()
                  if placed[n].sharded)
    whole = sum(p.numel() * p.element_size() for p in module.parameters())
    assert all(b == whole - sharded + sharded // 4 for b in per_pos)
    skel = pm._groups[0].replicas[1]
    lin = skel.double_blocks[0].img_mlp_in
    assert lin.weight.numel() == 0  # a placeholder outside its module's forward
    seen = []
    h = lin.register_forward_hook(lambda m, a, o: seen.append(m.weight.shape), prepend=True)
    x, t, ctx, y = (torch.from_numpy(a) for a in _inputs())
    pm(x, t, ctx, y=y)
    h.remove()
    assert seen == [module.double_blocks[0].img_mlp_in.weight.shape]
    assert lin.weight.numel() == 0
    pm.cleanup()


def test_tp_batch_one_and_demoted_single_stay_sharded(flux_pair):
    model = flux_pair[2]
    x, t, ctx, y = (torch.from_numpy(a[:1]) for a in _inputs())
    with torch.no_grad():
        want = model.module(x, t, ctx, y=y)
    pm = parallelize(model, [(d, 25) for d in CPU4], ParallelConfig(tensor_parallel=4))
    assert pm._groups[0].mesh.shape == {"data": 1, "model": 4}
    np.testing.assert_allclose(pm(x, t, ctx, y=y).numpy(), want.numpy(), **TOL)
    assert pm._pipeline_runner is None and len(pm._groups[0].replicas) == 1
    placed = pm._groups[0].placed
    pm._demote()
    assert pm._groups[0].placed is placed
    np.testing.assert_allclose(pm(x, t, ctx, y=y).numpy(), want.numpy(), **TOL)
    spec = pm.traceable()
    assert spec.replicas == (pm._groups[0].replicas[0],)
    pm.reactivate()
    assert pm.active and pm._groups[0].placed is placed
    pm.cleanup()
    fs = parallelize(model, [(d, 25) for d in CPU4], ParallelConfig(weight_sharding="fsdp"))
    fs._demote()
    np.testing.assert_allclose(fs.single(x, t, ctx, y=y).numpy(), want.numpy(), **TOL)
    assert fs._groups[0].replicas[0].double_blocks[0].img_mlp_in.weight.numel() == 0
    fs.cleanup()


def test_tp_errors(flux_pair):
    model = flux_pair[2]
    with pytest.raises(ValueError, match="does not divide"):
        parallelize(model, [(d, 1) for d in CPU4[:3]], ParallelConfig(tensor_parallel=2))
    with pytest.raises(ValueError, match="does not compose"):
        parallelize(model, [(d, 1) for d in CPU4],
                    ParallelConfig(tensor_parallel=2, weight_sharding="fsdp"))
