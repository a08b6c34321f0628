"""The PyTorch port's multi-process helpers (``parallel/multihost.py``) against the
JAX package's single-process behaviour on the CPU: ``initialize_distributed`` is a
no-op without arguments or torchrun's variables, ``hybrid_mesh`` has JAX's shapes
and errors, ``host_local_batch`` places a batch over the data axis, a hybrid mesh's
``seq`` row drives sequence-parallel attention; then a ``gloo`` process group of one
rank (a file store in the test's directory), idempotent on a second call and
destroyed after."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402

from comfyui_parallelanything_tpu.parallel import multihost as jmh  # noqa: E402
from comfyui_parallelanything_tpu_torch.ops.attention import attention_local  # noqa: E402
from comfyui_parallelanything_tpu_torch.parallel import multihost as pmh  # noqa: E402
from comfyui_parallelanything_tpu_torch.parallel.mesh import build_mesh  # noqa: E402
from comfyui_parallelanything_tpu_torch.parallel.sequence import (  # noqa: E402
    sequence_parallel_attention,
)

CPU8 = [f"cpu:{i}" for i in range(8)]
TORCHRUN = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


@pytest.fixture(autouse=True)
def _no_torchrun(monkeypatch):
    for k in TORCHRUN:
        monkeypatch.delenv(k, raising=False)


def test_initialize_is_a_noop_without_a_group():
    assert pmh.initialize_distributed() is False and jmh.initialize_distributed() is False
    assert not pmh.is_multihost() and pmh.process_count() == 1 == jmh.process_count()


@pytest.mark.parametrize("ici", [{"seq": 4}, None, {"model": 2, "seq": 2}])
def test_hybrid_mesh_shapes_equal_jax(cpu_devices, ici):
    want = jmh.hybrid_mesh(ici, devices=cpu_devices)
    got = pmh.hybrid_mesh(ici, devices=CPU8)
    assert got.shape == dict(want.shape) and got.axis_names == want.axis_names


def test_hybrid_mesh_errors_as_jax(cpu_devices):
    with pytest.raises(ValueError, match="do not divide"):
        jmh.hybrid_mesh({"seq": 3}, devices=cpu_devices)
    with pytest.raises(ValueError, match="do not divide"):
        pmh.hybrid_mesh({"seq": 3}, devices=CPU8)


def test_host_local_batch_places_the_batch_on_the_data_axis(cpu_devices):
    arr = np.random.default_rng(0).standard_normal((16, 4)).astype(np.float32)
    want = jmh.host_local_batch(arr, jmh.hybrid_mesh(devices=cpu_devices))
    got = pmh.host_local_batch(arr, pmh.hybrid_mesh(devices=CPU8))
    assert got.shape == tuple(want.shape) and got.offset == 0
    assert len(got.shards) == len(want.sharding.device_set) == 8
    assert {tuple(s.shape) for s in got.shards} == {
        tuple(s.data.shape) for s in want.addressable_shards}
    np.testing.assert_array_equal(got.local().numpy(), np.asarray(want))


def test_a_hybrid_mesh_row_drives_sequence_parallel():
    mesh = pmh.hybrid_mesh({"seq": 4}, devices=CPU8)
    row = build_mesh(list(mesh.devices[0]), {"seq": 4})
    q = torch.from_numpy(np.random.default_rng(1).normal(size=(1, 32, 4, 8)).astype(np.float32))
    out = sequence_parallel_attention(q, q, q, row, method="ring")
    torch.testing.assert_close(out, attention_local(q, q, q), rtol=2e-4, atol=2e-4)


@pytest.fixture
def one_rank_group(tmp_path):
    import torch.distributed as dist

    yield f"file://{tmp_path / 'store'}"
    if dist.is_initialized():
        dist.destroy_process_group()


def test_a_gloo_group_of_one_rank(one_rank_group):
    import torch.distributed as dist

    assert pmh.initialize_distributed(one_rank_group, 1, 0, backend="gloo") is False
    assert dist.is_initialized() and dist.get_backend() == "gloo"
    assert pmh.process_count() == 1 and pmh.process_index() == 0 and not pmh.is_multihost()
    # A second call returns what the first set up.
    assert pmh.initialize_distributed(one_rank_group, 1, 0, backend="gloo") is False
    t = torch.arange(4.0)
    dist.all_reduce(t)
    torch.testing.assert_close(t, torch.arange(4.0))
    batch = pmh.host_local_batch(np.ones((4, 2), np.float32), pmh.hybrid_mesh(devices=CPU8[:2]))
    assert batch.shape == (4, 2) and batch.offset == 0
