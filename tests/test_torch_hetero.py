"""Heterogeneous chains in the PyTorch port (``parallel/orchestrator.py``): the
weighted host-side scatter over platform groups, the speed blend from the roofline
platform specs (``utils/roofline.py``), the setup-OOM ladder, ``rebalance``,
``reactivate`` and ``reactivate_after``, against the JAX package's functions and
its orchestrator tests' expectations.

A ``cuda:0`` + ``cpu`` chain cannot exist on a CPU-only machine, so
``chain.get_device`` is patched to resolve every link to the CPU: the links keep
their platform strings, so the chain forms a ``cuda`` group and a ``cpu`` group
and runs the hybrid path exactly as on a card, every group computing on the host.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

from comfyui_parallelanything_tpu.parallel import split as jax_split  # noqa: E402
from comfyui_parallelanything_tpu.utils import roofline as jax_roofline  # noqa: E402
from comfyui_parallelanything_tpu_torch import ParallelConfig, parallelize  # noqa: E402
from comfyui_parallelanything_tpu_torch.devices import memory  # noqa: E402
from comfyui_parallelanything_tpu_torch.parallel import chain as chain_mod  # noqa: E402
from comfyui_parallelanything_tpu_torch.parallel import orchestrator as orch  # noqa: E402
from comfyui_parallelanything_tpu_torch.parallel import split  # noqa: E402
from comfyui_parallelanything_tpu_torch.utils import roofline  # noqa: E402

H100 = "NVIDIA H100 80GB HBM3"
OOM = torch.cuda.OutOfMemoryError


class Toy(torch.nn.Module):
    """A per-sample nonlinear forward that records the batch of every call."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.linspace(-1.0, 1.0, 16).reshape(4, 4))
        self.calls = []

    def forward(self, x, t, context=None, **kwargs):
        self.calls.append(x.shape[0])
        h = torch.tanh(x @ self.w) * torch.cos(t)[:, None]
        if context is not None:
            h = h + context.sum(dim=-1, keepdim=True)
        if kwargs.get("y") is not None:
            h = h + kwargs["y"]
        return h


def _inputs(batch, seed=1):
    rng = np.random.default_rng(seed)
    x, t, c, y = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                  for s in ((batch, 4), (batch,), (batch, 3), (batch, 4)))
    return x, t, c, y


@pytest.fixture
def host_links(monkeypatch):
    monkeypatch.setattr(chain_mod, "get_device", lambda s: torch.device("cpu"))


@pytest.fixture
def speeds(monkeypatch):
    """Each device's nominal step time by its chain platform: the H100 spec for the
    ``cuda`` group, the host's pseudo-spec for ``cpu``."""
    times = {"cuda": roofline.nominal_step_time_s(H100, "cuda"),
             "cpu": roofline.nominal_step_time_s("", "cpu")}
    state = {"platforms": []}

    def fake(devices):
        return [times[p] for p in state["platforms"]]

    monkeypatch.setattr(orch, "_device_step_times", fake)
    state["times"] = times
    return state


def test_platform_specs_match_jax_and_price_the_h100():
    assert roofline.nominal_step_time_s("", "cpu") == jax_roofline.nominal_step_time_s("", "cpu")
    assert roofline.CPU_SPEC["peak_flops"] == jax_roofline.CPU_SPEC["peak_flops"]
    assert roofline.CPU_SPEC["hbm_bw"] == jax_roofline.CPU_SPEC["hbm_bw"]
    assert (roofline.NOMINAL_STEP_FLOPS, roofline.NOMINAL_STEP_BYTES) == (
        jax_roofline.NOMINAL_STEP_FLOPS, jax_roofline.NOMINAL_STEP_BYTES)
    spec = roofline.platform_spec(H100, "cuda")
    assert (spec["peak_flops"], spec["hbm_bw"], spec["generation"]) == (989e12, 3.35e12, "h100")
    # Bound by bytes on the H100 (4e10 B at 3.35 TB/s), by FLOPs on the host.
    assert roofline.nominal_step_time_s(H100, "cuda") == pytest.approx(4e10 / 3.35e12)
    assert roofline.nominal_step_time_s("", "cpu") == pytest.approx(1.0)


@pytest.mark.parametrize("user", [(0.75, 0.25), (0.5, 0.5), (0.1, 0.9)])
def test_blends_and_splits_match_jax(user):
    times = [roofline.nominal_step_time_s(H100, "cuda"), roofline.nominal_step_time_s("", "cpu")]
    free = [80 << 30, 0]
    for got, want in ((split.blend_speed_weights(user, times),
                       jax_split.blend_speed_weights(user, times)),
                      (split.blend_memory_weights(user, free),
                       jax_split.blend_memory_weights(user, free))):
        np.testing.assert_allclose(got, want, rtol=1e-12)
    w = split.blend_speed_weights(split.blend_memory_weights(user, free), times)
    for batch in (1, 2, 3, 4, 8, 17):
        assert split.largest_remainder_split(batch, w) == jax_split.largest_remainder_split(batch, w)


def test_hybrid_chain_splits_by_blended_weights(host_links, speeds):
    speeds["platforms"] = ["cuda", "cpu"]
    model = Toy()
    pm = parallelize(model, [("cuda:0", 75), ("cpu", 25)])
    want_w = jax_split.blend_speed_weights((0.75, 0.25), list(speeds["times"].values()))
    np.testing.assert_allclose(pm.weights, want_w, rtol=1e-12)
    assert [g.platform for g in pm._groups] == ["cuda", "cpu"]
    assert pm.chain.devices == ("cuda:0", "cpu") and pm.traceable() is None
    x, t, c, y = _inputs(8)
    model.calls.clear()
    got = pm(x, t, c, y=y)
    sizes = jax_split.largest_remainder_split(8, want_w)
    assert model.calls == list(sizes) == [7, 1]
    with torch.no_grad():
        np.testing.assert_allclose(got.numpy(), model(x, t, c, y=y).numpy(), rtol=1e-6, atol=1e-6)


def test_hybrid_output_equals_the_homogeneous_run(host_links):
    cfg = ParallelConfig(auto_memory_balance=False)
    model = Toy()
    hybrid = parallelize(model, [("cpu:0", 30), ("cpu:1", 30), ("cuda:0", 40)], cfg)
    assert [len(g.devices) for g in hybrid._groups] == [2, 1]
    single = parallelize(model, [("cpu", 100)], cfg)
    for batch in (2, 5, 9):
        x, t, c, y = _inputs(batch, seed=batch)
        # A context without the batch dim goes whole to every group.
        for ctx in (c, c[:1]):
            np.testing.assert_allclose(hybrid(x, t, ctx, y=y).numpy(),
                                       single(x, t, ctx, y=y).numpy(), rtol=1e-6, atol=1e-6)


def test_zero_size_group_sits_out(host_links):
    model = Toy()
    pm = parallelize(model, [("cuda:0", 99), ("cpu", 1)], ParallelConfig(auto_memory_balance=False))
    x, t, c, y = _inputs(4)
    model.calls.clear()
    got = pm(x, t, c, y=y)
    assert model.calls == [4]  # the cpu group's share is 0: it is never called
    assert got.shape == (4, 4)


def test_setup_oom_drops_the_last_device_then_the_group_then_raises(host_links, monkeypatch):
    real = orch._place
    budget = {"fail": 0}

    def place(module, device):
        if budget["fail"]:
            budget["fail"] -= 1
            raise OOM("CUDA out of memory (injected)")
        return real(module, device)

    monkeypatch.setattr(orch, "_place", place)
    chain = [("cuda:0", 50), ("cpu:0", 30), ("cpu:1", 20)]
    cfg = ParallelConfig(auto_memory_balance=False)
    budget["fail"] = 1  # cpu:1 goes, its share renormalised away
    pm = parallelize(Toy(), chain, cfg)
    assert pm.chain.devices == ("cuda:0", "cpu:0")
    np.testing.assert_allclose(pm.weights, (50 / 80, 30 / 80), rtol=1e-12)
    budget["fail"] = 2  # cpu:1, then the one-device cpu group
    pm = parallelize(Toy(), chain, cfg)
    assert pm.chain.devices == ("cuda:0",) and pm.weights == (1.0,)
    assert [g.platform for g in pm._groups] == ["cuda"]
    budget["fail"] = 3  # nothing left to drop
    with pytest.raises(OOM):
        parallelize(Toy(), chain, cfg)


def test_rebalance_reblends_from_the_user_weights(monkeypatch):
    pm = parallelize(Toy(), [(f"cpu:{i}", 25) for i in range(4)])
    assert pm.weights == (0.25, 0.25, 0.25, 0.25)
    free = [8 << 30, 8 << 30, 4 << 30, 4 << 30]
    readings = iter(free * 2)
    monkeypatch.setattr(orch, "free_memory_bytes", lambda d: next(readings))
    new = pm.rebalance()
    np.testing.assert_allclose(new, jax_split.blend_memory_weights([0.25] * 4, free), rtol=1e-12)
    np.testing.assert_allclose(new[0], 0.7 * 0.25 + 0.3 * (8 / 24), rtol=1e-6)
    np.testing.assert_allclose(pm.rebalance(), new, rtol=1e-12)  # a fixed point
    x, t, c, _ = _inputs(8)
    with torch.no_grad():
        np.testing.assert_allclose(pm(x, t, c).numpy(), pm._module(x, t, c).numpy(), rtol=1e-6)


def test_rebalance_keeps_user_weights_with_balance_off(monkeypatch):
    pm = parallelize(Toy(), [("cpu:0", 60), ("cpu:1", 25), ("cpu:2", 10), ("cpu:3", 5)],
                     ParallelConfig(auto_memory_balance=False))
    before = pm.weights
    np.testing.assert_allclose(before, (0.60, 0.25, 0.10, 0.05), rtol=1e-6)
    monkeypatch.setattr(orch, "free_memory_bytes", lambda d: 8 << 30)
    np.testing.assert_allclose(pm.rebalance(), before, rtol=1e-12)


def test_reactivate_after_n_single_device_steps():
    pm = parallelize(Toy(), [(f"cpu:{i}", 25) for i in range(4)],
                     ParallelConfig(reactivate_after=3))
    pm._demote()
    assert not pm.active and len(pm._replicas) == 1
    x, t, c, _ = _inputs(8)
    want = pm._module(x, t, c).detach().numpy()
    for _ in range(3):
        np.testing.assert_allclose(pm(x, t, c).numpy(), want, rtol=1e-6)
        assert not pm.active
    np.testing.assert_allclose(pm(x, t, c).numpy(), want, rtol=1e-6)
    assert pm.active and len(pm._replicas) == 4


def test_demotion_is_permanent_by_default_and_rebalance_reactivates():
    pm = parallelize(Toy(), [(f"cpu:{i}", 25) for i in range(4)])
    pm._demote()
    x, t, c, _ = _inputs(8)
    for _ in range(5):
        pm(x, t, c)
    assert not pm.active
    pm.rebalance()
    assert pm.active and len(pm._replicas) == 4


def test_reactivate_rolls_back_a_partial_placement(host_links, monkeypatch):
    pm = parallelize(Toy(), [("cuda:0", 50), ("cpu:0", 25), ("cpu:1", 25)])
    pm._demote()
    calls = []

    def place(module, device):
        calls.append(device)
        if len(calls) == 2:
            raise OOM("CUDA out of memory (injected)")
        return module

    monkeypatch.setattr(orch, "_place", place)
    with pytest.raises(OOM):
        pm.reactivate()
    assert not pm.active and len(pm._replicas) == 1  # the lead only, as before


def test_cleaned_up_model_never_reactivates():
    pm = parallelize(Toy(), [(f"cpu:{i}", 25) for i in range(4)],
                     ParallelConfig(reactivate_after=1))
    pm.cleanup()
    x, t, c, _ = _inputs(8)
    for _ in range(3):
        pm(x, t, c)
    assert not pm.active
    pm.rebalance()
    assert not pm.active


def test_usable_hbm_bytes(monkeypatch):
    cpu = torch.device("cpu")
    monkeypatch.delenv("PA_HBM_BUDGET_BYTES", raising=False)
    assert memory.usable_hbm_bytes(cpu) == 0
    monkeypatch.setenv("PA_HBM_BUDGET_BYTES", "32")
    assert memory.usable_hbm_bytes(cpu) == 32
    # 64 B of weights over a 32 B budget, and no pipeline spec to stream: placed, as
    # the JAX package places it (the setup-OOM ladder decides on a real device).
    toy = Toy()
    pm = parallelize(toy, [("cpu", 100)])
    assert not pm.is_streaming and pm._replicas == [toy]
