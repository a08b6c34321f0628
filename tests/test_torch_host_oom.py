"""The orchestrator's one out-of-memory predicate (``orchestrator.is_out_of_memory``):
a failed host allocation is torch's plain ``RuntimeError`` ("DefaultCPUAllocator:
can't allocate memory"), not ``torch.cuda.OutOfMemoryError``, and every OOM rung
takes it as the JAX package's ``_is_resource_exhausted`` takes an OOM message on any
platform. The host's own error is injected while a ``cpu`` group's replica is
placed (``parallelize`` drops the group and runs on the rest) and at a host
pipeline stage's step (the step-OOM demotion).

As in ``test_torch_hetero.py``, ``chain.get_device`` resolves every link to the CPU,
so a ``cuda:0`` + ``cpu`` chain forms its two platform groups here."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

from comfyui_parallelanything_tpu.parallel import orchestrator as jorch  # noqa: E402
from comfyui_parallelanything_tpu_torch import ParallelConfig, parallelize  # noqa: E402
from comfyui_parallelanything_tpu_torch.models.api import (  # noqa: E402
    DiffusionModel,
    PipelineSegment,
    PipelineSpec,
)
from comfyui_parallelanything_tpu_torch.parallel import chain as chain_mod  # noqa: E402
from comfyui_parallelanything_tpu_torch.parallel import orchestrator as orch  # noqa: E402


def host_oom() -> RuntimeError:
    """The host allocator's own error: asking for a petabyte fails at once."""
    try:
        torch.empty(2**50, dtype=torch.uint8)
    except RuntimeError as e:
        return e
    raise AssertionError("a petabyte allocation succeeded")


@pytest.fixture
def host_links(monkeypatch):
    monkeypatch.setattr(chain_mod, "get_device", lambda s: torch.device("cpu"))


class Blocks(torch.nn.Module):
    """Two per-sample blocks with a pipeline spec: one segment each."""

    def __init__(self):
        super().__init__()
        gen = torch.Generator().manual_seed(0)
        self.blocks = torch.nn.ModuleList(torch.nn.Linear(4, 4) for _ in range(2))
        with torch.no_grad():
            for b in self.blocks:
                b.weight.copy_(torch.randn(4, 4, generator=gen))

    def forward(self, x, t, context=None, **kwargs):
        for b in self.blocks:
            x = torch.tanh(b(x)) * torch.cos(t)[:, None]
        return x


def _segment(i):
    def fn(module, carry):
        h = torch.tanh(module.blocks[i](carry["h"])) * torch.cos(carry["t"])[:, None]
        return {**carry, "h": h}

    return PipelineSegment(param_keys=(f"blocks.{i}",), fn=fn, label=f"block {i}")


SPEC = PipelineSpec(prepare_keys=(), prepare=lambda m, x, t, c, **kw: {"h": x, "t": t},
                    segments=(_segment(0), _segment(1)), finalize_keys=(),
                    finalize=lambda m, carry, shape: carry["h"])


def test_the_predicate_takes_both_devices_ooms_and_nothing_else():
    err = host_oom()
    assert type(err) is RuntimeError and orch.HOST_OOM_MESSAGE in str(err)
    assert orch.is_out_of_memory(err)
    assert orch.is_out_of_memory(torch.cuda.OutOfMemoryError("CUDA out of memory"))
    assert not orch.is_out_of_memory(RuntimeError("shape mismatch"))
    assert not orch.is_out_of_memory(ValueError(orch.HOST_OOM_MESSAGE))
    # The JAX predicate looks for XLA's words (RESOURCE_EXHAUSTED, Out of memory, OOM),
    # which torch's host allocator does not use: the port matches torch's own text.
    assert jorch._is_resource_exhausted(RuntimeError("RESOURCE_EXHAUSTED: Out of memory"))
    assert not jorch._is_resource_exhausted(err)


def test_host_oom_placing_the_cpu_group_drops_it(host_links, monkeypatch):
    real = orch._place
    placed = []

    def place(module, device):
        placed.append(device)
        if len(placed) == 2:  # the cpu group's replica
            raise host_oom()
        return real(module, device)

    monkeypatch.setattr(orch, "_place", place)
    model = Blocks()
    pm = parallelize(model, [("cuda:0", 60), ("cpu", 40)],
                     ParallelConfig(auto_memory_balance=False))
    assert pm.chain.devices == ("cuda:0",) and pm.weights == (1.0,)
    assert [g.platform for g in pm._groups] == ["cuda"]
    x, t = torch.randn(3, 4), torch.rand(3)
    with torch.no_grad():
        np.testing.assert_allclose(pm(x, t).numpy(), model(x, t).numpy(), rtol=1e-6)


def test_other_placement_errors_still_raise(host_links, monkeypatch):
    real = orch._place
    placed = []

    def place(module, device):
        placed.append(device)
        if len(placed) == 2:
            raise RuntimeError("a broken device, not a full one")
        return real(module, device)

    monkeypatch.setattr(orch, "_place", place)
    with pytest.raises(RuntimeError, match="broken device"):
        parallelize(Blocks(), [("cuda:0", 60), ("cpu", 40)])


def test_host_oom_at_a_host_pipeline_stage_demotes(host_links):
    model = Blocks()
    pm = parallelize(DiffusionModel(module=model, pipeline_spec=SPEC),
                     [("cuda:0", 50), ("cpu", 50)], ParallelConfig(auto_memory_balance=False,
                                                                   auto_speed_balance=False))
    x, t = torch.randn(1, 4), torch.rand(1)
    with torch.no_grad():
        want = model(x, t)
    np.testing.assert_allclose(pm(x, t).numpy(), want.numpy(), rtol=1e-6)
    runner = pm._pipeline_runner
    assert runner is not None and runner.n_stages == 2
    host_stage = runner.stages[-1]
    assert host_stage.range == (1, 2)

    def full(module, carry):
        raise host_oom()

    host_stage.fns = (full,)
    np.testing.assert_allclose(pm(x, t).numpy(), want.numpy(), rtol=1e-6)
    assert not pm.active and pm._pipeline_runner is None  # demoted to the lead device


def test_host_oom_on_reactivation_keeps_the_chain_demoted(host_links, monkeypatch):
    pm = parallelize(Blocks(), [("cuda:0", 50), ("cpu", 50)],
                     ParallelConfig(auto_memory_balance=False, reactivate_after=1))
    pm._demote()
    monkeypatch.setattr(orch._PlatformGroup, "place",
                        lambda self, module: (_ for _ in ()).throw(host_oom()))
    x, t = torch.randn(2, 4), torch.rand(2)
    pm(x, t)
    pm(x, t)  # reactivation due: the host OOM keeps it demoted
    assert not pm.active and pm._steps_demoted == 1
    pm.rebalance()  # tries reactivate() too, and takes the OOM as one
    assert not pm.active
