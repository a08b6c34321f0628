"""The SLO plane of the PyTorch port (``utils/slo.py``) against the JAX package's on
the CPU.

- The same observations and objectives (including ``PA_SLO_OBJECTIVES`` strings
  the JAX ``parse_objectives`` rejects, which the port rejects too) go into a JAX
  ``SloRegistry`` and a port one, each writing into a fresh metrics registry of its
  package: the ``pa_slo_*`` exposition texts are equal line for line, and so are
  the verdicts read back from them (``verdicts_from_text``, ``histogram_quantile``,
  ``fraction_under``) and the windowed verdicts. ``PA_SLO=0`` writes nothing.

The graph host's spans and SLO stages against the JAX host:
``tests/test_torch_graphs_trace.py``.
"""

import json

import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

import comfyui_parallelanything_tpu.utils.metrics as jmetrics  # noqa: E402
from comfyui_parallelanything_tpu.utils import slo as jslo  # noqa: E402
import comfyui_parallelanything_tpu_torch.utils.metrics as pmetrics  # noqa: E402
from comfyui_parallelanything_tpu_torch.utils import slo as pslo  # noqa: E402

OBJECTIVES = json.dumps([
    {"name": "fast", "threshold_s": 0.2, "target": 0.9},
    {"name": "slow", "threshold_s": 3.0, "target": 0.99, "window_s": 60},
    {"name": "default_target", "threshold_s": 0.05},
])
REJECTED = ['not json', '{"name": "x"}', '[{"threshold_s": 1}]', '[{"name": "x"}]',
            '[3]', '[{"name": "x", "threshold_s": "soon"}]']
SAMPLES = [0.001, 0.03, 0.049, 0.05, 0.12, 0.2, 0.21, 0.9, 2.5, 3.0, 3.5, 11.0, 0.0004]


@pytest.fixture
def fresh_registries(monkeypatch):
    """A fresh metrics registry behind each package's SLO writes."""
    j, p = jmetrics.MetricsRegistry(), pmetrics.MetricsRegistry()
    monkeypatch.setattr(jmetrics, "registry", j)
    monkeypatch.setattr(pmetrics, "registry", p)
    monkeypatch.delenv("PA_SLO", raising=False)
    return j, p


def _drive(mod):
    reg = mod.SloRegistry(mod.parse_objectives(OBJECTIVES))
    for i, s in enumerate(SAMPLES):
        reg.observe_request(s)
        reg.observe_stage(mod.STAGES[i % len(mod.STAGES)], s / 3)
    reg.publish_gauges()
    return reg


def test_exposition_and_verdicts_equal_jax(fresh_registries):
    j, p = fresh_registries
    jreg, preg = _drive(jslo), _drive(pslo)
    text_j, text_p = j.render(), p.render()
    assert [ln for ln in text_p.splitlines() if "pa_slo_" in ln] == [
        ln for ln in text_j.splitlines() if "pa_slo_" in ln]
    assert "pa_slo_burn_rate" in text_p and "pa_slo_stage_seconds_bucket" in text_p
    objectives = pslo.parse_objectives(OBJECTIVES)
    assert objectives == [pslo.Objective(**o.__dict__)
                          for o in jslo.parse_objectives(OBJECTIVES)]
    assert pslo.verdicts_from_text(text_p, objectives) == jslo.verdicts_from_text(
        text_j, jslo.parse_objectives(OBJECTIVES))
    for q in (50, 95, 99):
        assert pslo.histogram_quantile(text_p, "pa_slo_request_seconds", q) == (
            jslo.histogram_quantile(text_j, "pa_slo_request_seconds", q))
        assert pslo.histogram_quantile(text_p, "pa_slo_stage_seconds", q,
                                       labels={"stage": "eval"}) == jslo.histogram_quantile(
            text_j, "pa_slo_stage_seconds", q, labels={"stage": "eval"})
    assert pslo.fraction_under(text_p, "pa_slo_request_seconds", 0.2) == (
        jslo.fraction_under(text_j, "pa_slo_request_seconds", 0.2))
    drop = ("window_clipped",)
    assert [{k: v for k, v in d.items() if k not in drop} for d in preg.verdicts()] == [
        {k: v for k, v in d.items() if k not in drop} for d in jreg.verdicts()]
    assert pslo.request_bounds(objectives) == jslo.request_bounds(
        jslo.parse_objectives(OBJECTIVES))
    assert pslo.STAGES == jslo.STAGES and pslo.STAGE_BOUNDS == jslo.STAGE_BOUNDS


@pytest.mark.parametrize("raw", REJECTED)
def test_objective_strings_rejected_as_jax_rejects_them(raw, monkeypatch):
    with pytest.raises(ValueError):
        jslo.parse_objectives(raw)
    with pytest.raises(ValueError):
        pslo.parse_objectives(raw)
    monkeypatch.setenv("PA_SLO_OBJECTIVES", raw)
    with pytest.raises(ValueError):
        pslo.objectives_from_env()


def test_objectives_from_env_and_defaults(monkeypatch):
    monkeypatch.delenv("PA_SLO_OBJECTIVES", raising=False)
    assert [o.name for o in pslo.objectives_from_env()] == [
        o.name for o in jslo.objectives_from_env()] == ["request_under_30s"]
    monkeypatch.setenv("PA_SLO_OBJECTIVES", OBJECTIVES)
    assert [o.threshold_s for o in pslo.objectives_from_env()] == [0.2, 3.0, 0.05]


def test_pa_slo_0_is_a_no_op(fresh_registries, monkeypatch):
    _, p = fresh_registries
    monkeypatch.setenv("PA_SLO", "0")
    pslo.observe_request(1.0)
    pslo.observe_stage("eval", 1.0)
    pslo.registry.publish_gauges()
    assert "pa_slo_" not in p.render()
    assert pslo.registry.snapshot()["enabled"] is False
