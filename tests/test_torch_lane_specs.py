"""The PyTorch port's per-lane step plans (``sampling/lane_specs.py``) against the
JAX package's: for every ``LANE_SPECS`` entry, every plan's sigma, update
coefficients, completion flag, noise draw and step index equal the JAX plan's
exactly, under an eps schedule (normal and karras, from the port's own
``make_sigmas``) and a flow schedule (shift 3), ragged lengths included. The
registries and the scheduler's ``BATCHABLE_SAMPLERS`` hold the same names. Both
modules are numpy only: no model runs here.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401

from comfyui_parallelanything_tpu.sampling import lane_specs as jls  # noqa: E402
from comfyui_parallelanything_tpu.serving.scheduler import (  # noqa: E402
    BATCHABLE_SAMPLERS as JAX_BATCHABLE,
)
from comfyui_parallelanything_tpu_torch.sampling import k_samplers as pk  # noqa: E402
from comfyui_parallelanything_tpu_torch.sampling import lane_specs as pls  # noqa: E402
from comfyui_parallelanything_tpu_torch.serving.scheduler import (  # noqa: E402
    BATCHABLE_SAMPLERS,
)


def _schedules():
    out = {}
    for n in (1, 2, 7, 20):
        out[f"normal_{n}"] = ("eps", pk.make_sigmas("normal", n))
        out[f"karras_{n}"] = ("eps", pk.make_sigmas("karras", n))
        out[f"flow_{n}"] = ("flow", pk.make_sigmas("normal", n,
                                                   sigma_table=pk.flow_sigma_table(3.0)))
    return out


SCHEDULES = _schedules()


def test_registries_and_batchable_samplers_agree():
    assert list(pls.LANE_SPECS) == list(jls.LANE_SPECS)
    for name, spec in pls.LANE_SPECS.items():
        j = jls.LANE_SPECS[name]
        assert (spec.needs_rng, spec.split_keys, spec.flow_ok) == (
            j.needs_rng, j.split_keys, j.flow_ok), name
    assert BATCHABLE_SAMPLERS == JAX_BATCHABLE == frozenset(pls.LANE_SPECS)
    # The stochastic lanes are exactly the port's stochastic samplers.
    assert {n for n, s in pls.LANE_SPECS.items() if s.needs_rng} == (
        set(pls.LANE_SPECS) & pk.RNG_SAMPLERS)


@pytest.mark.parametrize("sampler", list(jls.LANE_SPECS))
def test_plans_equal_the_jax_plans_exactly(sampler):
    spec = pls.LANE_SPECS[sampler]
    for label, (prediction, sigmas) in SCHEDULES.items():
        if prediction == "flow" and not spec.flow_ok:
            continue
        sig = sigmas.numpy()
        got = pls.plan_schedule(sampler, sig, prediction)
        want = jls.plan_schedule(sampler, sig, prediction)
        assert len(got) == len(want), (sampler, label)
        for i, (g, w) in enumerate(zip(got, want)):
            where = (sampler, label, i)
            assert g.sigma_eval == w.sigma_eval, where
            assert g.coef.dtype == w.coef.dtype == np.float32, where
            np.testing.assert_array_equal(g.coef, w.coef, err_msg=str(where))
            assert (g.completes, g.noise, g.step) == (w.completes, w.noise, w.step), where
        assert pls.lane_eval_count(sampler, sig, prediction) == len(want)
