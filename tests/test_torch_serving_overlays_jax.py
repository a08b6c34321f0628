"""The slice as a whole on the CPU: each served lane of one mixed bucket (plain,
ControlNet, per-lane LoRA, multi-cond) of the PyTorch port against the JAX package's
inline ``run_sampler`` for the same request, on the same weights (the tiny UNet and
ControlNet of ``tests/test_torch_serving_overlays.py``, carried by ``convert_jax``),
float32, within 1e-4 of the latent's scale. Its own file: the JAX side compiles the
UNet and the composed ControlNet model once each (XLA's optimisation passes off).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401
from test_torch_quick_jax import quick_jax_compiles  # noqa: E402,F401
from test_torch_serving import CTX, LATENT, _hermetic, _np, sched, unet_pair  # noqa: E402,F401
from test_torch_serving_overlays import _jax_factors, _served, kit, nets  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from comfyui_parallelanything_tpu.models import controlnet as jcn  # noqa: E402
from comfyui_parallelanything_tpu.sampling.runner import run_sampler as jax_run_sampler  # noqa: E402


def test_served_lanes_match_the_jax_inline_sampler(unet_pair, nets, kit, sched):
    """The slice as a whole: each served lane of a mixed bucket (plain, ControlNet,
    LoRA, multi-cond) against the JAX package's inline ``run_sampler`` on the same
    weights and request, float32, within 1e-4 of the latent's scale. Without CFG, so
    the JAX side compiles the UNet once for every lane but the ControlNet one (the
    CFG rows are held against the port's inline runs above)."""
    jm, pm = unet_pair
    extra = {"strength": 0.6, "area": (4, 8, 0, 0)}
    plans = {
        "plain": (pm, 71, dict(sampler="euler", steps=2)),
        "control": (kit["composed"], 72, dict(sampler="euler", steps=2)),
        "lora": (pm, 73, dict(sampler="euler", steps=2, lora=kit["lora1"])),
        "multi_cond": (pm, 74, dict(sampler="euler", steps=2, extra_conds=(
            {"context": kit["ctx2"], **extra},))),
    }
    served = _served(sched, plans)
    assert len(sched.buckets) == 1
    jcomposed = jcn.apply_control(jm, nets[0], jnp.asarray(kit["hint"]), strength=0.7)
    jmodels = {"plain": (jm, {}), "control": (jcomposed, {}),
               "lora": (jm, {"lora": _jax_factors(kit["lora1"])}),
               "multi_cond": (jm, {"extra_conds": (
                   {"context": jnp.asarray(kit["ctx2"].numpy()), **extra},)})}
    for k, (model, extra_kw) in jmodels.items():
        seed = plans[k][1]
        want = jax_run_sampler(model, jnp.asarray(_np(seed, LATENT)),
                               jnp.asarray(_np(seed + 100, CTX)), sampler="euler", steps=2,
                               **extra_kw)
        g, w = served[k].numpy(), np.asarray(want)
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g / scale, w / scale, rtol=1e-4, atol=1e-4, err_msg=k)
