"""The PyTorch port's MoE FFN (``ops/moe.py``) against the JAX package's on the CPU:
the forward of JAX ``test_moe.py``'s module (4 experts, d_ff 32, width 16, f32) on
the same numpy weights (carried by ``convert_jax.from_jax_moe_params``) and inputs,
at rtol/atol 2e-4 (the JAX side under the suite's ``highest`` precision); the
closed-form top-1 reference; and expert parallelism over 4 and 2 ``cpu:i`` devices
against the unsharded forward and JAX's expert-parallel program."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_quick_jax import quick_jax_compiles  # noqa: E402,F401
from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from comfyui_parallelanything_tpu.ops import moe as jmoe  # noqa: E402
from comfyui_parallelanything_tpu.parallel import mesh as jmesh  # noqa: E402
from comfyui_parallelanything_tpu_torch.models.convert_jax import (  # noqa: E402
    from_jax_moe_params,
)
from comfyui_parallelanything_tpu_torch.ops import moe as pmoe  # noqa: E402
from comfyui_parallelanything_tpu_torch.parallel import mesh as pmesh  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def pair():
    m = jmoe.MoEFFN(n_experts=4, d_ff=32, dtype=jnp.float32)
    abstract = jax.eval_shape(m.init, jax.random.key(0), jnp.zeros((1, 8, 16)))["params"]
    rng = np.random.default_rng(0)
    tree = {k: (rng.normal(size=a.shape) * (0.1 if k.startswith("b_") else 0.5)
                ).astype(np.float32) for k, a in abstract.items()}
    pm = pmoe.MoEFFN(16, 4, 32, dtype=torch.float32)
    pm.load_state_dict(from_jax_moe_params(tree))
    return m, tree, pm


def _x(seed, shape=(2, 8, 16)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_forward_matches_jax_and_the_closed_form(pair):
    m, tree, pm = pair
    x = _x(1)
    want = np.asarray(m.apply({"params": jax.tree.map(jnp.asarray, tree)}, x))
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # Closed form: each token through its top-1 expert, scaled by the winning prob.
    logits = x[0] @ tree["gate"]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    assert len(set(probs.argmax(-1))) > 1  # several experts in use
    for tok in range(x.shape[1]):
        e = int(probs[tok].argmax())
        h = torch.nn.functional.gelu(torch.from_numpy(x[0, tok] @ tree["w_in"][e]
                                                      + tree["b_in"][e]), approximate="tanh")
        row = (h.numpy() @ tree["w_out"][e] + tree["b_out"][e]) * probs[tok, e]
        np.testing.assert_allclose(got[0, tok].numpy(), row, **TOL)


def test_expert_parallel_matches_unsharded_and_jax(pair, cpu_devices):
    m, tree, pm = pair
    x = _x(4)
    jm4 = jmesh.build_mesh(cpu_devices[:4], {"model": 4})
    placed = jmoe.expert_sharding(jax.tree.map(jnp.asarray, tree), jm4, "model")
    assert placed["w_in"].addressable_shards[0].data.shape == (1, 16, 32)
    want = np.asarray(jax.jit(lambda p, x: m.apply({"params": p}, x))(placed, x))
    with torch.no_grad():
        whole = pm(torch.from_numpy(x))
    for n in (4, 2):
        ep = pmoe.MoEFFN(16, 4, 32, dtype=torch.float32)
        ep.load_state_dict(pm.state_dict())
        pmoe.expert_sharding(ep, pmesh.build_mesh([f"cpu:{i}" for i in range(n)],
                                                  {"model": n}))
        assert [s[1][0].shape for s in ep.expert_shards] == [(4 // n, 16, 32)] * n
        with torch.no_grad():
            got = ep(torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    three = pmoe.expert_sharding(ep, pmesh.build_mesh(["cpu:0"] * 3, {"model": 3}))
    assert three.expert_shards is None  # 4 experts do not split 3 ways: kept whole
