"""Tensor parallelism of the PyTorch port over the SD-family UNet against the JAX
package on the CPU: JAX ``test_tp.py``'s tiny UNet wrapped with
``tensor_parallel=2`` on ``cpu:0..3``, its Linear layers and its convolutions split
over the model axis (``parallel/sharding.py``), against the JAX forward at rtol/atol
2e-3, as the JAX test holds its own. Weights are numpy draws for the JAX module's
abstract tree, carried by ``convert_jax.from_jax_unet_params``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_quick_jax import quick_jax_compiles  # noqa: E402,F401
from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from comfyui_parallelanything_tpu.models import unet as junet  # noqa: E402
from comfyui_parallelanything_tpu_torch import parallelize  # noqa: E402
from comfyui_parallelanything_tpu_torch.models import unet as punet  # noqa: E402
from comfyui_parallelanything_tpu_torch.models.convert_jax import (  # noqa: E402
    from_jax_unet_params,
)
from comfyui_parallelanything_tpu_torch.parallel.orchestrator import (  # noqa: E402
    ParallelConfig,
)

from test_torch_unet import _configs, _numpy_tree  # noqa: E402

CPU4 = [f"cpu:{i}" for i in range(4)]


@pytest.fixture(autouse=True)
def _hermetic(monkeypatch):
    monkeypatch.setenv("PA_PLANNER", "0")


def test_tp_unet_with_its_convolutions_split_matches_jax():
    # JAX test_tp.py's tiny UNet.
    jcfg, pcfg = _configs(dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                               attention_levels=(1,), transformer_depth=(0, 1), num_heads=4,
                               context_dim=64, norm_groups=8))
    module = junet.UNet2D(jcfg)
    abstract = jax.eval_shape(module.init, jax.random.key(0), jnp.zeros((1, 16, 16, 4)),
                              jnp.zeros((1,)), jnp.zeros((1, 12, 64)))["params"]
    tree = _numpy_tree(abstract, seed=4)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(4, 16, 16, 4)).astype(np.float32)
    ctx = rng.normal(size=(4, 12, 64)).astype(np.float32)
    t = np.full((4,), 500.0, np.float32)
    want = np.asarray(jax.jit(lambda p, *a: module.apply({"params": p}, *a))(
        jax.tree.map(jnp.asarray, tree), x, t, ctx))
    pm_model = punet.build_unet(pcfg, device="cpu", state_dict=from_jax_unet_params(tree))
    pm = parallelize(pm_model, [(d, 25) for d in CPU4], ParallelConfig(tensor_parallel=2))
    placed = pm._groups[0].placed
    convs = [n for n, e in placed.entries.items() if e.sharded and e.layout.kind == "conv"]
    assert convs, "expected a convolution split over the model axis"
    got = pm(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)
    pm.cleanup()
