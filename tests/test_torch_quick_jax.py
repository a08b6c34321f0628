"""Quick XLA compiles for the JAX references of the port's heaviest parity files.

A parity file runs each JAX reference program once or twice, so on the CPU the
time goes to compiling it: XLA's optimisation passes take about half of it. The
parity files whose time is the JAX side's compiles import ``quick_jax_compiles``
(the Wan, video-VAE, FLUX, UNet, MMDiT, ControlNet, VAE, sampler, pipeline, graph,
node, loader and parallel-axes files among them), which turns those passes off
(``jax_disable_most_optimizations``) for their module and restores the setting
after. The programs compute the same functions; only how XLA schedules
and fuses them changes.
"""

import pytest

jax = pytest.importorskip("jax")


@pytest.fixture(autouse=True, scope="module")
def quick_jax_compiles():
    before = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


def test_quick_compiles_inside_a_parity_module():
    assert jax.config.values["jax_disable_most_optimizations"] is True
