"""The PyTorch port's package exports against the JAX package's: every name in each
JAX subpackage's ``__all__`` is in the port counterpart's ``__all__`` or on the
port's documented ``NOT_EXPORTED`` list, that list names only what the port really
lacks, every exported name resolves, and the JAX subpackages without a counterpart
are named as such."""

import importlib
import inspect
import pkgutil

import pytest

pytest.importorskip("torch")

import comfyui_parallelanything_tpu as jpkg  # noqa: E402
import comfyui_parallelanything_tpu_torch as ppkg  # noqa: E402

SUBPACKAGES = ["", "sampling", "devices", "ops", "parallel", "utils", "models", "serving"]


def _pair(sub):
    suffix = f".{sub}" if sub else ""
    return (importlib.import_module(f"comfyui_parallelanything_tpu{suffix}"),
            importlib.import_module(f"comfyui_parallelanything_tpu_torch{suffix}"))


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_every_jax_name_is_exported_or_listed(sub):
    jmod, pmod = _pair(sub)
    listed = ppkg.NOT_EXPORTED.get(sub, {})
    missing = [n for n in jmod.__all__ if n not in pmod.__all__ and n not in listed]
    assert not missing, missing
    unresolved = [n for n in pmod.__all__ if not hasattr(pmod, n)]
    assert not unresolved, unresolved
    # The list names only what the port lacks under the JAX name (at most a module
    # of that name), each with a reason.
    assert all(n in jmod.__all__ and reason and (not hasattr(pmod, n) or inspect.ismodule(
        getattr(pmod, n))) for n, reason in listed.items()), listed


def test_version_and_subpackages_without_a_port():
    assert ppkg.__version__ == jpkg.__version__
    jsubs = {m.name for m in pkgutil.iter_modules(jpkg.__path__) if m.ispkg}
    psubs = {m.name for m in pkgutil.iter_modules(ppkg.__path__) if m.ispkg}
    assert jsubs - psubs == set(ppkg.NOT_PORTED_SUBPACKAGES)
    assert set(ppkg.NOT_EXPORTED) <= set(SUBPACKAGES)


# The mesh, sequence-parallel and multihost names the port exports since it ported
# them (they were on ``NOT_EXPORTED``), each the port's own function.
ITEM_7 = {"": ["build_mesh", "mesh_axis_names", "sequence_parallel_attention"],
          "parallel": ["build_mesh", "mesh_axis_names", "fsdp_spec", "place_params",
                       "place_params_fsdp", "sequence_parallel_attention",
                       "initialize_distributed", "is_multihost", "hybrid_mesh",
                       "host_local_batch"]}


@pytest.mark.parametrize("sub", list(ITEM_7))
def test_mesh_sequence_and_multihost_names_are_exported(sub):
    jmod, pmod = _pair(sub)
    listed = ppkg.NOT_EXPORTED.get(sub, {})
    for name in ITEM_7[sub]:
        assert name in jmod.__all__ and name in pmod.__all__ and name not in listed
        fn = getattr(pmod, name)
        assert callable(fn) and fn.__module__.startswith("comfyui_parallelanything_tpu_torch.")
    assert not any("item 7" in reason for reasons in ppkg.NOT_EXPORTED.values()
                   for reason in reasons.values())
