"""The PyTorch port stands alone: neither its package nor ``chip_smoke.py`` imports
JAX, flax, any module of the JAX package (``comfyui_parallelanything_tpu``) or the
``safetensors`` package (the GPU machine has none: the port reads and writes the
format itself), and no module imports ``triton`` or builds a kernel when it is
imported."""

import ast
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "comfyui_parallelanything_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "comfyui_parallelanything_tpu", "safetensors")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    """Absolute module names a file imports (relative imports resolve inside the port)."""
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module, node.lineno


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN


def test_rule_tells_the_port_from_the_jax_package():
    assert _forbidden("comfyui_parallelanything_tpu.ops.attention")
    assert _forbidden("jax.numpy") and _forbidden("flax.linen")
    assert _forbidden("safetensors.numpy")
    assert not _forbidden("comfyui_parallelanything_tpu_torch.ops.attention")
    assert not _forbidden("jaxtyping_like_name")


def test_port_and_chip_smoke_import_no_jax():
    files = _port_files()
    assert len(files) > 10 and (ROOT / "chip_smoke.py").exists()
    bad = [f"{p.relative_to(ROOT)}:{line} imports {name}"
           for p in files for name, line in _imported_modules(p) if _forbidden(name)]
    assert not bad, bad


def test_no_module_level_triton_or_build():
    for p in sorted(PORT.rglob("*.py")):
        tree = ast.parse(p.read_text(), filename=str(p))
        for node in tree.body:  # module level only
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in node.names] + [getattr(node, "module", None) or ""]
                assert not any(n.split(".")[0] == "triton" for n in names), p
            if isinstance(node, ast.Expr) and isinstance(node.value, ast.Call):
                assert "build" not in ast.unparse(node.value), p
