"""Build the hand-written CUDA kernels of ``csrc/`` into shared libraries.

Each source compiles with ``nvcc`` for ``sm_90a`` into a ``.so`` with a plain C
entry point, loaded with ``ctypes`` (no PyTorch headers, so a build takes seconds).
Libraries land in ``build/kernels/`` at the repository root, named by a hash of
their source, so an edited source never loads a stale library. Nothing is built
when a module is imported: the first CUDA launch of a kernel builds it, or
``build_all`` builds every kernel at once, one ``nvcc`` process per source, all
started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = _PACKAGE_DIR / "csrc"
BUILD_DIR = _PACKAGE_DIR.parent / "build" / "kernels"

# Kernel name -> source file under csrc/.
SOURCES = {"flash_attention": "flash_attention.cu"}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def library_path(name: str) -> Path:
    """Where kernel ``name`` is built: named by a hash of its source and flags."""
    src = CSRC_DIR / SOURCES[name]
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_all(names=None) -> dict[str, dict]:
    """Build every named kernel (default: all) that is not built yet, one ``nvcc``
    per source, all running at once. Returns ``{name: {"seconds", "cached",
    "log"}}``, ``log`` holding ``nvcc``'s output (register and shared-memory use
    from ``-Xptxas -v``). Raises ``RuntimeError`` naming each failed build."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    results: dict[str, dict] = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            results[name] = {"seconds": 0.0, "cached": True, "log": ""}
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
        results[name] = {"seconds": time.perf_counter() - t0, "cached": False, "log": log}
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return results


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build_all([name])
        lib = _LOADED[name] = ctypes.CDLL(str(library_path(name)))
    return lib
