"""Build the hand-written CUDA kernels of ``csrc/`` into shared libraries.

Each kernel's translation units compile with ``nvcc`` for ``sm_90a`` into objects
that link into one ``.so`` with a plain C entry point, loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds to a minute). Libraries land in
``build/kernels/`` at the repository root, named by a hash of everything that goes
into them (the sources, every ``csrc/`` header they include, directly or not, and
the compile and link flags), so an edited source or header never loads a stale
library. Nothing is built when a module is imported: the first CUDA launch of a
kernel builds it, or ``build_all`` builds every kernel at once, one ``nvcc`` process
per translation unit, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = _PACKAGE_DIR / "csrc"
BUILD_DIR = _PACKAGE_DIR.parent / "build" / "kernels"

# Kernel name -> its translation units under csrc/, the entry point's first.
SOURCES = {"flash_attention": ("flash_attention.cu", "flash_attention_wide.cu",
                                "flash_attention_tf32x3.cu", "flash_attention_f32.cu")}

COMPILE_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LINK_FLAGS = ("-shared",)
NVCC_FLAGS = COMPILE_FLAGS + LINK_FLAGS

_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)

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


def sources_of(name: str) -> list[Path]:
    """The translation units of kernel ``name`` and every header under ``csrc/`` they
    include with ``#include "..."``, directly or through another header, in include
    order."""
    seen: list[Path] = []
    todo = [CSRC_DIR / unit for unit in SOURCES[name]]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_text()):
            dep = path.parent / inc
            if dep.exists():
                todo.append(dep)
    return seen


def library_path(name: str) -> Path:
    """Where kernel ``name`` is built: named by a hash of its source, its headers and
    the compile and link flags."""
    h = hashlib.sha256()
    for path in sources_of(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _run(cmd: list[str], t0: float) -> tuple[int, str, float]:
    """Run ``cmd``; its exit code, its output and the time since ``t0`` at its end."""
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc.returncode, proc.stdout, time.perf_counter() - t0


def build_all(names=None) -> dict[str, dict]:
    """Build every named kernel (default: all) that is not built yet: one ``nvcc -c``
    per translation unit, all running at once, then one link per kernel. Returns
    ``{name: {"seconds", "cached", "units", "log"}}``: ``units`` holds the seconds
    from the start to each unit's end, ``log`` ``nvcc``'s output (register and
    shared-memory use from ``-Xptxas -v``). Raises ``RuntimeError`` naming each
    failed build."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    results: dict[str, dict] = {}
    jobs = {}
    with ThreadPoolExecutor(max_workers=sum(len(SOURCES[n]) for n in names) or 1) as pool:
        for name in names:
            out = library_path(name)
            if out.exists():
                results[name] = {"seconds": 0.0, "cached": True, "units": {}, "log": ""}
                continue
            for unit in SOURCES[name]:
                obj = out.with_name(f"{out.stem}.{Path(unit).stem}.{os.getpid()}.o")
                cmd = [_nvcc(), *COMPILE_FLAGS, "-c", "-o", str(obj), str(CSRC_DIR / unit)]
                jobs.setdefault(name, []).append((unit, obj, pool.submit(_run, cmd, t0)))
    failed = []
    for name, units in jobs.items():
        out = library_path(name)
        logs, times, compiled = [], {}, True
        for unit, _, job in units:
            rc, log, end = job.result()
            logs.append(log)
            times[unit] = end
            if rc != 0:
                compiled = False
                failed.append(f"{name}: {unit} (nvcc exit {rc}):\n{log}")
        objs = [str(obj) for _, obj, _ in units]
        if compiled:
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            rc, log, _ = _run([_nvcc(), *COMPILE_FLAGS, *LINK_FLAGS, "-o", str(tmp), *objs], t0)
            logs.append(log)
            if rc == 0:
                os.replace(tmp, out)
            else:
                failed.append(f"{name}: link (nvcc exit {rc}):\n{log}")
        for obj in objs:
            Path(obj).unlink(missing_ok=True)
        results[name] = {"seconds": time.perf_counter() - t0, "cached": False, "units": times,
                         "log": "\n".join(logs)}
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
