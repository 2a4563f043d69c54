"""Build the port's CUDA sources into shared libraries at first use.

Each ``csrc/*.cu`` source has a plain C interface and is compiled by the
CUDA toolkit's ``nvcc`` for Hopper (``sm_90a``) into its own ``.so``,
which the kernel modules load with ``ctypes``. The library name carries a
digest of the source and the flags, so an edited source is rebuilt and an
unchanged one is reused. Builds land in ``build/repro_torch_kernels/`` at
the repository root (git-ignored). Nothing here runs at import time: the
CPU tests import every module on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

_KERNELS = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS.parents[2] / "build" / "repro_torch_kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

SOURCES: Dict[str, Path] = {
    name: _KERNELS / name / "csrc" / f"{name}.cu"
    for name in ("zoo_dual_matmul", "flash_attention", "rmsnorm",
                 "ssd_chunk")
}

_LIBS: Dict[str, ctypes.CDLL] = {}
_REPORTS: Dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError(
            "nvcc not found (neither on PATH nor /usr/local/cuda/bin): the "
            "port's CUDA kernels are compiled by the CUDA toolkit at first use")
    return found


def library_path(name: str) -> Path:
    src = SOURCES[name]
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile every named source that has no library yet, one ``nvcc``
    per source, all started together. Returns each name's compiler report
    (``-Xptxas -v``: registers, shared memory, spills); raises
    ``RuntimeError`` with the compiler's output if a build fails."""
    names = list(SOURCES) if names is None else list(names)
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    failures = []
    for name, (proc, tmp, out) in jobs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"nvcc failed for {name} (exit "
                            f"{proc.returncode}):\n{text}")
            continue
        os.replace(tmp, out)     # atomic: a reader never sees a partial .so
        _REPORTS[name] = text
    if failures:
        raise RuntimeError("\n".join(failures))
    return {name: _REPORTS.get(name, f"(built earlier: {library_path(name)})")
            for name in names}


def load(name: str) -> ctypes.CDLL:
    """The named kernel library, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return lib


def ensure_loaded(names: Iterable[str]) -> float:
    """Build (all together) and load every named library not loaded yet;
    returns the seconds this took, 0.0 when all were loaded already. A
    caller that times its own work calls this first, so a first-use build
    is reported apart from the run."""
    missing = [name for name in names if name not in _LIBS]
    if not missing:
        return 0.0
    t0 = time.perf_counter()
    build_all(missing)
    for name in missing:
        load(name)
    return time.perf_counter() - t0
