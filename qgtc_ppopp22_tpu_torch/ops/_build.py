"""Build and load the CUDA kernels of ``csrc/`` (plain C interface, ctypes).

The shared library is compiled with ``nvcc`` for ``sm_90a`` at first use
into ``qgtc_ppopp22_tpu_torch/_build/`` and rebuilt whenever a source is
newer than it. Nothing here runs at import time: a machine without
``nvcc`` imports the package and runs the plain PyTorch versions on CPU
tensors.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
LIB_PATH = BUILD_DIR / "libqgtc_kernels.so"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

_lib = None


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin); the CUDA "
        "kernels cannot be built"
    )


def build() -> tuple:
    """Compile ``csrc/*.cu`` into the shared library.

    Returns ``(seconds, ptxas_report)``; the report lists each kernel's
    registers, shared memory and spills."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIB_PATH.with_suffix(f".so.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp)]
    cmd += [str(s) for s in sorted(CSRC.glob("*.cu"))]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, LIB_PATH)
    return time.perf_counter() - t0, proc.stderr


def _stale() -> bool:
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    return any(s.stat().st_mtime > built for s in _sources())


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if missing or stale."""
    global _lib
    if _lib is None:
        if _stale():
            build()
        lib = ctypes.CDLL(str(LIB_PATH))
        p, i = ctypes.c_void_p, ctypes.c_int
        # (out, a, b, a_kind, nd_a, nd_b, mp, kp, np, out_kind, out_bits,
        #  shift, stream); see csrc/gemm_core.cuh for the meaning of each.
        lib.qgtc_digitmm.argtypes = [p, p, p, i, i, i, i, i, i, i, i, p]
        lib.qgtc_digitmm.restype = i
        lib.qgtc_packmm.argtypes = [p, p, p, i, i, i, i, i, i, i, i, p]
        lib.qgtc_packmm.restype = i
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
