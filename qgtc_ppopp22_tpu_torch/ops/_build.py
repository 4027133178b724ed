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
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

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
    """Compile ``csrc/*.cu`` into the shared library: one ``nvcc`` per
    source, all started together, then one link.

    Returns ``(seconds, ptxas_report)``; the report lists each kernel's
    registers, shared memory and spills."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIB_PATH.with_suffix(f".so.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{src.stem}.{os.getpid()}.o"  # nvcc links only *.o
        cmd = [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.PIPE, text=True)))
    report, failed = [], []
    for obj, proc in jobs:
        out, err = proc.communicate()
        report.append(err)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{out}\n{err}")
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        link = subprocess.run([_nvcc(), *ARCH, "-shared", "-o", str(tmp),
                               *(str(o) for o, _ in jobs)], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
        os.replace(tmp, LIB_PATH)
    finally:
        for obj, _ in jobs:
            obj.unlink(missing_ok=True)
    return time.perf_counter() - t0, "".join(report)


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
        # packmm's 17 arguments: (out, a, b, field width, nd_b, mp, kp,
        # np, out_kind, out_bits, shift, ocp, kidx, kcnt, tile_m, tile_k,
        # stream), ocp the stored columns of the f32, i32 and packed
        # outputs, kidx / kcnt the TileMap (null: dense); see
        # csrc/gemm_core.cuh.
        mapped = [p, p, p, i, i, i, i, i, i, i, i, i, p, p, i, i, p]
        # digitmm takes (out, a, b, kidx, kcnt, meta, stream): meta is a
        # host int array of the sizes, the real extents and
        # ops/digitmm.py digitmm_plan's launch, laid out in csrc/digitmm.cu.
        lib.qgtc_digitmm.argtypes = [p] * 7
        lib.qgtc_digitmm.restype = i
        # packmm adds (n, bnt, grid x/y/z, cluster x/y/z) before the
        # stream: B's real columns and the plan (ops/packmm.py
        # packmm_plan, or packmm_signed_plan for an 8-bit A), which the C
        # entry checks.
        lib.qgtc_packmm.argtypes = mapped[:-1] + [i] * 8 + [p]
        lib.qgtc_packmm.restype = i
        # (out, a, plane_t, corr, mp, kp, np, out_kind, out_bits, shift,
        # ocp, mask_n, bnt, grid x/y/z, cluster x/y/z, stream); see
        # csrc/packmm_signed.cu.
        lib.qgtc_packmm_signed.argtypes = [p, p, p, p] + [i] * 15 + [p]
        lib.qgtc_packmm_signed.restype = i
        # (out, a, x, w, corr, sched, scratch, meta, n_meta, stream); meta
        # is a host int array, laid out in csrc/fused_model.cu.
        lib.qgtc_fused_model.argtypes = [p, p, p, p, p, p, p, p, i, p]
        lib.qgtc_fused_model.restype = i
        # (out, a, x, w, scratch, bar, meta, n_meta, stream); meta laid
        # out in csrc/fused_baseline.cu, bar the groups' zeroed counters.
        lib.qgtc_fused_baseline.argtypes = [p, p, p, p, p, p, p, i, p]
        lib.qgtc_fused_baseline.restype = i
        # (out, a, b, kidx, kcnt, meta, stream); meta is a host int array
        # of the sizes, B's real columns and ops/bitgemm.py bitmm_plan's
        # launch, which the C entry checks; laid out in csrc/bitmm.cu.
        lib.qgtc_bitmm.argtypes = [p] * 7
        lib.qgtc_bitmm.restype = i
        # The kernel-study probes (benchmarks/): (out, a, b, variant,
        # field_bits, mp, kp, np, tm, bnt, splits, stages, depth, stream),
        # csrc/exp_packmm.cu; (out, a,
        # b, field_bits, out_bits, mp, kp, np, g, bnt, splits, stages,
        # depth, stream), csrc/exp_packmm_packed.cu; (out, x, m, n, stream) and
        # (a_regs, b_regs, a, b, stream), csrc/exp_bitcast_probe.cu; (out, x,
        # B, pn, xp, oc, G, rows, cl, stream) and (out, x, s, B, pn, oc, K,
        # rows, cl, stages, stream), csrc/grid_overhead.cu.
        probes = {"qgtc_exp_packmm": [p, p, p] + [i] * 10 + [p],
                  "qgtc_exp_packedout": [p, p, p] + [i] * 10 + [p],
                  "qgtc_bitcast32to8": [p, p, i, i, p], "qgtc_bitcast8to32": [p, p, i, i, p],
                  "qgtc_fragment_probe": [p, p, p, p, p],
                  "qgtc_zero_body": [p, p] + [i] * 7 + [p],
                  "qgtc_kdot": [p, p, p] + [i] * 7 + [p]}
        for entry, args in probes.items():
            getattr(lib, entry).argtypes = args
            getattr(lib, entry).restype = i
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
