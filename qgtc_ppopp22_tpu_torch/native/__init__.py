"""ctypes bindings for the native host library (``qgtc_native.cpp``).

Counterpart of ``qgtc_ppopp22_tpu/native/__init__.py`` over a copy of the
same C++ source: the multilevel partitioner (heavy-edge-matching
coarsening, greedy growing, boundary refinement), induced-subgraph
densification, quantization, bit-plane packing and CSR construction on
the host. The library is built with g++ at first use into
``qgtc_ppopp22_tpu_torch/_build/`` and rebuilt when the source is newer.
Every entry point has a NumPy counterpart elsewhere in the package, so
the package works without a toolchain; :func:`available` says which one
runs.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path
from typing import List, Optional

import numpy as np

SRC = Path(__file__).resolve().with_name("qgtc_native.cpp")
LIB_PATH = Path(__file__).resolve().parents[1] / "_build" / "libqgtc_native.so"
_lib: Optional[ctypes.CDLL] = None


class NativeUnavailable(RuntimeError):
    pass


def build(path: Path = LIB_PATH) -> None:
    """Compile ``qgtc_native.cpp`` into ``path``. g++ writes a file of this
    process's own, which then replaces ``path`` in one step, so processes
    that build at once never load a half-written library."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-fopenmp", "-shared", "-fPIC", "-std=c++17", str(SRC), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=300)
        os.replace(tmp, path)
    except (subprocess.CalledProcessError, FileNotFoundError, subprocess.TimeoutExpired) as e:
        detail = getattr(e, "stderr", "") or str(e)
        raise NativeUnavailable(f"native build failed: {detail[:500]}") from e
    finally:
        tmp.unlink(missing_ok=True)


def _stale(path: Path) -> bool:
    return not path.exists() or SRC.stat().st_mtime > path.stat().st_mtime


def load(path: Path = LIB_PATH) -> ctypes.CDLL:
    """The library at ``path`` (built first if missing or stale), its
    entry points typed."""
    if _stale(path):
        build(path)
    lib = ctypes.CDLL(str(path))
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    f32p = ctypes.POINTER(ctypes.c_float)
    i64 = ctypes.c_int64
    lib.csr_from_edges.restype = i64
    lib.csr_from_edges.argtypes = [i64p, i64p, i64, i64, i64p, i64p]
    lib.partition_graph.restype = ctypes.c_int32
    lib.partition_graph.argtypes = [i64p, i64p, i64, i64, ctypes.c_uint64, i32p]
    lib.subgraph_dense.restype = None
    lib.subgraph_dense.argtypes = [i64p, i64p, i64p, i64, i64, u8p]
    lib.quantize_f32.restype = None
    lib.quantize_f32.argtypes = [f32p, i64, ctypes.c_int32, i32p]
    lib.pack_bits_u32.restype = None
    lib.pack_bits_u32.argtypes = [i32p, i64, i64, ctypes.c_int32, i64, i64, u32p]
    return lib


def get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = load()
    return _lib


def available() -> bool:
    try:
        get_lib()
        return True
    except (NativeUnavailable, OSError):
        return False


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def partition_native(g, psize: int, seed: int = 0) -> List[np.ndarray]:
    """Multilevel partition of ``g`` into ``psize`` sorted node-id lists, as
    :func:`qgtc_ppopp22_tpu_torch.graph.partition.get_partition_list`
    returns them."""
    lib = get_lib()
    adj = g.undirected_scipy()
    indptr = np.ascontiguousarray(adj.indptr, np.int64)
    indices = np.ascontiguousarray(adj.indices, np.int64)
    labels = np.empty(g.num_nodes, np.int32)
    rc = lib.partition_graph(_ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int64),
                             g.num_nodes, psize, seed, _ptr(labels, ctypes.c_int32))
    if rc != 0:
        raise NativeUnavailable(f"partition_graph rc={rc}")
    order = np.argsort(labels, kind="stable")
    bounds = np.searchsorted(labels[order], np.arange(psize + 1))
    return [np.sort(order[bounds[i]:bounds[i + 1]]).astype(np.int64) for i in range(psize)]


def subgraph_dense_native(indptr: np.ndarray, indices: np.ndarray, nodes: np.ndarray,
                          padded: int) -> np.ndarray:
    """The induced 0/1 adjacency of the ascending ``nodes``, uint8[padded,
    padded], zero outside ``[:len(nodes), :len(nodes)]``."""
    lib = get_lib()
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int64)
    nodes = np.ascontiguousarray(nodes, np.int64)
    dense = np.zeros((padded, padded), np.uint8)
    lib.subgraph_dense(_ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int64),
                       _ptr(nodes, ctypes.c_int64), len(nodes), padded, _ptr(dense, ctypes.c_uint8))
    return dense


def quantize_native(x: np.ndarray, bits: int) -> np.ndarray:
    """float32 -> int32 levels, as ``graph.batching.quantize_np``."""
    lib = get_lib()
    x = np.ascontiguousarray(x, np.float32)
    q = np.empty(x.shape, np.int32)
    lib.quantize_f32(_ptr(x, ctypes.c_float), x.size, bits, _ptr(q, ctypes.c_int32))
    return q


def pack_bits_native(q: np.ndarray, bits: int, Mp: int, Kp: int) -> np.ndarray:
    """int32 levels (M, K) -> zero-padded packed uint32 planes [bits, Mp/32,
    Kp], the layout of ``ops.bitpack.BitTensor``."""
    lib = get_lib()
    q = np.ascontiguousarray(q, np.int32)
    M, K = q.shape
    planes = np.zeros((bits, Mp // 32, Kp), np.uint32)
    lib.pack_bits_u32(_ptr(q, ctypes.c_int32), M, K, bits, Mp, Kp, _ptr(planes, ctypes.c_uint32))
    return planes


def pack_bits_u32_2d(q: np.ndarray, bits: int, Mp: int, Kp: int) -> np.ndarray:
    """:func:`pack_bits_native` of levels of any integer dtype."""
    return pack_bits_native(np.asarray(q, np.int32), bits, Mp, Kp)


def csr_from_edges_native(src: np.ndarray, dst: np.ndarray, n: int) -> tuple:
    """Deduplicated in-adjacency CSR ``(indptr, indices)`` of the directed
    edges ``src -> dst``, as ``graph.csr.from_edges``."""
    lib = get_lib()
    src = np.ascontiguousarray(src, np.int64)
    dst = np.ascontiguousarray(dst, np.int64)
    indptr = np.empty(n + 1, np.int64)
    indices = np.empty(len(src), np.int64)
    nnz = lib.csr_from_edges(_ptr(src, ctypes.c_int64), _ptr(dst, ctypes.c_int64), len(src), n,
                             _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int64))
    return indptr, indices[:nnz].copy()
