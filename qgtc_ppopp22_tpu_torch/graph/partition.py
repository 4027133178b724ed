"""Graph partitioning for cluster batching (METIS-equivalent role).

The reference calls DGL's METIS binding
(``partition_utils.py:11-18`` -> ``dgl.transform.metis_partition``) to
split the graph into ``psize`` clusters, then caches the partition list
to ``datasets/<name>_<psize>.npy`` (``sampler.py:56-63``). METIS is not
a dependency of this framework; the same role — locality-preserving,
balanced node clusters so each batch's dense adjacency is small and
dense-ish — is filled by two built-in methods:

* ``bfs`` (default fallback): greedy BFS graph-growing — repeatedly
  seed an unassigned node at a low-degree periphery and grow a cluster
  to the target size. The classic graph-growing partitioner; keeps
  clusters connected and markedly lower edge-cut than ordering-based
  chunking on community-structured graphs.
* ``rcm``: reverse-Cuthill-McKee bandwidth-minimizing ordering of the
  symmetrized adjacency, chopped into ``psize`` equal contiguous
  chunks. One vectorized SciPy call — fast, but BFS-level interleaving
  gives a worse cut on small-world graphs; kept as an option.

A native C++ multilevel partitioner (heavy-edge-matching coarsening,
greedy growing, boundary refinement; :mod:`qgtc_ppopp22_tpu_torch.native`)
is ``method='native'``, and ``method='auto'`` takes it when its library
builds, else ``bfs``, as the JAX package resolves ``auto``. These NumPy
methods are the portable fallback and the reference it is held against.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import scipy.sparse as sp
from scipy.sparse.csgraph import reverse_cuthill_mckee

from qgtc_ppopp22_tpu_torch.graph.csr import CSRGraph


def _chunk_order(order: np.ndarray, psize: int) -> List[np.ndarray]:
    """Split an ordering into psize near-equal contiguous chunks."""
    return [np.sort(c) for c in np.array_split(order, psize)]


def _partition_rcm(adj: sp.csr_matrix, psize: int) -> List[np.ndarray]:
    order = np.asarray(reverse_cuthill_mckee(adj, symmetric_mode=True))
    return _chunk_order(order.astype(np.int64), psize)


def _partition_bfs(adj: sp.csr_matrix, psize: int) -> List[np.ndarray]:
    n = adj.shape[0]
    target = -(-n // psize)
    indptr, indices = adj.indptr, adj.indices
    assigned = np.zeros(n, bool)
    parts: List[np.ndarray] = []
    # Seed from lowest-degree unassigned nodes (peripheral starts).
    seed_order = np.argsort(np.diff(indptr), kind="stable")
    seed_pos = 0
    for _ in range(psize - 1):
        members: List[int] = []
        frontier: List[int] = []
        while len(members) < target:
            if not frontier:
                while seed_pos < n and assigned[seed_order[seed_pos]]:
                    seed_pos += 1
                if seed_pos >= n:
                    break
                s = int(seed_order[seed_pos])
                assigned[s] = True
                members.append(s)
                frontier = [s]
                continue
            nxt: List[int] = []
            for u in frontier:
                for v in indices[indptr[u] : indptr[u + 1]]:
                    if not assigned[v]:
                        assigned[v] = True
                        members.append(int(v))
                        nxt.append(int(v))
                        if len(members) >= target:
                            break
                if len(members) >= target:
                    break
            frontier = nxt
        if not members:
            break
        parts.append(np.sort(np.array(members, np.int64)))
    rest = np.flatnonzero(~assigned).astype(np.int64)
    parts.append(rest)
    while len(parts) < psize:
        parts.append(np.array([], np.int64))
    return parts


def resolve_method(method: str) -> str:
    """The partitioner ``method`` names: ``'auto'`` is ``'native'`` when the
    native library builds, else ``'bfs'`` (JAX
    ``graph/partition.py:110-118``); any other name is itself."""
    if method != "auto":
        return method
    from qgtc_ppopp22_tpu_torch import native

    return "native" if native.available() else "bfs"


def get_partition_list(
    g: CSRGraph,
    psize: int,
    method: str = "auto",
    cache_dir: Optional[str] = None,
    cache_name: Optional[str] = None,
) -> List[np.ndarray]:
    """Partition ``g`` into ``psize`` clusters of node ids.

    Equivalent of ``partition_utils.get_partition_list``
    (``partition_utils.py:11-18``), with the reference's on-disk cache
    behavior (``sampler.py:56-63``) when ``cache_dir``/``cache_name``
    are given. ``method='auto'`` is :func:`resolve_method`'s.
    """
    # Resolve before the cache lookup so the cache is keyed by the
    # algorithm that actually produced it.
    method = resolve_method(method)

    if cache_dir and cache_name:
        # Key includes graph size so a rescaled/reseeded synthetic
        # graph never silently reuses another graph's partitions.
        fn = os.path.join(
            cache_dir,
            f"{cache_name}_n{g.num_nodes}_e{g.num_edges}"
            f"_{psize}_{method}.npz",
        )
        if os.path.exists(fn):
            with np.load(fn, allow_pickle=False) as z:
                return [z[f"p{i}"] for i in range(int(z["psize"]))]

    if method == "rcm":
        parts = _partition_rcm(g.undirected_scipy(), psize)
    elif method == "bfs":
        parts = _partition_bfs(g.undirected_scipy(), psize)
    elif method == "native":
        from qgtc_ppopp22_tpu_torch.native import partition_native

        parts = partition_native(g, psize)
    else:
        raise ValueError(f"unknown partition method {method!r}")

    if cache_dir and cache_name:
        os.makedirs(cache_dir, exist_ok=True)
        np.savez(
            fn,
            psize=np.int64(len(parts)),
            **{f"p{i}": p for i, p in enumerate(parts)},
        )
    return parts


def edge_cut_fraction(g: CSRGraph, parts: List[np.ndarray]) -> float:
    """Fraction of edges crossing cluster boundaries (quality metric)."""
    label = np.full(g.num_nodes, -1, np.int64)
    for i, p in enumerate(parts):
        label[p] = i
    a = g.to_scipy().tocoo()
    cut = int(np.sum(label[a.row] != label[a.col]))
    return cut / max(a.nnz, 1)
