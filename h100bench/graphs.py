"""The benchmark's inputs: a traffic file's graph and the features a seed draws.

Frozen copies of the port's generators, so that a later change to the port
cannot move the yardstick:

* :func:`synthetic_edges` is ``qgtc_ppopp22_tpu_torch/graph/datasets.py:109-136``;
* :func:`in_adjacency` is ``graph/csr.py:83-108`` (``from_edges``) without the
  self-loop option, over both directions of every edge as
  ``graph/datasets.py:199-201`` inserts them;
* :func:`node_data` is the node-data rule of ``graph/datasets.py:202-216``
  (``synthesize``): community labels and noisy label-indicator features.

The topology depends only on the traffic file (node and edge counts, graph
seed); the features on ``--seed`` alone. Topologies are cached under
``_cache/graphs`` inside the checkout, keyed by everything that makes them.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Tuple

import numpy as np
import scipy.sparse as sp


def synthetic_edges(n: int, m: int, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Locality-biased random edge list with ~m directed edges: half a ring
    lattice (community structure a partitioner can exploit), half log-uniform
    edge lengths (hubs and a heavy tail of global edges); no self loops."""
    rng = np.random.default_rng(seed)
    k = max(2, m // (2 * n))  # ring half-degree
    src_ring = np.repeat(np.arange(n, dtype=np.int64), k)
    offs = np.tile(np.arange(1, k + 1, dtype=np.int64), n)
    dst_ring = (src_ring + offs) % n
    n_rand = max(0, m - len(src_ring)) // 2
    src_sw = rng.integers(0, n, n_rand, dtype=np.int64)
    length = np.exp(rng.random(n_rand) * np.log(max(n - 1, 2))).astype(np.int64)
    sign = rng.integers(0, 2, n_rand, dtype=np.int64) * 2 - 1
    dst_sw = (src_sw + sign * np.maximum(length, 1)) % n
    src = np.concatenate([src_ring, src_sw])
    dst = np.concatenate([dst_ring, dst_sw])
    keep = src != dst
    return src[keep], dst[keep]


def in_adjacency(src: np.ndarray, dst: np.ndarray, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """``(indptr int64[n+1], indices int64[nnz])``: row ``i`` lists the sources
    of the edges into ``i``, duplicates collapsed, columns ascending."""
    a = sp.csr_matrix((np.ones(len(src), np.uint8), (dst, src)), shape=(n, n), dtype=np.uint8)
    a.sum_duplicates()
    return a.indptr.astype(np.int64), a.indices.astype(np.int64)


def graph(traffic: dict, cache: Path) -> Tuple[np.ndarray, np.ndarray]:
    """The traffic file's symmetric stand-in graph as an in-adjacency CSR
    ``(indptr, indices)``, from the cache when it holds it."""
    n, m, gseed = int(traffic["nodes"]), int(traffic["edges"]), int(traffic["graph_seed"])
    path = cache / "graphs" / f"{traffic['dataset']}_n{n}_m{m}_g{gseed}.npz"
    if path.exists():
        with np.load(path) as z:
            return z["indptr"].astype(np.int64), z["indices"].astype(np.int64)
    src, dst = synthetic_edges(n, m, gseed)
    indptr, indices = in_adjacency(np.concatenate([src, dst]), np.concatenate([dst, src]), n)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.npz")
    np.savez(tmp, indptr=indptr, indices=indices.astype(np.int32))
    os.replace(tmp, path)
    return indptr, indices


def node_data(n: int, feat_dim: int, num_classes: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """``(features float32[n, feat_dim], labels int64[n])`` for ``seed``:
    labels by id-block community, features N(0, 1) with 2.5 added at each
    node's label column (modulo the width)."""
    rng = np.random.default_rng(seed + 1)
    n_comm = max(num_classes, 4 * num_classes)
    comm = (np.arange(n, dtype=np.int64) * n_comm) // max(n, 1)
    labels = comm % num_classes
    feats = rng.standard_normal((n, feat_dim)).astype(np.float32)
    feats[np.arange(n), labels % feat_dim] += 2.5
    return feats, labels.astype(np.int64)
