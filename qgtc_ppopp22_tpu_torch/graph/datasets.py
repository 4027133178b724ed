"""Dataset loading: reference-format npz graphs, plus synthetic stand-ins.

The reference loads graphs three ways: ``qgtc_graphs/<name>.npz`` edge
lists (``dataset.py:48-53``), DGL built-ins / ppi (``utils.py:62-97``),
and OGB (``main_qgtc.py:59-65``). It then *synthesizes* features
(``torch.randn(N, dim)``, ``dataset.py:62-64``) and constant labels
(``dataset.py:66-67``) for the npz graphs, with overlapping
train/val/test prefix masks (``dataset.py:23-32``) — the published
epoch numbers on artist/soc-BlogCatalog/Proteins are throughput-only
(SURVEY quirk 6).

This module reproduces the npz path exactly and, because this build
environment has no network egress and no DGL/OGB, provides synthetic
generators whose node/edge counts match the reference datasets'
published statistics, so the benchmark workload (dense-batch sizes,
adjacency sparsity inside clusters) is comparable. Real npz files in
the reference's format are used when present.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import numpy as np

from qgtc_ppopp22_tpu_torch.graph.csr import CSRGraph, from_edges


@dataclasses.dataclass(frozen=True)
class GraphDataset:
    """A loaded graph + synthesized/loaded node data.

    Mirrors the fields the reference's scripts consume
    (``main_qgtc.py:74-80``): graph, float features, int labels,
    train/val/test masks.
    """

    name: str
    graph: CSRGraph
    features: np.ndarray  # float32[N, dim]
    labels: np.ndarray  # int64[N]
    num_classes: int
    train_mask: np.ndarray
    val_mask: np.ndarray
    test_mask: np.ndarray
    # Multilabel task matrix (ppi: 121 binary labels per node,
    # reference ``utils.py:69-96`` loads real ppi and evaluates
    # micro/macro F1 via ``calc_f1``). None for single-label datasets.
    multilabels: Optional[np.ndarray] = None  # int8[N, num_classes]

    @property
    def num_nodes(self) -> int:
        return self.graph.num_nodes

    @property
    def feat_dim(self) -> int:
        return int(self.features.shape[1])


# Per-dataset partition counts: the reference uses psize=1500
# everywhere (``0_7a…py:8``), which is fine up to ~170k nodes; at
# ogbn-products scale (2.4M nodes) a 20-partition batch would be a
# 32k-node dense adjacency (1 GB) — infeasible for ANY dense-tile
# engine (the reference's scripts list products but its artifact
# tables stop at arxiv). Scale psize with the graph instead.
DEFAULT_PSIZE = {"ogbn-products": 25000, "reddit": 2500}

# Synthetic-graph CSR topologies above this edge count are cached on
# disk by load_dataset (reddit's 114M-edge stand-in takes ~15 min to
# build; everything else regenerates in seconds).
_CSR_CACHE_MIN_EDGES = 10_000_000


# name -> (num_nodes, num_edges, feat_dim, num_classes)
# Published statistics of the reference's benchmark datasets
# (QGTC paper Table 2 / GNNAdvisor dataset table; reference harness
# configs ``0_7a_eval_QGTC_cluster_GCN.py:6-16``).
DATASET_STATS: Dict[str, Tuple[int, int, int, int]] = {
    "Proteins": (43_471, 162_088, 29, 2),
    "artist": (50_515, 1_638_396, 100, 12),
    "soc-BlogCatalog": (88_784, 2_093_195, 128, 39),
    "ppi": (56_944, 818_716, 50, 121),
    "ogbn-arxiv": (169_343, 1_166_243, 128, 40),
    "reddit": (232_965, 114_615_892, 602, 41),
    "ogbn-products": (2_449_029, 61_859_140, 100, 47),
}


def _label_proj(ncls: int, dim: int) -> np.ndarray:
    """Fixed sparse label->feature projection (each label lights up a
    deterministic pseudo-random pair of feature dims)."""
    prng = np.random.default_rng(12345)
    proj = np.zeros((ncls, dim), np.float32)
    for c in range(ncls):
        proj[c, prng.integers(0, dim, 2)] = 1.0
    return proj


def _prefix_masks(n: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Overlapping prefix-fraction masks, reference ``dataset.py:23-32``."""
    train = np.zeros(n, bool)
    val = np.zeros(n, bool)
    test = np.zeros(n, bool)
    train[: int(n * 1.0)] = True
    val[: int(n * 0.3)] = True
    test[: int(n * 0.1)] = True
    return train, val, test


def synthetic_edges(
    n: int, m: int, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Locality-biased random edge list with ~m directed edges.

    Half the edges form a ring lattice (each node linked to its
    nearest neighbors in id order) — giving the community structure a
    partitioner can exploit, as real social/citation graphs have —
    and half are endpoints drawn from a power-law-ish distribution
    (hubs). Duplicate edges collapse in CSR construction.
    """
    rng = np.random.default_rng(seed)
    k = max(2, m // (2 * n))  # ring half-degree
    src_ring = np.repeat(np.arange(n, dtype=np.int64), k)
    offs = np.tile(np.arange(1, k + 1, dtype=np.int64), n)
    dst_ring = (src_ring + offs) % n
    n_rand = max(0, m - len(src_ring)) // 2
    # Log-uniform edge lengths (small-world): most extra edges are
    # short-range (stay inside a community), a heavy tail is global.
    src_sw = rng.integers(0, n, n_rand, dtype=np.int64)
    length = np.exp(rng.random(n_rand) * np.log(max(n - 1, 2))).astype(
        np.int64
    )
    sign = rng.integers(0, 2, n_rand, dtype=np.int64) * 2 - 1
    dst_sw = (src_sw + sign * np.maximum(length, 1)) % n
    src = np.concatenate([src_ring, src_sw])
    dst = np.concatenate([dst_ring, dst_sw])
    keep = src != dst
    return src[keep], dst[keep]


def load_npz(
    path: str, dim: int, num_classes: int, name: Optional[str] = None
) -> GraphDataset:
    """Load a reference-format npz graph (``src_li``/``dst_li`` arrays).

    Reproduces ``QGTC_dataset`` (``dataset.py:34-67``): undirected
    edges (both directions inserted), synthesized N(0,1) features and
    labels, prefix masks.
    """
    with np.load(path) as z:
        src = np.asarray(z["src_li"], np.int64)
        dst = np.asarray(z["dst_li"], np.int64)
    n = int(max(src.max(), dst.max())) + 1
    g = from_edges(
        np.concatenate([src, dst]), np.concatenate([dst, src]), n
    )
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((n, dim), dtype=np.float32)
    labels = np.zeros(n, np.int64)  # reference uses constant labels
    train, val, test = _prefix_masks(n)
    return GraphDataset(
        name=name or os.path.basename(path).rsplit(".", 1)[0],
        graph=g,
        features=feats,
        labels=labels,
        num_classes=num_classes,
        train_mask=train,
        val_mask=val,
        test_mask=test,
    )


def synthesize(
    name: str,
    scale: float = 1.0,
    seed: int = 0,
    graph: Optional[CSRGraph] = None,
) -> GraphDataset:
    """Synthetic stand-in for a known reference dataset.

    ``scale`` < 1 shrinks node/edge counts proportionally (useful for
    tests and quick runs); partition/batch geometry stays realistic.
    ``graph``: pre-built topology (the disk cache) — node data is
    still regenerated deterministically from ``seed``.
    """
    if name not in DATASET_STATS:
        raise KeyError(
            f"unknown dataset {name!r}; known: {sorted(DATASET_STATS)}"
        )
    n0, m0, dim, ncls = DATASET_STATS[name]
    n = max(64, int(n0 * scale))
    m = max(4 * n, int(m0 * scale))
    if graph is not None:
        if graph.num_nodes != n:
            raise ValueError(
                f"cached graph has {graph.num_nodes} nodes, want {n}"
            )
        g = graph
    else:
        src, dst = synthetic_edges(n, m, seed=seed)
        g = from_edges(
            np.concatenate([src, dst]), np.concatenate([dst, src]), n
        )
    rng = np.random.default_rng(seed + 1)
    # Community-correlated labels + noisy label-indicator features:
    # the ring-lattice edges connect id-adjacent nodes, so id-block
    # communities align with graph structure and a GNN can actually
    # learn (the reference fabricates random features and CONSTANT
    # labels, ``dataset.py:62-67`` — its accuracy is unmeasurable,
    # SURVEY quirk 6). Features are noisy enough that aggregation
    # over neighbors genuinely helps.
    n_comm = max(ncls, 4 * ncls)
    comm = (np.arange(n, dtype=np.int64) * n_comm) // max(n, 1)
    labels = comm % ncls
    feats = rng.standard_normal((n, dim)).astype(np.float32)
    sig = labels % dim
    feats[np.arange(n), sig] += 2.5
    train, val, test = _prefix_masks(n)
    multilabels = None
    if name == "ppi":
        # ppi is a MULTILABEL task (121 binary protein functions,
        # reference ``utils.py:69-96``): give each community a sparse
        # label subset (community-correlated, ~7% positives like real
        # ppi) and inject per-label feature signal so aggregation
        # genuinely helps.
        lrng = np.random.default_rng(seed + 2)
        comm_labels = (lrng.random((n_comm, ncls)) < 0.07).astype(np.int8)
        flip = lrng.random((n, ncls)) < 0.02  # per-node label noise
        multilabels = np.where(
            flip, 1 - comm_labels[comm], comm_labels[comm]
        ).astype(np.int8)
        feats += (multilabels.astype(np.float32) @ _label_proj(ncls, dim)) * 1.5
    return GraphDataset(
        name=name,
        graph=g,
        features=feats,
        labels=labels.astype(np.int64),
        num_classes=ncls,
        train_mask=train,
        val_mask=val,
        test_mask=test,
        multilabels=multilabels,
    )


def load_dataset(
    name: str,
    data_dir: str = "qgtc_graphs",
    scale: float = 1.0,
    seed: int = 0,
    cache_dir: str = "./datasets",
) -> GraphDataset:
    """npz file if present (reference format), else synthetic stand-in.

    Synthetic CSR topology is cached on disk under ``cache_dir`` for
    graphs above ~10M edges (reddit's 114M-edge stand-in costs ~15 min
    to build from the edge list; node data regenerates in seconds from
    the seed and is not cached)."""
    path = os.path.join(data_dir, f"{name}.npz")
    if os.path.exists(path):
        _, _, dim, ncls = DATASET_STATS.get(name, (0, 0, 128, 10))
        return load_npz(path, dim, ncls, name=name)
    big = (
        name in DATASET_STATS
        and DATASET_STATS[name][1] * scale > _CSR_CACHE_MIN_EDGES
    )
    cpath = os.path.join(
        cache_dir, f"_synth_{name}_s{scale:g}_seed{seed}_csr.npz"
    )
    csr = None
    if big and os.path.exists(cpath):
        with np.load(cpath) as z:
            csr = CSRGraph(
                num_nodes=int(z["n"]),
                indptr=z["indptr"],
                indices=z["indices"],
            )
    ds = synthesize(name, scale=scale, seed=seed, graph=csr)
    if big and csr is None:
        os.makedirs(cache_dir, exist_ok=True)
        tmp = cpath + ".tmp.npz"
        np.savez(
            tmp,
            n=ds.graph.num_nodes,
            indptr=ds.graph.indptr,
            indices=ds.graph.indices.astype(np.int32),
        )
        os.replace(tmp, cpath)
    return ds
