"""Cluster batching: partition, densify, reorder, quantize, pre-pack.

Counterpart of ``qgtc_ppopp22_tpu/graph/batching.py`` (the reference's
``ClusterIter``, ``sampler.py:21-149``), NumPy paths only: every batch of
``batch_size`` partitions becomes a subgraph whose dense binary adjacency
and quantized features are packed once and parked on the host; an epoch
moves each packed batch to the device inside the timed region
(``main_qgtc.py:115``). Node counts pad up to multiples of
``bucket_rows`` so all batches fall into a few shapes; zero rows and
columns are exact no-ops through the GEMM chain.

The packed arrays are byte for byte the JAX batcher's (``a_words``,
``bit_A.planes``, ``bit_X.planes``, the zero-tile schedule), held as
torch CPU tensors. ``bit_A`` is packed from ``a_words`` on first use,
since only the bit-plane GEMM (``fmt='bits'``) reads it.
"""

from __future__ import annotations

import dataclasses
import functools
import random
from typing import List, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from qgtc_ppopp22_tpu_torch.graph.csr import CSRGraph
from qgtc_ppopp22_tpu_torch.graph.datasets import GraphDataset
from qgtc_ppopp22_tpu_torch.graph.partition import get_partition_list
from qgtc_ppopp22_tpu_torch.ops.bitpack import BitTensor, pack_bits_np, round_up
from qgtc_ppopp22_tpu_torch.ops.packmm import build_tile_map_packed_np, pack_rows_np, unpack_rows_np

DEFAULT_BUCKET_ROWS = 512


def quantize_np(x: np.ndarray, bits: int) -> np.ndarray:
    """NumPy mirror of :func:`qgtc_ppopp22_tpu_torch.ops.quantize.quantize`."""
    ub = float(1 << bits)
    x = np.asarray(x, np.float32)
    clipped = np.where(x < 0.0, 1.0, np.where(x > ub, ub - 1.0, x))
    return np.round(clipped).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class ClusterBatch:
    """One pre-packed cluster batch (host-side).

    ``num_nodes`` is the real node count, ``padded_nodes`` the bucket
    size. ``a_words`` is the adjacency in the M-packed word layout the
    packed GEMM consumes (``ops/packmm.pack_rows_np``, int32[1, pn//32, pn]);
    ``bit_X`` the features, (padded_nodes, feat_dim)
    at ``bit_width`` bits. ``tile_kidx``/``tile_kcnt`` is the zero-tile
    schedule over ``a_words``'s (256 x 256) tiles, built at pack time.
    """

    nodes: np.ndarray  # int64[num_nodes] global node ids
    bit_X: BitTensor
    num_nodes: int
    padded_nodes: int
    a_words: torch.Tensor  # int32[1, pn // 32, pn]
    tile_kidx: torch.Tensor  # int32[nm, nk]
    tile_kcnt: torch.Tensor  # int32[nm]

    @functools.cached_property
    def bit_A(self) -> BitTensor:
        """The adjacency as 1-bit planes for the bit-plane GEMM
        (``fmt='bits'``): unpacked from ``a_words`` and packed on first
        use, then kept."""
        pn = self.padded_nodes
        return pack_bits_np(unpack_rows_np(self.a_words.numpy(), 1)[:pn, :pn], 1)


class ClusterBatcher:
    """Pre-packed cluster-batch producer (reference ``ClusterIter``).

    ``psize`` partitions, ``batch_size`` partitions merged per batch,
    ``bit_width``-bit features, 1-bit adjacency (``main_qgtc.py:25-33``).
    ``seed`` drives the partition shuffle and the epoch order through
    ``random.Random``, as in the JAX batcher (whose ``shuffle=True`` and
    ``reorder='rcm'`` defaults are the only behaviour here).
    """

    def __init__(
        self,
        dataset: GraphDataset,
        psize: int,
        batch_size: int,
        bit_width: int = 2,
        seed: int = 0,
        bucket_rows: int = DEFAULT_BUCKET_ROWS,
        partition_method: str = "auto",
        cache_dir: Optional[str] = None,
    ):
        self.dataset = dataset
        self.psize = psize
        self.batch_size = batch_size
        self.bit_width = bit_width
        self.bucket_rows = bucket_rows
        self._rng = random.Random(seed)
        self.features = dataset.features
        self.feat_dim = int(self.features.shape[1])

        g = dataset.graph
        self.par_li: List[np.ndarray] = get_partition_list(
            g, psize, method=partition_method, cache_dir=cache_dir,
            cache_name=dataset.name,
        )
        self._rng.shuffle(self.par_li)
        self.max = psize // batch_size
        self.batches: List[ClusterBatch] = [
            self._build_batch(g, i) for i in range(self.max)
        ]

    def tile_counts(self) -> Tuple[int, int]:
        """``(processed, total)`` over every batch's zero-tile map: the
        K tiles the maps list, and all K tiles of the 256 x 256 grids (the
        reference's ``print_counter`` tile counters)."""
        processed = sum(int(b.tile_kcnt.sum()) for b in self.batches)
        return processed, sum(b.tile_kidx.numel() for b in self.batches)

    def _build_batch(self, g: CSRGraph, i: int) -> ClusterBatch:
        parts = self.par_li[i * self.batch_size : (i + 1) * self.batch_size]
        nonempty = [p for p in parts if len(p)]
        nodes = np.sort(np.concatenate(nonempty)) if nonempty else np.empty(0, np.int64)
        n = len(nodes)
        pn = round_up(max(n, 1), self.bucket_rows)
        dense_a = np.zeros((pn, pn), np.uint8)
        dense_a[:n, :n] = g.subgraph_dense(nodes)

        if n > 2:
            # Reverse-Cuthill-McKee relabelling of the batch: a host-side
            # row/col permutation that bands the adjacency; outputs,
            # labels and masks all key off ``nodes``.
            from scipy.sparse.csgraph import reverse_cuthill_mckee

            sub = sp.csr_matrix(dense_a[:n, :n])
            perm = np.asarray(reverse_cuthill_mckee(sub, symmetric_mode=False), np.int64)
            nodes = nodes[perm]
            dense_a[:n, :n] = dense_a[:n, :n][np.ix_(perm, perm)]

        a_words = pack_rows_np(dense_a, 1)
        kidx, kcnt = build_tile_map_packed_np(a_words, 1)
        x = np.zeros((pn, self.feat_dim), np.float32)
        x[:n] = self.features[nodes]
        return ClusterBatch(
            nodes=nodes,
            bit_X=pack_bits_np(quantize_np(x, self.bit_width), self.bit_width),
            num_nodes=n,
            padded_nodes=pn,
            a_words=torch.from_numpy(a_words),
            tile_kidx=torch.from_numpy(kidx),
            tile_kcnt=torch.from_numpy(kcnt),
        )

    def buckets(self) -> List[int]:
        """Distinct padded node counts."""
        return sorted({b.padded_nodes for b in self.batches})

    def __len__(self) -> int:
        return self.max

    def __iter__(self):
        order = list(range(self.max))
        self._rng.shuffle(order)
        for i in order:
            yield self.batches[i]


def batch_labels(dataset: GraphDataset, batch: ClusterBatch) -> Tuple[np.ndarray, np.ndarray]:
    """(labels, valid_mask) aligned to the batch's padded rows."""
    lab = np.zeros(batch.padded_nodes, np.int64)
    lab[: batch.num_nodes] = dataset.labels[batch.nodes]
    mask = np.zeros(batch.padded_nodes, bool)
    mask[: batch.num_nodes] = True
    return lab, mask
