"""Cluster batching: partition, densify, reorder, quantize, pre-pack.

Counterpart of ``qgtc_ppopp22_tpu/graph/batching.py`` (the reference's
``ClusterIter``, ``sampler.py:21-149``): every batch of ``batch_size``
partitions becomes a subgraph whose dense binary adjacency and quantized
features are packed once and parked on the host; an epoch moves each
packed batch to the device inside the timed region (``main_qgtc.py:115``).
Node counts pad up to multiples of ``bucket_rows`` so all batches fall
into a few shapes; zero rows and columns are exact no-ops through the
GEMM chain.

The densify, quantize and pack steps run in the native host library
(:mod:`qgtc_ppopp22_tpu_torch.native`) when it builds, as in the JAX
batcher, else in NumPy; both give the same bytes. The packed arrays are
byte for byte the JAX batcher's (``a_words``, ``bit_A.planes``,
``bit_X.planes``, the zero-tile schedule), held as torch CPU tensors.
``bit_A`` is packed from ``a_words`` on first use, since only the
bit-plane GEMM (``fmt='bits'``) reads it.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import random
from typing import List, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from qgtc_ppopp22_tpu_torch.graph.csr import CSRGraph
from qgtc_ppopp22_tpu_torch.graph.datasets import GraphDataset
from qgtc_ppopp22_tpu_torch.graph.partition import get_partition_list, resolve_method
from qgtc_ppopp22_tpu_torch.models.golden import quantize_np
from qgtc_ppopp22_tpu_torch.ops.bitpack import COL_PAD, ROW_PAD, BitTensor, pack_bits_np, round_up
from qgtc_ppopp22_tpu_torch.ops.packmm import build_tile_map_packed_np, pack_rows_np, unpack_rows_np

DEFAULT_BUCKET_ROWS = 512


def _native_or_none():
    """The native host library, or None (the NumPy paths)."""
    from qgtc_ppopp22_tpu_torch import native

    return native if native.available() else None


def _pack(q: np.ndarray, bits: int, native) -> BitTensor:
    """Levels (M, K) -> :class:`BitTensor` on the CPU, through the native
    packer or ``pack_bits_np`` (the same bytes)."""
    if native is None:
        return pack_bits_np(q, bits)
    M, K = q.shape
    planes = native.pack_bits_u32_2d(q, bits, round_up(max(M, 1), ROW_PAD), round_up(max(K, 1), COL_PAD))
    return BitTensor(planes=torch.from_numpy(planes.view(np.int32)), shape=(M, K), bits=bits)


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
        return _pack(unpack_rows_np(self.a_words.numpy(), 1)[:pn, :pn], 1, _native_or_none())

    def nbytes(self) -> int:
        """Bytes of the packed adjacency planes and feature planes (JAX
        ``ClusterBatch.nbytes``); ``a_words`` holds as many as ``bit_A``."""
        pn = self.padded_nodes
        return round_up(pn, ROW_PAD) // 8 * round_up(pn, COL_PAD) + self.bit_X.nbytes()


class ClusterBatcher:
    """Pre-packed cluster-batch producer (reference ``ClusterIter``).

    ``psize`` partitions, ``batch_size`` partitions merged per batch,
    ``bit_width``-bit features, 1-bit adjacency (``main_qgtc.py:25-33``).
    ``seed`` drives the partition shuffle and the epoch order through
    ``random.Random``, as in the JAX batcher. The options are the JAX
    batcher's:

    * ``precalc``: the GraphSAGE-style feature pre-aggregation
      (``sampler.py:108-126``): features become ``[X, (A @ X) / in_degree]``,
      doubling ``feat_dim``;
    * ``feature_scale``: features scaled before the quantizer, so wide bit
      widths use their level range;
    * ``quant_bits`` (default ``bit_width``, at most it): the features'
      quantization grid; a narrower grid wraps level ``2^qb`` to 0, as a
      ``qb``-plane pack would, so the wider datapath runs a narrower
      model's exact inputs;
    * ``shuffle``: shuffle the partition list before batching;
    * ``reorder``: ``'rcm'`` relabels each batch by Reverse-Cuthill-McKee,
      ``'none'`` keeps ascending node ids.

    ``partition_method`` is resolved once (``'auto'``: ``'native'`` when
    the native library builds, else ``'bfs'``) and kept as the batcher's
    ``partition_method``. ``native=False`` keeps densify, quantize and
    pack in NumPy where the library builds (the same bytes; the port's
    own switch, for checking and timing the two paths).
    """

    def __init__(
        self,
        dataset: GraphDataset,
        psize: int,
        batch_size: int,
        bit_width: int = 2,
        seed: int = 0,
        bucket_rows: int = DEFAULT_BUCKET_ROWS,
        precalc: bool = False,
        partition_method: str = "auto",
        cache_dir: Optional[str] = None,
        shuffle: bool = True,
        feature_scale: float = 1.0,
        reorder: str = "rcm",
        quant_bits: Optional[int] = None,
        native: bool = True,
    ):
        if reorder not in ("none", "rcm"):
            raise ValueError(f"reorder must be 'none' or 'rcm': {reorder}")
        if quant_bits is not None and quant_bits > bit_width:
            raise ValueError(
                f"quant_bits ({quant_bits}) must be <= bit_width ({bit_width}): values wider "
                "than the datapath decomposition cannot be represented"
            )
        self.dataset = dataset
        self.psize = psize
        self.batch_size = batch_size
        self.bit_width = bit_width
        self.quant_bits = quant_bits or bit_width
        self.bucket_rows = bucket_rows
        self.feature_scale = feature_scale
        self.reorder = reorder
        self._rng = random.Random(seed)

        g = dataset.graph
        feats = dataset.features
        if feature_scale != 1.0:
            feats = feats * np.float32(feature_scale)
        if precalc:
            deg = g.degrees().astype(np.float32)
            norm = np.where(deg > 0, 1.0 / np.maximum(deg, 1), 0.0)
            agg = (g.to_scipy().astype(np.float32) @ feats) * norm[:, None]
            feats = np.concatenate([feats, agg], axis=1)
        self.features = feats
        self.feat_dim = int(feats.shape[1])

        self._native = _native_or_none() if native else None
        if self._native is not None:
            # the contiguous int64 CSR the native densify takes, made once
            self._indptr64 = np.ascontiguousarray(g.indptr, np.int64)
            self._indices64 = np.ascontiguousarray(g.indices, np.int64)
        self.partition_method = resolve_method(partition_method)
        self.par_li: List[np.ndarray] = get_partition_list(
            g, psize, method=self.partition_method, cache_dir=cache_dir,
            cache_name=dataset.name,
        )
        if shuffle:
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
        # densify over the ascending node list (the native extractor
        # binary-searches it), then reorder as a row/col permutation
        if self._native is not None:
            dense_a = self._native.subgraph_dense_native(self._indptr64, self._indices64, nodes, pn)
        else:
            dense_a = np.zeros((pn, pn), np.uint8)
            dense_a[:n, :n] = g.subgraph_dense(nodes)

        if self.reorder == "rcm" and n > 2:
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
        return ClusterBatch(
            nodes=nodes,
            bit_X=self._pack_x(nodes, n, pn, self.bit_width, self.quant_bits),
            num_nodes=n,
            padded_nodes=pn,
            a_words=torch.from_numpy(a_words),
            tile_kidx=torch.from_numpy(kidx),
            tile_kcnt=torch.from_numpy(kcnt),
        )

    def _pack_x(self, nodes: np.ndarray, n: int, pn: int, bit_width: int, quant_bits: int) -> BitTensor:
        """The batch's features quantized on the ``quant_bits`` grid and
        packed at ``bit_width``: the only per-batch work that depends on
        the bit width (reference ``val2bit(X, bit_width)``)."""
        x = np.zeros((pn, self.feat_dim), np.float32)
        x[:n] = self.features[nodes]
        native = self._native
        qx = native.quantize_native(x, quant_bits) if native is not None else quantize_np(x, quant_bits)
        if quant_bits < bit_width:
            qx = qx % (1 << quant_bits)  # the narrow-grid wrap: 2^qb -> 0
        return _pack(qx, bit_width, native)

    def rebit(self, bit_width: int, quant_bits: Optional[int] = None) -> "ClusterBatcher":
        """This batcher at another feature bit width (and grid), sharing
        every bit-independent artifact (partition, densify, reordering,
        ``a_words``, the zero-tile maps): only each batch's features are
        quantized and packed again (JAX ``ClusterBatcher.rebit``)."""
        qb = quant_bits or bit_width
        if qb > bit_width:
            raise ValueError(f"quant_bits ({qb}) must be <= bit_width ({bit_width})")
        nb = copy.copy(self)
        nb.bit_width, nb.quant_bits = bit_width, qb
        nb.batches = [
            dataclasses.replace(b, bit_X=self._pack_x(b.nodes, b.num_nodes, b.padded_nodes, bit_width, qb))
            for b in self.batches
        ]
        return nb

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
