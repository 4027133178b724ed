"""Host-side graph container (CSR) and induced-subgraph extraction.

The reference delegates graph storage to DGL (``dataset.py:48-59``
builds a ``DGLGraph`` from npz edge lists; ``partition_utils.py:20-24``
extracts batch subgraphs with ``g.subgraph``). DGL is not part of this
framework; the equivalent here is a minimal NumPy/SciPy CSR container
feeding the quantize/pack pipeline. The hot host-side step — densify a
batch subgraph's adjacency (reference ``sampler.py:80-89`` via
``scipy.coo_matrix(...).toarray()``) — is a vectorized CSR slice here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """Unweighted directed graph in CSR form (edges ``u -> v``).

    GNN aggregation uses the *in-adjacency* convention of the
    reference's dense A (``A[i, j] = 1`` iff edge ``j -> i`` reaches
    node ``i``): build with :func:`from_edges` which stores the
    transpose so that row ``i`` lists ``i``'s in-neighbors.
    """

    indptr: np.ndarray  # int64[N+1]
    indices: np.ndarray  # int64[nnz]
    num_nodes: int

    @property
    def num_edges(self) -> int:
        return int(self.indices.shape[0])

    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)

    def to_scipy(self) -> sp.csr_matrix:
        data = np.ones(self.num_edges, np.uint8)
        return sp.csr_matrix(
            (data, self.indices, self.indptr),
            shape=(self.num_nodes, self.num_nodes),
        )

    def undirected_scipy(self) -> sp.csr_matrix:
        """Symmetrized adjacency (for partitioning)."""
        a = self.to_scipy()
        sym = a.maximum(a.T)
        sym.sum_duplicates()
        return sym.tocsr()

    def subgraph_dense(self, nodes: np.ndarray) -> np.ndarray:
        """Induced-subgraph dense binary adjacency (uint8 0/1).

        Equivalent of the reference's per-batch densification
        (``sampler.py:80-89``): rows/cols follow the order of
        ``nodes``.
        """
        sub = self.to_scipy()[nodes][:, nodes]
        dense = np.asarray(sub.todense(), dtype=np.uint8)
        np.minimum(dense, 1, out=dense)
        return dense

    def subgraph_csr(self, nodes: np.ndarray) -> "CSRGraph":
        sub = self.to_scipy()[nodes][:, nodes].tocsr()
        return CSRGraph(
            indptr=sub.indptr.astype(np.int64),
            indices=sub.indices.astype(np.int64),
            num_nodes=len(nodes),
        )


def from_edges(
    src: np.ndarray,
    dst: np.ndarray,
    num_nodes: int,
    add_self_loops: bool = False,
) -> CSRGraph:
    """Build the in-adjacency CSR from an edge list ``src -> dst``.

    Row ``i`` of the result lists the sources of edges into ``i`` —
    matching the reference's dense ``A`` where aggregation is
    ``A @ X`` (``main_qgtc.py:131``, ``sampler.py:86-89`` builds
    ``coo_matrix((vals, (dst? src?)))``; the reference treats graphs as
    symmetric in practice since its npz edge lists are undirected).
    Duplicate edges collapse to 1.
    """
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    if add_self_loops:
        loop = np.arange(num_nodes, dtype=np.int64)
        src = np.concatenate([src, loop])
        dst = np.concatenate([dst, loop])
    data = np.ones(len(src), np.uint8)
    # in-adjacency: row = dst, col = src
    a = sp.csr_matrix(
        (data, (dst, src)), shape=(num_nodes, num_nodes), dtype=np.uint8
    )
    a.sum_duplicates()
    a.data[:] = 1
    return CSRGraph(
        indptr=a.indptr.astype(np.int64),
        indices=a.indices.astype(np.int64),
        num_nodes=num_nodes,
    )
