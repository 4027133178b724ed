"""NumPy host layer: datasets, partitioning and cluster batching.

``csr``, ``datasets`` and ``partition`` repeat the NumPy code of
``qgtc_ppopp22_tpu.graph``, because importing that package imports jax.
"""

from qgtc_ppopp22_tpu_torch.graph.csr import CSRGraph, from_edges
from qgtc_ppopp22_tpu_torch.graph.datasets import (
    DATASET_STATS,
    GraphDataset,
    load_dataset,
    load_npz,
    synthesize,
)
from qgtc_ppopp22_tpu_torch.graph.partition import (
    edge_cut_fraction,
    get_partition_list,
)
from qgtc_ppopp22_tpu_torch.graph.batching import (
    ClusterBatch,
    ClusterBatcher,
    batch_labels,
)
