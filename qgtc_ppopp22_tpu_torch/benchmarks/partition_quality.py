"""Partition quality: the native multilevel partitioner against BFS and RCM.

    python -m qgtc_ppopp22_tpu_torch.benchmarks.partition_quality [--datasets Proteins ...] \\
        [--methods native bfs rcm] [--device cuda|cpu] [--csv F]

The counterpart of the JAX repository's ``benchmarks/partition_quality.py``.
Cluster quality drives the zero-tile skip, the dense tiles' useful work and
the accuracy signal. Per dataset x method (``graph/partition.
get_partition_list``, without the partition cache):

* ``edge_cut``: the share of edges that cross clusters
  (``edge_cut_fraction``, the reference's METIS quality axis,
  ``partition_utils.py:11-18``);
* ``batch_density``: the nonzero share of the batches' dense adjacencies
  (``ClusterBatcher(partition_method=...)``, RCM-reordered as the kernels
  see them), over their real nodes;
* ``skip_ratio``: the share of (512-row chunk x ``mega_colblock``) blocks
  that are all zero (``runtime.mega_block_occ``), what K1's compacted
  schedule can skip;
* ``partition_s``: host wall seconds to partition (writing the partition
  to a temporary cache, which the batcher then reads, is inside it: a few
  milliseconds).

A host-only study. It takes ``--device`` all the same, so a run on the
card's machine stamps its rows with the card (``card``) and its seconds sit
beside that machine's epochs. No CSV is written unless asked
(``results/partition_quality.csv`` holds the JAX package's rows).
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time
from typing import Optional, Sequence

import numpy as np

from qgtc_ppopp22_tpu_torch.bench import study_device
from qgtc_ppopp22_tpu_torch.graph import ClusterBatcher, edge_cut_fraction, get_partition_list, load_dataset
from qgtc_ppopp22_tpu_torch.graph.datasets import DEFAULT_PSIZE
from qgtc_ppopp22_tpu_torch.ops.fused_model import mega_colblock
from qgtc_ppopp22_tpu_torch.runtime import mega_block_occ
from qgtc_ppopp22_tpu_torch.utils.metrics import write_csv

DATASETS = ("Proteins", "artist", "soc-BlogCatalog", "ppi", "ogbn-arxiv", "reddit", "ogbn-products")
METHODS = ("native", "bfs", "rcm")


def batch_quality(batcher: ClusterBatcher) -> dict:
    """``batch_density`` and ``skip_ratio`` of a batcher's batches."""
    nnz = tot = skip = blocks = 0
    for b in batcher.batches:
        w = b.a_words.numpy()
        nnz += int(np.unpackbits(w.view(np.uint8)).sum())
        tot += b.num_nodes * b.num_nodes
        occ = mega_block_occ(w, 512, mega_colblock(b.padded_nodes))
        skip += int((occ == 0).sum())
        blocks += occ.size
    return dict(batch_density=round(nnz / max(tot, 1), 5), skip_ratio=round(skip / max(blocks, 1), 4))


def method_row(ds, method: str, psize: int, batch_size: int, card: str) -> dict:
    with tempfile.TemporaryDirectory(dir=".") as tmp:
        t0 = time.perf_counter()
        parts = get_partition_list(ds.graph, psize, method=method, cache_dir=tmp, cache_name=ds.name)
        part_s = time.perf_counter() - t0
        cut = edge_cut_fraction(ds.graph, parts)
        it = ClusterBatcher(ds, psize=psize, batch_size=batch_size, bit_width=1, partition_method=method,
                            cache_dir=tmp)
    return dict(dataset=ds.name, method=method, psize=psize, edge_cut=round(cut, 4), **batch_quality(it),
                partition_s=round(part_s, 3), card=card)


def rows(datasets: Sequence[str] = DATASETS, methods: Sequence[str] = METHODS, batch_size: int = 20,
         device="cuda", csv: Optional[str] = None) -> list:
    _, card = study_device(device)
    out = []
    for name in datasets:
        ds = load_dataset(name)
        for method in methods:
            out.append(method_row(ds, method, DEFAULT_PSIZE.get(name, 1500), batch_size, card))
            print(out[-1], flush=True)
            if csv:
                write_csv(csv, out, list(out[0]))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--datasets", nargs="+", default=list(DATASETS))
    p.add_argument("--methods", nargs="+", default=list(METHODS))
    p.add_argument("--batch-size", type=int, default=20)
    p.add_argument("--device", default="cuda")
    p.add_argument("--csv", default=None)
    args = p.parse_args(argv)
    rows(args.datasets, args.methods, args.batch_size, args.device, args.csv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
