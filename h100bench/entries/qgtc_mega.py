"""The system under test: the port's mega path over a traffic file's batches.

``ClusterBatcher`` partitions, densifies, reorders, quantizes and packs the
benchmark's graph and features; ``QGTCEngine`` (``fmt='digits'``, the automatic
zero-tile gate) stages every shape bucket once (``_stage_mega``: one K1 launch
a bucket, or a captured fused epoch for a bucket K1 refuses), and an epoch
calls each bucket's launch once: the callables ``run_epochs_mega`` times.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from qgtc_ppopp22_tpu_torch.graph import ClusterBatcher, CSRGraph, GraphDataset
from qgtc_ppopp22_tpu_torch.runtime import QGTCEngine


class Entry:
    """Set-up runs in the constructor and records its spans in ``spans``
    (``batch_build_s``, ``stage_s``). ``bits`` overrides the configuration's
    bit width and ``batcher`` replaces the batching: the control runs the
    program's own narrower path on the same batches."""

    def __init__(self, cfg: dict, traffic: dict, indptr: np.ndarray, indices: np.ndarray,
                 features: np.ndarray, labels: np.ndarray, float_weights: Sequence[torch.Tensor],
                 device: torch.device, cache: Path, bits: int = 0, batcher: Optional[ClusterBatcher] = None):
        bits = bits or int(cfg["bit_width"])
        self.spans: Dict[str, float] = {}
        t = time.perf_counter()
        if batcher is None:
            n = len(indptr) - 1
            ones = np.ones(n, bool)  # the masks: inference reads none
            ds = GraphDataset(name=f"{traffic['dataset']}-g{traffic['graph_seed']}",
                              graph=CSRGraph(indptr=indptr, indices=indices, num_nodes=n), features=features,
                              labels=labels, num_classes=int(traffic["classes"]), train_mask=ones, val_mask=ones,
                              test_mask=ones)
            batcher = ClusterBatcher(ds, psize=int(traffic["psize"]), batch_size=int(traffic["batch_size"]),
                                     bit_width=bits, seed=int(traffic["shuffle_seed"]),
                                     partition_method=traffic["partition"], cache_dir=str(cache / "partitions"))
        self.batcher = batcher
        self.spans["batch_build_s"] = time.perf_counter() - t
        self.device = device
        t = time.perf_counter()
        self.engine = QGTCEngine(feat_dim=self.batcher.feat_dim, num_classes=int(traffic["classes"]),
                                 model=cfg["model"], bit_width=bits, hidden=int(cfg["hidden"]),
                                 num_layers=int(cfg["num_layers"]), fmt="digits", device=device)
        self.engine.set_float_weights([w.cpu() for w in float_weights])
        self.staged = self.engine._stage_mega(self.batcher)
        self.buckets = [dict(info, index=list(idx)) for info, (idx, _) in zip(self.engine.mega_buckets, self.staged)]
        self.launches = [(f"bucket pn={b['pn']} x {b['batches']}", fn)
                         for b, (_, fn) in zip(self.buckets, self.staged)]
        self.epoch()
        self.sync()
        self.spans["stage_s"] = time.perf_counter() - t
        self.classes = int(traffic["classes"])
        self.batches: List[np.ndarray] = [b.nodes for b in self.batcher.batches]

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def epoch(self) -> list:
        """One epoch: every bucket's launch once; its outputs, bucket by bucket."""
        return [fn() for _, fn in self.launches]

    def per_batch(self, outs: list) -> Iterator[Tuple[int, torch.Tensor]]:
        """``(batch index, logits [num_nodes, classes])`` of every batch of an
        epoch's outputs, in the rows of ``self.batches[i]``."""
        for b, out in zip(self.buckets, outs):
            for j, i in enumerate(b["index"]):
                yield i, out[j][: len(self.batches[i]), : self.classes]

    def close(self) -> None:
        """Drop the program's device state (the staged buckets, the engine)."""
        del self.staged, self.launches, self.engine
