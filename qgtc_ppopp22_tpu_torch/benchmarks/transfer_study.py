"""Host-to-device bytes and time of one epoch, packed against dense.

    python -m qgtc_ppopp22_tpu_torch.benchmarks.transfer_study [--dataset ogbn-arxiv] [--bit-width 2] \\
        [--epochs 5] [--device cuda|cpu] [--csv F]

The counterpart of the JAX repository's ``benchmarks/transfer_study.py``:
the packed format's claim (bit-packed operands are 8-32x smaller on the
host-to-device link) as data, at the reference's per-step transfer
boundary (``main_qgtc.py:115``, ``cluster.cuda()``). For each form, bytes
per epoch and host-to-device wall ms per epoch:

* ``packed``: each batch's M-packed adjacency words (``a_words``) and its
  ``bit_width``-bit feature planes, what the quantized engine ships
  (``runtime.QGTCEngine.put_batch``);
* ``dense``: each batch's uint8 adjacency [pn, pn] and float32 features
  [pn, feat], what the bf16 baseline ships (``BaselineEngine._dense``).

Every array is copied from pageable host memory with ``Tensor.to``, as
``put_batch`` copies it, each epoch's copies followed by one synchronize;
the link here is PCIe. ``hbm_staged_mb`` is the epoch's device footprint
when every batch is staged (the resident, fused and mega modes). Every row
carries ``card``. No CSV is written unless asked
(``results/transfer_study.csv`` holds the JAX package's TPU rows). Runs on
the card (``--device cuda``, the default) unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

import numpy as np
import torch

from qgtc_ppopp22_tpu_torch.bench import study_device
from qgtc_ppopp22_tpu_torch.graph import ClusterBatcher, load_dataset
from qgtc_ppopp22_tpu_torch.utils.metrics import write_csv


def forms(ds, batcher: ClusterBatcher) -> dict:
    """``{"packed": [[a_words, planes], ...], "dense": [[A, X], ...]}``,
    one list of CPU tensors per batch: the packed storage format and the
    dense form built as the JAX study builds it."""
    packed, dense = [], []
    for b in batcher.batches:
        packed.append([b.a_words, b.bit_X.planes])
        n, pn = b.num_nodes, b.padded_nodes
        da = np.zeros((pn, pn), np.uint8)
        da[:n, :n] = ds.graph.subgraph_dense(b.nodes)
        dx = np.zeros((pn, batcher.feat_dim), np.float32)
        dx[:n] = batcher.features[b.nodes]
        dense.append([torch.from_numpy(da), torch.from_numpy(dx)])
    return {"packed": packed, "dense": dense}


def epoch_bytes(arrays: list) -> int:
    return sum(t.numel() * t.element_size() for ts in arrays for t in ts)


def h2d_ms(arrays: list, device: torch.device, epochs: int) -> float:
    """Wall ms per epoch to copy every array to ``device`` (one epoch
    untimed first), one synchronize an epoch."""

    def one_epoch():
        for ts in arrays:
            for t in ts:
                t.to(device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    one_epoch()
    t0 = time.perf_counter()
    for _ in range(epochs):
        one_epoch()
    return (time.perf_counter() - t0) * 1e3 / max(epochs, 1)


def study_rows(ds, batcher: ClusterBatcher, device, card: str, epochs: int = 5) -> list:
    """The packed and the dense row of one batcher."""
    fm = forms(ds, batcher)
    nbytes = {k: epoch_bytes(v) for k, v in fm.items()}
    ms = {k: h2d_ms(v, device, epochs) for k, v in fm.items()}
    out = [dict(form=k, bytes_per_epoch=nbytes[k], h2d_ms_per_epoch=round(ms[k], 3),
                hbm_staged_mb=round(nbytes[k] / 2 ** 20, 1),
                bytes_ratio_vs_dense=round(nbytes["dense"] / nbytes[k], 2),
                h2d_speedup_vs_dense=round(ms["dense"] / max(ms[k], 1e-9), 2), card=card)
           for k in ("packed", "dense")]
    for r in out:
        print(r, flush=True)
    return out


def rows(dataset: str = "ogbn-arxiv", bit_width: int = 2, psize: int = 1500, batch_size: int = 20,
         epochs: int = 5, device="cuda", csv: Optional[str] = None) -> list:
    dev, card = study_device(device)
    ds = load_dataset(dataset)
    it = ClusterBatcher(ds, psize=psize, batch_size=batch_size, bit_width=bit_width, seed=3, cache_dir="./datasets")
    out = study_rows(ds, it, dev, card, epochs)
    if csv:
        write_csv(csv, out, list(out[0]))
        print(f"wrote {csv}")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dataset", default="ogbn-arxiv")
    p.add_argument("--bit-width", type=int, default=2)
    p.add_argument("--psize", type=int, default=1500)
    p.add_argument("--batch-size", type=int, default=20)
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--device", default="cuda")
    p.add_argument("--csv", default=None)
    args = p.parse_args(argv)
    rows(args.dataset, args.bit_width, args.psize, args.batch_size, args.epochs, args.device, args.csv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
