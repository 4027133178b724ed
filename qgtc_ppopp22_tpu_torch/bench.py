"""Headline benchmark of the port: 2-bit Cluster-GCN epoch time on ogbn-arxiv.

    python -m qgtc_ppopp22_tpu_torch.bench

The PyTorch counterpart of the repository's ``bench.py``, on one CUDA
device, at the same configuration (``bench.py:53-69``: the ogbn-arxiv
stand-in, psize 1500, batch 20, 2-bit, 3-layer GCN, hidden 16, seed 3)
and with the same environment variables: ``QGTC_BENCH_MODE`` (``mega``,
the default; ``fused``; ``step``, the resident step engine),
``QGTC_BENCH_ZEROTILE`` (unset: the engine's auto gate; ``0`` / ``1``
force zero-tile jumping off / on) and ``QGTC_BENCH_EPOCHS`` (20). The
reference's epoch on an sm_86 GPU took ``BASELINE_MS`` (``bench.py:39``).
The batches come from the native multilevel partition, which the JAX
package's ``'auto'`` takes where its host library builds; the record
names it (``detail.partition_method``).

Prints one JSON line: ``metric``, ``value`` (the median ms/epoch over
``repeats`` timed runs in this process), ``unit``, ``vs_baseline`` (the
reference's epoch over ``value``) and ``detail``. Each timed run launches
all its epochs and synchronizes once (``main_qgtc.py:112-159``), so a run
of the step engine, whose epoch is the host's dispatch, spreads as the
host does. A mode that fails raises: the script exits non-zero and prints
no number.
"""

from __future__ import annotations

import functools
import json
import os
import statistics
import subprocess
import sys

import torch

from qgtc_ppopp22_tpu_torch.graph import ClusterBatcher, load_dataset
from qgtc_ppopp22_tpu_torch.runtime import QGTCEngine

BASELINE_MS = 208.616  # the reference's epoch, ogbn-arxiv (README.md:84-89)
METRIC = "ogbn-arxiv_cluster_gcn_2bit_epoch_ms"
MODES = ("mega", "fused", "step")


def card_line(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them
    (``name, power.limit``), or ``cpu``."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def study_device(device) -> tuple:
    """``(torch.device, card)`` for a study run on ``device``: the card's
    line (:func:`card_line`) rides on every row. A CUDA device without CUDA
    raises: a study never moves its work to the CPU unasked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available; pass --device cpu to run on the CPU")
    return dev, card_line(dev)


def bench(batcher: ClusterBatcher, device, mode: str = "mega", zerotile_jump=None,
          n_epochs: int = 20, repeats: int = 5) -> dict:
    """Time ``mode`` over ``batcher``'s batches on ``device``, print the
    record as one JSON line and return it. ``repeats`` timed runs of
    ``n_epochs`` epochs each, every run staged anew; then the step engine
    with each batch's host -> device copy inside the epoch, one
    synchronize an epoch (``bench.py:94-96``)."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {MODES}")
    device = torch.device(device)
    eng = QGTCEngine(feat_dim=batcher.feat_dim, num_classes=batcher.dataset.num_classes, model="gcn",
                     bit_width=2, zerotile_jump=zerotile_jump, seed=3, device=device)
    run = {"mega": eng.run_epochs_mega, "fused": eng.run_epochs_fused,
           "step": functools.partial(eng.run_epochs, resident=True)}[mode]
    runs = [run(batcher, n_epochs=n_epochs) for _ in range(repeats)]
    epoch_ms = [st.avg_ms for st in runs]
    value = statistics.median(epoch_ms)
    transfer = eng.run_epochs(batcher, n_epochs=3, resident=False, sync_every_epoch=True).avg_ms
    detail = {
        "baseline_ms": BASELINE_MS,
        "epoch_ms": epoch_ms,
        "median_ms": value,
        "spread_ms": max(epoch_ms) - min(epoch_ms),
        "launch_sync_ms": [st.launch_sync_ms for st in runs],
        "batches_per_epoch": runs[0].n_batches,
        "n_epochs": n_epochs,
        "zerotile_jump": zerotile_jump,
        "mode": mode,
        "partition_method": batcher.partition_method,
        "timing": "batches staged on the device before the timed region; each run launches all "
                  "its epochs, synchronizes once and divides by the epoch count "
                  "(main_qgtc.py:112-159); value is the median over the runs",
        "transfer_inclusive_ms": transfer,
        "transfer_inclusive_vs_baseline": BASELINE_MS / transfer,
        "transfer_note": "the step engine with each batch's packed tensors copied host -> device "
                         "inside the epoch (the reference's cluster.cuda() boundary, "
                         "main_qgtc.py:115), over this machine's PCIe link from pageable host "
                         "memory, one synchronize an epoch",
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "card": card_line(device),
    }
    if mode == "mega":
        detail["buckets"] = eng.mega_buckets
    record = {"metric": METRIC, "value": value, "unit": "ms", "vs_baseline": BASELINE_MS / value,
              "detail": detail}
    print(json.dumps(record))
    return record


def main() -> int:
    n_epochs = int(os.environ.get("QGTC_BENCH_EPOCHS", "20"))
    zt = os.environ.get("QGTC_BENCH_ZEROTILE", "")
    zerotile = None if zt == "" else zt != "0"
    mode = os.environ.get("QGTC_BENCH_MODE", "mega")
    ds = load_dataset("ogbn-arxiv", data_dir="qgtc_graphs")
    # the JAX package's default partition, named: a host without g++ fails
    # here rather than measuring other batches
    batcher = ClusterBatcher(ds, psize=1500, batch_size=20, bit_width=2, seed=3, cache_dir="./datasets",
                             partition_method="native")
    bench(batcher, "cuda", mode, zerotile, n_epochs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
