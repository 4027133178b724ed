"""The epoch matrix: datasets x widths x models x engines.

    python -m qgtc_ppopp22_tpu_torch.benchmarks.run_all --datasets Proteins artist ppi \\
        [--gin] [--baseline] [--bits 1 2 4 8] [--mode mega|fused|step] [--device cuda|cpu] [--csv F]

The counterpart of the JAX repository's ``benchmarks/run_all.py``, with its
flags. For each dataset the batcher is built once (the partition, densify,
reordering and the 1-bit adjacency are bit-width independent) and each
further width is its ``rebit``. The quantized rows go through the port's
engines: ``--mode mega`` ``QGTCEngine.run_epochs_mega`` (one K1 launch a
bucket; a bucket K1 refuses runs the captured fused epoch of K2 and K3),
``fused`` ``run_epochs_fused`` (one CUDA-graph replay of K2 and K3 an
epoch), ``step`` ``run_epochs(resident=True)``. ``--baseline`` adds the
bf16 baseline (sage, or gin with ``--gin``) in the same mode; its mega mode
is one K5 launch a bucket. Every row is host ms/epoch: all epochs launched,
one synchronize, divided (``main_qgtc.py:112-159``).

Columns: JAX's (``dataset, model, engine, bits, mode, epoch_ms,
launch_sync_ms``), then ``fallback_buckets`` (the mega buckets K1 or K5
refused, which the fused loop ran: ``mega_buckets``; 0 in the other modes),
``card`` (``nvidia-smi``'s name and power limit, or ``cpu``) and
``not_run``: empty, or why the cell did not run (its times are then
empty). Rows print and, with ``--csv``, are written one at a time, so a
long sweep keeps its finished rows. No CSV is written unless asked:
``results/epochs_matrix.csv`` holds the JAX package's TPU rows. Runs on
the card (``--device cuda``, the default) unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys
import traceback
from typing import Optional, Sequence

from qgtc_ppopp22_tpu_torch.bench import study_device
from qgtc_ppopp22_tpu_torch.graph import ClusterBatcher, load_dataset
from qgtc_ppopp22_tpu_torch.graph.datasets import DEFAULT_PSIZE
from qgtc_ppopp22_tpu_torch.runtime import BaselineEngine, QGTCEngine
from qgtc_ppopp22_tpu_torch.utils.metrics import write_csv

DATASETS = ("Proteins", "artist", "soc-BlogCatalog", "ppi", "ogbn-arxiv")  # JAX's default
MODES = ("mega", "fused", "step")


def _cell(run, info_of, row: dict) -> dict:
    """``row`` with the times of ``run()`` (an ``EpochStats``) and the count
    of buckets ``info_of()`` says fell back; a cell that raises is kept,
    marked not run with its reason."""
    try:
        st = run()
        row.update(epoch_ms=round(st.avg_ms, 3), launch_sync_ms=round(st.launch_sync_ms, 3),
                   fallback_buckets=sum(bool(b["fallback"]) for b in info_of()), not_run="")
    except Exception as e:  # the sweep goes on; the row stays in the matrix, with the reason
        traceback.print_exc()
        row.update(epoch_ms=None, launch_sync_ms=None, fallback_buckets=None, not_run=f"{type(e).__name__}: {e}")
    return row


def dataset_rows(ds, base_it: ClusterBatcher, bits: Sequence[int], device, card: str, model: str = "gcn",
                 baseline: bool = False, mode: str = "mega", n_epochs: int = 10, zerotile_jump=None,
                 emit=None) -> list:
    """The rows of one dataset: ``base_it`` (a batcher at ``bits[0]``) and its
    ``rebit`` for each other width through ``mode``'s quantized engine, then
    the baseline when asked. ``emit(row)`` is called on each row as it is
    made."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {MODES}")
    out = []

    def add(row):
        out.append(row)
        if emit is not None:
            emit(row)

    for bw in bits:
        it = base_it if bw == base_it.bit_width else base_it.rebit(bw)
        eng = QGTCEngine(feat_dim=it.feat_dim, num_classes=ds.num_classes, model=model, bit_width=bw,
                         zerotile_jump=zerotile_jump, device=device)
        run = {"mega": lambda: eng.run_epochs_mega(it, n_epochs=n_epochs),
               "fused": lambda: eng.run_epochs_fused(it, n_epochs=n_epochs),
               "step": lambda: eng.run_epochs(it, n_epochs=n_epochs, resident=True)}[mode]
        info = (lambda: eng.mega_buckets) if mode == "mega" else list
        add(_cell(run, info, dict(dataset=ds.name, model=model, engine="qgtc", bits=bw, mode=mode, card=card)))
    if baseline:
        it = base_it if base_it.bit_width == 2 else base_it.rebit(2)
        beng = BaselineEngine(feat_dim=it.feat_dim, num_classes=ds.num_classes,
                              model="gin" if model == "gin" else "sage", device=device)
        run = {"mega": lambda: beng.run_epochs_mega(it, ds, n_epochs=n_epochs),
               "fused": lambda: beng.run_epochs_fused(it, ds, n_epochs=n_epochs),
               "step": lambda: beng.run_epochs(it, ds, n_epochs=n_epochs)}[mode]
        info = (lambda: beng.mega_buckets) if mode == "mega" else list
        add(_cell(run, info, dict(dataset=ds.name, model=model, engine="fp-baseline", bits=32, mode=mode,
                                  card=card)))
    return out


COLUMNS = ("dataset", "model", "engine", "bits", "mode", "epoch_ms", "launch_sync_ms", "fallback_buckets", "card",
           "not_run")


def rows(datasets: Sequence[str] = DATASETS, bits: Sequence[int] = (2,), gin: bool = False, baseline: bool = False,
         psize: Optional[int] = None, batch_size: int = 20, n_epochs: int = 10, scale: float = 1.0,
         zerotile_jump=None, mode: str = "mega", device="cuda", csv: Optional[str] = None) -> list:
    """The matrix over ``datasets`` (names of ``graph/datasets.py``'s
    stand-ins at ``scale``), each row printed and, with ``csv``, the CSV
    rewritten after it."""
    dev, card = study_device(device)
    out = []

    def emit(row):
        out.append({k: row[k] for k in COLUMNS})
        print(out[-1], flush=True)
        if csv:
            write_csv(csv, out, list(COLUMNS))

    for name in datasets:
        ds = load_dataset(name, scale=scale)
        base_it = ClusterBatcher(ds, psize=psize or DEFAULT_PSIZE.get(name, 1500), batch_size=batch_size,
                                 bit_width=bits[0], cache_dir="./datasets")
        dataset_rows(ds, base_it, bits, dev, card, model="gin" if gin else "gcn", baseline=baseline, mode=mode,
                     n_epochs=n_epochs, zerotile_jump=zerotile_jump, emit=emit)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--datasets", nargs="+", default=list(DATASETS))
    p.add_argument("--bits", nargs="+", type=int, default=[2])
    p.add_argument("--gin", action="store_true")
    p.add_argument("--baseline", action="store_true", help="also run the bf16 baseline engine")
    p.add_argument("--psize", type=int, default=None,
                   help="partition count (default: 1500, or the per-dataset override for very large graphs)")
    p.add_argument("--batch-size", type=int, default=20)
    p.add_argument("--n-epochs", type=int, default=10)
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--zerotile_jump", action="store_true", default=None,
                   help="force zero-tile skipping on (absent: the engines' own gates)")
    p.add_argument("--mode", choices=MODES, default="mega")
    p.add_argument("--device", default="cuda")
    p.add_argument("--csv", default=None)
    args = p.parse_args(argv)
    out = rows(args.datasets, args.bits, args.gin, args.baseline, args.psize, args.batch_size, args.n_epochs,
               args.scale, args.zerotile_jump, args.mode, args.device, args.csv)
    if args.csv and out:
        print(f"wrote {args.csv}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
