"""Accuracy-vs-bit-width frontier of the deployed quantized engine.

    python3 -m qgtc_ppopp22_tpu_torch.benchmarks.accuracy_frontier \
        [--datasets Proteins artist] [--bits 1 2 4 8] [--scale 0.05] \
        [--gin | --both-models] [--seeds 0 1 2] [--lrs 0.01] [--f1] \
        [--device cuda] [--csv F]

The port of the JAX package's ``benchmarks/accuracy_frontier.py``, with its
arguments, but ``--device`` (default ``cuda``) in place of ``--cpu``.
Trains the quantization-aware float twin per bit width (``models/train.py``:
smooth pretrain, shift calibration, STE fine-tune, laddered over the widths
by ``qat_ladder``) and reports the deployed quantized engine's
node-classification accuracy (``--f1``: multilabel micro-F1) at each width,
something the reference could not measure (ones weights, no backward). The
STE forward is integer-exact to the engine, so train accuracy equals
deployed accuracy, and the ladder's exact-emulation candidate makes each
row at least the one before it. Prints the card's name and power limit
(``cpu`` on the CPU) first, then one row per width.
"""

from __future__ import annotations

import argparse
import sys

import torch


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--datasets", nargs="+", default=["Proteins"])
    p.add_argument("--bits", nargs="+", type=int, default=[1, 2, 4, 8])
    p.add_argument("--psize", type=int, default=8)
    p.add_argument("--batch-size", type=int, default=2)
    p.add_argument("--scale", type=float, default=0.05)
    p.add_argument("--hidden", type=int, default=None)
    p.add_argument("--gin", action="store_true")
    p.add_argument("--both-models", action="store_true")
    p.add_argument("--seeds", nargs="+", type=int, default=[0, 1, 2])
    p.add_argument("--f1", action="store_true",
                   help="multilabel micro/macro F1 frontier (ppi; reference calc_f1 role, utils.py:43-50)")
    p.add_argument("--lrs", nargs="+", type=float, default=[1e-2],
                   help="base lrs for the fresh-QAT candidate pool")
    p.add_argument("--device", default="cuda", help="torch device of training and deployment")
    p.add_argument("--csv", type=str, default=None)
    args = p.parse_args(argv)

    from qgtc_ppopp22_tpu_torch.bench import card_line
    from qgtc_ppopp22_tpu_torch.graph import ClusterBatcher, load_dataset
    from qgtc_ppopp22_tpu_torch.models.train import qat_ladder
    from qgtc_ppopp22_tpu_torch.utils.metrics import write_csv

    device = torch.device(args.device)
    print(f"card: {card_line(device)}")
    models = ["gcn", "gin"] if args.both_models else ["gin"] if args.gin else ["gcn"]
    rows = []
    for name in args.datasets:
        ds = load_dataset(name, scale=args.scale)

        def make_batcher(bits, feature_scale=1.0, quant_bits=None):
            return ClusterBatcher(ds, psize=args.psize, batch_size=args.batch_size, bit_width=bits,
                                  shuffle=False, feature_scale=feature_scale, quant_bits=quant_bits)

        for model in models:
            hidden = args.hidden or (16 if model == "gcn" else 64)
            got = qat_ladder(ds, make_batcher, args.bits, model=model, hidden=hidden, seeds=args.seeds,
                             metric="f1" if args.f1 else "accuracy", lrs=args.lrs, device=device)
            for row in got:
                row = dict(dataset=name, **row)
                rows.append(row)
                print(row, flush=True)
    if args.csv and rows:
        write_csv(args.csv, rows, list(rows[0].keys()))
        print(f"wrote {args.csv}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
