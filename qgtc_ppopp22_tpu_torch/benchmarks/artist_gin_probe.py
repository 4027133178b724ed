"""Why the artist GIN frontier is flat: a grid over the knobs the ladder fixes.

    python3 -m qgtc_ppopp22_tpu_torch.benchmarks.artist_gin_probe [--bits 4 8] [--scale 0.05] \
        [--seeds 0 1 2 3] [--device cuda] [--csv F]

The port of the JAX package's ``benchmarks/artist_gin_probe.py``, with its
arguments and ``--device`` (default ``cuda``). At 4 and 8 bits it trains
artist GIN (hidden 64) by ``qat_train`` over a grid of feature-scale
multipliers (0.25, 1, 4 times ``ladder_feature_scale``), base lrs (5e-3,
2e-2) and seeds, the engine untouched, and reports every cell's train and
deployed accuracy and whether it beats the 1-bit floor of the JAX
package's committed frontier (0.1457). Training and the deployed engine run
on ``--device``. Prints the card's name and power limit (``cpu`` on the
CPU) first, then one row per cell and the best.
"""

from __future__ import annotations

import argparse
import sys

import torch

FLOOR = 0.1457  # the JAX package's committed 1-bit artist GIN frontier value


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--bits", nargs="+", type=int, default=[4, 8])
    p.add_argument("--scale", type=float, default=0.05)
    p.add_argument("--seeds", nargs="+", type=int, default=[0, 1, 2, 3])
    p.add_argument("--device", default="cuda", help="torch device of training and deployment")
    p.add_argument("--csv", default=None)
    args = p.parse_args(argv)

    from qgtc_ppopp22_tpu_torch.bench import card_line
    from qgtc_ppopp22_tpu_torch.graph import ClusterBatcher, load_dataset
    from qgtc_ppopp22_tpu_torch.models.qmodels import QModelConfig
    from qgtc_ppopp22_tpu_torch.models.train import ladder_feature_scale, qat_train, quantized_accuracy
    from qgtc_ppopp22_tpu_torch.utils.metrics import write_csv

    device = torch.device(args.device)
    print(f"card: {card_line(device)}")
    ds = load_dataset("artist", scale=args.scale)
    rows = []
    for bits in args.bits:
        for fs_mult in (0.25, 1.0, 4.0):
            it = ClusterBatcher(ds, psize=8, batch_size=2, bit_width=bits, shuffle=False,
                                feature_scale=ladder_feature_scale(bits) * fs_mult)
            cfg = QModelConfig(it.feat_dim, 64, ds.num_classes, bit_width=bits)
            for lr0 in (5e-3, 2e-2):
                for seed in args.seeds:
                    ws, sh, acc = qat_train(ds, it, cfg, model="gin", seed=seed, lr=lr0, device=device)
                    dep = quantized_accuracy(ds, it, ws, bits, "gin", shifts=sh, device=device)
                    rows.append(dict(bits=bits, fs_mult=fs_mult, lr=lr0, seed=seed, train_acc=round(float(acc), 4),
                                     deployed_acc=round(float(dep), 4), beats_floor=dep > FLOOR + 1e-4))
                    print(rows[-1], flush=True)
    print(f"best: {max(rows, key=lambda r: r['deployed_acc'])}")
    if args.csv and rows:
        write_csv(args.csv, rows, list(rows[0].keys()))
        print(f"wrote {args.csv}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
