"""Two probes of the accuracy frontier's dead cells.

    python3 -m qgtc_ppopp22_tpu_torch.benchmarks.frontier_probe [--scale 0.05] [--device cuda] [--csv F]

The port of the JAX package's ``benchmarks/frontier_probe.py``, with its
arguments and ``--device`` (default ``cuda``):

1. **ppi GIN 1-bit F1 = 0.0**: retrains the winner configuration and
   records the per-class logit variance, the share of constant classes and
   what the trivial tie-breaks would score: a 1-bit aggregate-first chain
   that saturates every class to a constant leaves the calibrated threshold
   (``logits - per-class mean > 0``) predicting nothing.
2. **soc-BlogCatalog GIN flat at the 1-bit floor**: at 2 bits, sweeps the
   first aggregation's shift around the calibrated one and records that
   stage's saturation on batch 0 and the deployed accuracy.

Training and the deployed engine run on ``--device``. Prints the card's
name and power limit (``cpu`` on the CPU) first, then one row per probe.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--scale", type=float, default=0.05)
    p.add_argument("--device", default="cuda", help="torch device of training and deployment")
    p.add_argument("--csv", default=None)
    args = p.parse_args(argv)

    from qgtc_ppopp22_tpu_torch.bench import card_line
    from qgtc_ppopp22_tpu_torch.graph import ClusterBatcher, load_dataset
    from qgtc_ppopp22_tpu_torch.models.golden import bitmm_np, quantize_np
    from qgtc_ppopp22_tpu_torch.models.qmodels import QModelConfig
    from qgtc_ppopp22_tpu_torch.models.train import qat_train, quantized_accuracy
    from qgtc_ppopp22_tpu_torch.ops.bitpack import bit2val
    from qgtc_ppopp22_tpu_torch.runtime import QGTCEngine
    from qgtc_ppopp22_tpu_torch.utils.metrics import multilabel_f1, write_csv

    device = torch.device(args.device)
    print(f"card: {card_line(device)}")
    rows = []

    # ---- probe 1: ppi GIN 1-bit ------------------------------------
    ds = load_dataset("ppi", scale=args.scale)
    it = ClusterBatcher(ds, psize=8, batch_size=2, bit_width=1, shuffle=False)
    ncls = ds.multilabels.shape[1]
    cfg = QModelConfig(in_dim=it.feat_dim, hidden=64, out_dim=ncls, bit_width=1)
    ws, shifts, _ = qat_train(ds, it, cfg, model="gin", seed=0, lr=1e-2, multilabel=True, device=device)
    eng = QGTCEngine(feat_dim=it.feat_dim, num_classes=ncls, model="gin", bit_width=1, hidden=64,
                     shifts=shifts, device=device)
    eng.set_float_weights(ws)
    logit_rows, lab_rows = [], []
    for b, lg in zip(it.batches, eng.forward_all(it)):
        logit_rows.append(lg[: b.num_nodes, :ncls].cpu().numpy())
        lab_rows.append(ds.multilabels[b.nodes])
    L, Y = np.concatenate(logit_rows), np.concatenate(lab_rows)
    var = L.var(axis=0)
    rows.append(dict(
        probe="ppi_gin_1bit", config="winner(seed0,lr0.01)",
        value=round(float(multilabel_f1(L - L.mean(axis=0, keepdims=True), Y)), 4),
        const_class_frac=round(float((var == 0).mean()), 4),
        mean_logit_var=round(float(var.mean()), 4),
        f1_allpos_trivial=round(float(multilabel_f1(np.ones_like(L), Y)), 4),
        f1_raw_unsigned=round(float(multilabel_f1(L, Y)), 4),  # the reference's rule on unsigned logits
        note=("per-class-constant logits -> calibrated threshold predicts nothing; raw>0 on unsigned "
              "logits predicts everything (=trivial). Degenerate 1-bit chain, not an engine bug."),
    ))
    print(rows[-1], flush=True)

    # ---- probe 2: soc GIN 2-bit shift sweep ------------------------
    ds2 = load_dataset("soc-BlogCatalog", scale=args.scale)
    it2 = ClusterBatcher(ds2, psize=8, batch_size=2, bit_width=2, shuffle=False)
    cfg2 = QModelConfig(in_dim=it2.feat_dim, hidden=64, out_dim=ds2.num_classes, bit_width=2)
    ws2, sh2, acc_base = qat_train(ds2, it2, cfg2, model="gin", seed=2, lr=1e-2, device=device)
    # the first aggregation's saturation under each shift, on batch 0
    b0 = it2.batches[0]
    n0 = b0.num_nodes
    qa = bit2val(b0.bit_A).numpy()[:n0, :n0]
    qx = quantize_np(np.asarray(ds2.features[b0.nodes], np.float32), 2)
    rail = 3
    for d0 in (-2, -1, 0, 1, 2):
        sh_t = list(sh2)
        sh_t[0] = max(0, sh_t[0] + d0)
        sat0 = float((bitmm_np(qa, qx, 1, 2, 2, sh_t[0]) == rail).mean())
        acc = quantized_accuracy(ds2, it2, ws2, 2, "gin", shifts=sh_t, device=device)
        rows.append(dict(
            probe="soc_gin_2bit_shift0", config=f"shift0={sh_t[0]}", value=round(float(acc), 4),
            const_class_frac=None, mean_logit_var=None, f1_allpos_trivial=None, f1_raw_unsigned=None,
            note=f"first-agg saturation {sat0:.3f}; baseline acc {acc_base:.4f}; 1-bit floor 0.039",
        ))
        print(rows[-1], flush=True)

    if args.csv and rows:
        write_csv(args.csv, rows, list(rows[0].keys()))
        print(f"wrote {args.csv}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
