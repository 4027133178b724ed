"""Command-line entry point of the step engine (reference ``main_qgtc.py``).

Usage mirrors the reference (``main_qgtc.py:21-41``)::

    python -m qgtc_ppopp22_tpu_torch.cli --dataset ogbn-arxiv --bit_width 2 \
        --use_QGTC [--run_GIN] [--resident]

Prints ``Avg. Epoch: <ms> ms`` as the reference does
(``main_qgtc.py:157-159``), then one JSON record. Flags of the JAX
package's CLI that this engine does not have yet stop with a "not yet
ported" error instead of being ignored.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import time

import numpy as np
import torch

from qgtc_ppopp22_tpu_torch.graph import ClusterBatcher, load_dataset
from qgtc_ppopp22_tpu_torch.graph.datasets import DEFAULT_PSIZE
from qgtc_ppopp22_tpu_torch.runtime import QGTCEngine

NOT_PORTED = (
    "--dataset-scale", "--zerotile_jump", "--regular", "--sparse", "--use-pp",
    "--fmt", "--mode", "--mesh", "--sync-every-epoch", "--bucket-rows",
    "--cache-dir", "--eval-accuracy", "--timing-split", "--quant-in-loop",
    "--json-out", "--weights", "--profile-dir",
)


class _NotPorted(argparse.Action):
    def __init__(self, option_strings, dest, **kwargs):
        kwargs["nargs"] = "?"
        super().__init__(option_strings, dest, **kwargs)

    def __call__(self, parser, namespace, values, option_string=None):
        parser.error(f"{option_string} is not yet ported to the PyTorch engine")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="QGTC quantized GNN inference (PyTorch, step engine)")
    p.add_argument("--dataset", type=str, default="ppi")
    p.add_argument("--data-dir", type=str, default="qgtc_graphs")
    p.add_argument("--n-epochs", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=20)
    p.add_argument("--psize", type=int, default=None,
                   help="partition count (default: 1500, or a per-dataset "
                        "override for very large graphs)")
    p.add_argument("--hidden", type=int, default=None)
    p.add_argument("--num-layers", type=int, default=3)
    p.add_argument("--bit_width", type=int, default=2)
    p.add_argument("--use_QGTC", action="store_true",
                   help="the quantized engine (the only one ported)")
    p.add_argument("--run_GIN", action="store_true")
    p.add_argument("--resident", action="store_true",
                   help="move packed batches to the device once; time compute only")
    p.add_argument("--partition-method", type=str, default="auto")
    p.add_argument("--rnd_seed", type=int, default=3)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device the engine runs on (never changed "
                        "on its own)")
    for flag in NOT_PORTED:
        p.add_argument(flag, action=_NotPorted, help=argparse.SUPPRESS)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    random.seed(args.rnd_seed)
    np.random.seed(args.rnd_seed)

    t0 = time.perf_counter()
    ds = load_dataset(args.dataset, data_dir=args.data_dir)
    print(f"[t] dataset load/synth: {time.perf_counter() - t0:.1f}s")
    print(
        f"dataset {ds.name}: {ds.num_nodes} nodes, {ds.graph.num_edges} edges, "
        f"dim {ds.feat_dim}, {ds.num_classes} classes"
    )
    t0 = time.perf_counter()
    psize = args.psize or DEFAULT_PSIZE.get(ds.name, 1500)
    batcher = ClusterBatcher(
        ds, psize=psize, batch_size=args.batch_size, bit_width=args.bit_width,
        seed=args.rnd_seed, partition_method=args.partition_method,
        cache_dir="./datasets",
    )
    print(
        f"[t] partition+pack: {time.perf_counter() - t0:.1f}s; "
        f"{len(batcher)} batches/epoch, shape buckets {batcher.buckets()}"
    )
    model = "gin" if args.run_GIN else "gcn"
    eng = QGTCEngine(
        feat_dim=batcher.feat_dim, num_classes=ds.num_classes, model=model,
        bit_width=args.bit_width, hidden=args.hidden, num_layers=args.num_layers,
        seed=args.rnd_seed, device=args.device,
    )
    stats = eng.run_epochs(batcher, n_epochs=args.n_epochs, resident=args.resident)
    device = torch.device(args.device)
    record = dict(
        dataset=ds.name, bit_width=args.bit_width, model=model, engine="qgtc-step",
        psize=psize, batch_size=args.batch_size, n_epochs=args.n_epochs,
        resident=args.resident, device=str(device),
        device_name=(torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"),
    )
    print(f"Avg. Epoch: {stats.avg_ms:.3f} ms")
    record["avg_epoch_ms"] = stats.avg_ms
    record["epoch_ms"] = stats.epoch_ms
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
