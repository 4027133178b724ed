"""Epoch structure of the mesh engine over (dp, sp) meshes.

    python -m qgtc_ppopp22_tpu_torch.benchmarks.mesh_scaling [--device cuda:0|cuda|cpu] [--csv F]

The counterpart of the JAX repository's ``benchmarks/mesh_scaling.py``. On
one device (``--device cuda:0`` or ``cpu``, the default ``cuda:0``) every
mesh runs over that device repeated, so the rows show the structure of the
mesh path, not its scaling: every shard's work runs on the one card, one
after another. With ``--device cuda`` the mesh takes distinct GPUs and
stops at the meshes the machine has devices for. Each row:

* ``work_units`` = ceil(B / dp) / sp: a device's share of the epoch in
  whole-batch forwards (dp shards the batches, sp each batch's GEMMs);
* ``epoch_ms``: host ms per epoch (all epochs launched, one synchronize,
  the least of 3 runs) of the Proteins stand-in (scale 0.25) at psize 32;
* ``ms_per_unit`` = epoch_ms / work_units;
* ``marginal_ms_per_unit`` = (ms(5B) - ms(B)) / (units(5B) - units(B)), the
  same mesh at psize 160 against psize 32: it cancels the fixed cost of an
  epoch;
* ``parity``: every batch's logits equal the single-device step engine's;
* ``modes``: each bucket's mode (mega or ring).
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from qgtc_ppopp22_tpu_torch.graph import ClusterBatcher, synthesize
from qgtc_ppopp22_tpu_torch.parallel import MeshEngine
from qgtc_ppopp22_tpu_torch.runtime import QGTCEngine
from qgtc_ppopp22_tpu_torch.utils.metrics import write_csv

MESHES = ((1, 1), (2, 1), (4, 1), (8, 1), (1, 2), (2, 2), (4, 2), (1, 4))
N_EPOCHS = 5
SCALE = 0.25  # of the Proteins stand-in


def run_cfg(ds, dp: int, sp: int, psize: int, device: torch.device):
    """(batcher, engine, least epoch ms of 3 runs, work units) of one mesh."""
    batcher = ClusterBatcher(ds, psize=psize, batch_size=2, bit_width=2, shuffle=False,
                             bucket_rows=max(512, 256 * sp))
    devices = None if device.type == "cuda" and device.index is None else [device] * (dp * sp)
    eng = MeshEngine(batcher.feat_dim, ds.num_classes, dp=dp, sp=sp, model="gcn", bit_width=2, seed=0,
                     devices=devices)
    eng.stage(batcher)
    eng._epoch()
    eng._sync()
    ms = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(N_EPOCHS):
            eng._epoch()
        eng._sync()
        ms = min(ms, (time.perf_counter() - t0) * 1e3 / N_EPOCHS)
    units = sum(-(-len(s.batches) // dp) for s in eng._staged) / sp
    return batcher, eng, ms, units


def rows(device: torch.device) -> list:
    ds = synthesize("Proteins", scale=SCALE, seed=0)
    out = []
    for dp, sp in MESHES:
        if device.type == "cuda" and device.index is None and dp * sp > torch.cuda.device_count():
            continue
        batcher, eng, ms, units = run_cfg(ds, dp, sp, 32, device)
        _, _, ms5, units5 = run_cfg(ds, dp, sp, 160, device)
        ref = QGTCEngine(batcher.feat_dim, ds.num_classes, model="gcn", bit_width=2, seed=0, device=eng.device)
        parity = all(torch.equal(o, r[: b.num_nodes, : ds.num_classes].cpu())
                     for o, r, b in zip(eng.forward_batches(batcher), ref.forward_all(batcher), batcher.batches))
        out.append(dict(dp=dp, sp=sp, batches=len(batcher), work_units=units, epoch_ms=ms, ms_per_unit=ms / units,
                        marginal_ms_per_unit=(ms5 - ms) / max(units5 - units, 1e-9),
                        parity="exact" if parity else "MISMATCH", modes=";".join(eng.modes)))
        print(out[-1], flush=True)
        if not parity:
            raise AssertionError(f"mesh dp={dp} sp={sp} diverged from the single-device engine")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--csv", default=None)
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    where = "distinct GPUs" if dev.type == "cuda" and dev.index is None else f"{dev} repeated (structure, not scaling)"
    print(f"mesh_scaling: GCN 2-bit, Proteins x{SCALE}, every mesh over {where}")
    out = rows(dev)
    if args.csv:
        write_csv(args.csv, out, list(out[0]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
