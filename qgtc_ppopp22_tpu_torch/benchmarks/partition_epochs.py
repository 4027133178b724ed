"""C1's set-up and epochs on the native and the BFS partition.

    python3 -m qgtc_ppopp22_tpu_torch.benchmarks.partition_epochs [--runs 3] [--epochs 20] \
        [--methods native bfs] [--cells E1 E3 E3-8 E5 B3] [--host-runs 3] [--trace-dir D]

C1 is the 2-bit 3-layer Cluster-GCN (hidden 16) on the full ogbn-arxiv
stand-in, psize 1500, batch 20. For each partition method (``native``, the
default ``auto`` resolves to it where g++ builds the host library, and
``bfs``), the script builds the batcher without a partition cache and
prints the host pipeline's seconds (partition, densify, reorder, quantize,
pack), the buckets and their batch counts, the K tiles the zero-tile maps
list, each mega bucket's skippable share of blocks, and the device time
of each bucket's one launch (``utils/timing.device_times_ms``): K1 at 2
and at 8 bits, K5. Then it times, in turns over the two partitions,
``--runs`` runs of ``--epochs`` epochs of:

* E1: the step engine, batches resident (``QGTCEngine.run_epochs``);
* E3: the mega engine (``run_epochs_mega``, one K1 launch per bucket);
* E3-8: the same at 8 bits (``rebit(8)`` of the batcher, C1-8's shifts
  ``[6, 2, 11, 2, 11]``; K1's levels form);
* E5: the captured fused epoch (``run_epochs_fused``, one replay an epoch);
* B3: the sage baseline's mega mode (``BaselineEngine.run_epochs_mega``,
  one K5 launch per bucket);

each a host-clock ms/epoch over all epochs launched and one synchronize.
``--methods`` and ``--cells`` narrow the partitions and the timed runs.

Then, on the native partition, the host pipeline with densify, quantize
and pack in the native library and in NumPy (``native=False``), both on
the cached partition, ``--host-runs`` (default ``--runs``) builds each in
turns (0: none); and,
on each partition, a trace of E3 and E3-8 (:func:`trace_epochs`): the
host's time per launch, the device's time and idle share per epoch, the
synchronizing calls and the host ops with the most self time.
``--trace-dir`` also writes each trace's table of host ops and its
Chrome trace there. Prints the card's name and power limit first and
one JSON line per partition last. Runs on the card (``--device cuda``,
the default).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import tempfile
import time

import torch

from qgtc_ppopp22_tpu_torch.bench import card_line
from qgtc_ppopp22_tpu_torch.graph import ClusterBatcher, load_dataset
from qgtc_ppopp22_tpu_torch.runtime import BaselineEngine, QGTCEngine
from qgtc_ppopp22_tpu_torch.utils.timing import device_times_ms

SEED = 3
METHODS = ("native", "bfs")
CELLS = ("E1", "E3", "E3-8", "E5", "B3")
SHIFTS8 = (6, 2, 11, 2, 11)  # C1-8's (PERF.md section 4)


def bucket_us(staged, buckets, iters: int = 10) -> dict:
    """Device microseconds of each bucket's one launch, keyed by its pn."""
    times = device_times_ms({bk["pn"]: fn for (_, fn), bk in zip(staged, buckets)}, iters=iters)
    return {pn: ms * 1e3 for pn, ms in times.items()}


def host_pipeline_s(ds, runs: int) -> dict:
    """Seconds of C1's host pipeline on the native partition (read from
    a cache written first) with densify, quantize and pack in the native
    library and in NumPy, ``runs`` builds each in turns."""
    kw = dict(psize=1500, batch_size=20, bit_width=2, seed=SEED, partition_method="native")
    secs = {"native": [], "numpy": []}
    with tempfile.TemporaryDirectory(dir=".") as tmp:
        ClusterBatcher(ds, cache_dir=tmp, **kw)
        for _ in range(runs):
            for path in secs:
                t0 = time.perf_counter()
                ClusterBatcher(ds, cache_dir=tmp, native=path == "native", **kw)
                secs[path].append(time.perf_counter() - t0)
    return secs


def trace_epochs(fns, epochs: int, trace_path=None, top: int = 12) -> dict:
    """``epochs`` epochs of the staged launches ``fns`` (one a bucket)
    after one untimed epoch. Without the profiler: the host's ms in each
    launch call (no synchronize; the median over the epochs) and the
    epoch's host ms (all launched, one synchronize). The epoch's device ms
    from ``device_times_ms`` (its marker-fenced session; a plain session
    can drop a launch's record), and the device's idle share of the
    untraced epoch. Then one profiler session of host and device
    activity over ``epochs`` epochs: the synchronizing calls in it (the
    closing synchronize among them) and the ``top`` host ops by self time
    per epoch, with their calls per epoch. ``trace_path``: the table of
    host ops goes to ``trace_path + '.txt'`` and the Chrome trace to
    ``trace_path + '.json'``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def one_epoch():
        return [fn() for fn in fns]

    one_epoch()
    torch.cuda.synchronize()
    per_call = [[] for _ in fns]
    t0 = time.perf_counter()
    for _ in range(epochs):
        for j, fn in enumerate(fns):
            t1 = time.perf_counter()
            fn()
            per_call[j].append((time.perf_counter() - t1) * 1e3)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / epochs
    device_ms = device_times_ms({"epoch": one_epoch}, iters=epochs, warmup=1)["epoch"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(epochs):
            one_epoch()
        torch.cuda.synchronize()
    table = prof.key_averages()
    syncs = {e.key: e.count for e in table
             if "Synchronize" in e.key or e.key in ("cudaMemcpy", "aten::item", "aten::_local_scalar_dense")}
    host_ops = sorted((e for e in table if e.device_type == DeviceType.CPU),
                      key=lambda e: e.self_cpu_time_total, reverse=True)[:top]
    if trace_path:
        with open(trace_path + ".txt", "w") as f:
            f.write(table.table(sort_by="self_cpu_time_total", row_limit=60))
        prof.export_chrome_trace(trace_path + ".json")
    return dict(host_ms_per_launch=[statistics.median(c) for c in per_call], epoch_ms=wall_ms,
                device_ms=device_ms, device_idle_share=1.0 - device_ms / wall_ms, syncs_in_session=syncs,
                host_ops_self_ms_per_epoch={e.key: [e.self_cpu_time_total / 1e3 / epochs, e.count / epochs]
                                            for e in host_ops})


def setup(ds, method: str, device, epochs: int) -> dict:
    """C1's set-up record on ``method`` and its five timed runs of
    ``epochs`` epochs each."""
    t0 = time.perf_counter()
    batcher = ClusterBatcher(ds, psize=1500, batch_size=20, bit_width=2, seed=SEED, partition_method=method)
    host_s = time.perf_counter() - t0
    eng = QGTCEngine(feat_dim=batcher.feat_dim, num_classes=ds.num_classes, model="gcn", bit_width=2, seed=SEED,
                     device=device)
    beng = BaselineEngine(feat_dim=batcher.feat_dim, num_classes=ds.num_classes, model="sage", seed=SEED,
                          device=device)
    batcher8 = batcher.rebit(8)
    eng8 = QGTCEngine(feat_dim=batcher.feat_dim, num_classes=ds.num_classes, model="gcn", bit_width=8, seed=SEED,
                      device=device, shifts=SHIFTS8)
    k1_8 = bucket_us(eng8._stage_mega(batcher8), eng8.mega_buckets)
    k5 = bucket_us(beng._stage_mega(batcher, ds), beng.mega_buckets)
    k1 = bucket_us(eng._stage_mega(batcher), eng.mega_buckets)
    listed, tiles = batcher.tile_counts()
    record = dict(partition=batcher.partition_method, host_pipeline_s=host_s, batches=len(batcher),
                  buckets={pn: sum(b.padded_nodes == pn for b in batcher.batches) for pn in batcher.buckets()},
                  tiles_listed=listed, tiles_total=tiles,
                  skippable={bk["pn"]: bk["skippable"] for bk in eng.mega_buckets},
                  compact={bk["pn"]: bk["compact"] for bk in eng.mega_buckets},
                  k1_us=k1, k1_8bit_us=k1_8, k5_us=k5)
    runs = {"E1": lambda: eng.run_epochs(batcher, n_epochs=epochs, resident=True),
            "E3": lambda: eng.run_epochs_mega(batcher, n_epochs=epochs),
            "E3-8": lambda: eng8.run_epochs_mega(batcher8, n_epochs=epochs),
            "E5": lambda: eng.run_epochs_fused(batcher, n_epochs=epochs),
            "B3": lambda: beng.run_epochs_mega(batcher, ds, n_epochs=epochs)}
    staged = {"E3": (eng, batcher), "E3-8": (eng8, batcher8)}
    traces = {k: (lambda e=e, b=b: [fn for _, fn in e._stage_mega(b)]) for k, (e, b) in staged.items()}
    return dict(record=record, runs=runs, traces=traces)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--runs", type=int, default=3)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--device", default="cuda")
    p.add_argument("--trace-epochs", type=int, default=5)
    p.add_argument("--trace-dir", default=None)
    p.add_argument("--methods", nargs="+", choices=METHODS, default=list(METHODS))
    p.add_argument("--cells", nargs="+", choices=CELLS, default=list(CELLS))
    p.add_argument("--host-runs", type=int, default=None, help="default: --runs")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    card = card_line(device)
    print(f"card: {card}")
    ds = load_dataset("ogbn-arxiv", data_dir="qgtc_graphs")
    cells = {m: setup(ds, m, device, args.epochs) for m in args.methods}
    for m, c in cells.items():
        print(f"set-up {m}: " + json.dumps(c["record"]))
    times = {m: {k: [] for k in args.cells} for m in cells}
    for k in args.cells:
        for _ in range(args.runs):
            for m, c in cells.items():
                times[m][k].append(c["runs"][k]().avg_ms)
        print(f"{k} ms/epoch, {args.runs} runs of {args.epochs} epochs in turns: "
              + "; ".join(f"{m} " + " / ".join(f"{v:.3f}" for v in times[m][k]) for m in cells) + f" [{card}]")
    host_runs = args.runs if args.host_runs is None else args.host_runs
    if host_runs and "native" in cells:
        host = host_pipeline_s(ds, host_runs)
        cells["native"]["record"]["host_pipeline_cached_s"] = host
        print("host pipeline on the cached native partition, densify / quantize / pack in: "
              + "; ".join(f"{k} " + " / ".join(f"{v:.2f}" for v in vs) for k, vs in host.items()) + " s")
    if args.trace_dir:
        os.makedirs(args.trace_dir, exist_ok=True)
    for m, c in cells.items():
        c["record"]["trace"] = {}
        for k, fns in c["traces"].items():
            path = os.path.join(args.trace_dir, f"trace_{m}_{k}") if args.trace_dir else None
            t = c["record"]["trace"][k] = trace_epochs(fns(), args.trace_epochs, path)
            print(f"trace {m} {k}: " + json.dumps(t) + f" [{card}]")
    for m, c in cells.items():
        print(json.dumps(dict(c["record"], card=card, epochs=args.epochs, ms_per_epoch=times[m])))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
