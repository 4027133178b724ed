"""Command-line entry point of the engines (reference ``main_qgtc.py``).

Usage mirrors the reference (``main_qgtc.py:21-41``)::

    python -m qgtc_ppopp22_tpu_torch.cli --dataset ogbn-arxiv --bit_width 2 \
        --use_QGTC [--run_GIN] [--resident] [--fmt digits|bits] \
        [--mode step|fused|mega] [--quant-in-loop] [--zerotile_jump] \
        [--timing-split] [--sync-every-epoch] [--use-pp] [--bucket-rows N] \
        [--partition-method auto|native|bfs|rcm] [--cache-dir D] \
        [--json-out F] [--profile-dir D] [--weights CHECKPOINT.npz]
    python -m qgtc_ppopp22_tpu_torch.cli --dataset ogbn-arxiv --regular \
        [--run_GIN] [--resident] [--mode step|fused|mega] [--eval-accuracy]
    python -m qgtc_ppopp22_tpu_torch.cli --dataset ogbn-arxiv --sparse \
        [--run_GIN] [--eval-accuracy] [--weights CHECKPOINT.npz]
    python -m qgtc_ppopp22_tpu_torch.cli --dataset ogbn-arxiv --mesh DP,SP \
        [--device cuda|cuda:0|cpu] [--run_GIN] [--zerotile_jump] [--eval-accuracy]

``--use_QGTC`` (the default engine) runs the quantized engine:
``--mode step`` (default) one GEMM chain per batch, ``--mode fused``
every bucket staged on the device once and the whole epoch's chains
replayed as one captured CUDA graph (``QGTCEngine.run_epochs_fused``),
``--mode mega`` one whole-model kernel launch per shape bucket
(``QGTCEngine.run_epochs_mega``). ``--quant-in-loop`` runs the fused
engine with the features quantized and packed on the device inside the
epoch (``run_epochs_quant_in_loop``; it takes the place of ``--mode``).
``--zerotile_jump`` forces zero-tile
skipping: in the digit step and fused engines each aggregation visits only the
adjacency's occupied 256 x 256 tiles, in mega mode the kernel takes the
compacted block schedule (absent: off in step and fused modes, the auto gate in
mega mode); the record then carries the batches' ``tiles_total`` and
``tiles_processed``, as the JAX CLI's does. ``--fmt bits`` runs the
step engine over bit planes throughout (the one-bit tensor-core GEMM)
instead of digit planes; the fused and mega modes require ``--fmt digits``.
``--timing-split`` adds the transfer / compute split of the engine that
``--mode`` chose (step: transfer-inclusive minus resident epochs; the
staged modes: their epoch, and one epoch's host -> device copies timed
alone). ``--regular`` runs the
full-precision baseline (``BaselineEngine``, the DGL-driver role;
``--run_GIN`` picks its GIN model): ``--mode step``, ``fused`` (the loop
over the buckets staged on the device, captured as one CUDA graph) or ``mega`` (one
``fused_baseline`` launch per bucket; a bucket or width the kernel
refuses runs the fused loop instead, and says so). ``--resident`` applies to the
step modes of both engines. ``--sync-every-epoch`` times each epoch with
its own synchronize instead of one after all epochs. ``--eval-accuracy``
adds the accuracy, and micro / macro F1 where the dataset has multilabels.
``--sparse`` runs the full-graph sparse engine (``SparseEngine``: no
clustering, no densification) and warns about the cluster engines' flags,
which it does not read. ``--use-pp`` pre-aggregates the features (the
batcher's ``precalc``: twice as wide), for either cluster engine.
``--partition-method auto`` takes the native multilevel partitioner when its
library builds, else BFS, and the record names the one that ran
(``partition_method``); partition lists are cached under ``--cache-dir``.
``--profile-dir`` writes a ``torch.profiler`` trace of the timed epochs.
``--weights F`` deploys a QAT checkpoint (``models/train.save_checkpoint``,
either package's npz) instead of seeded weights, in any quantized engine:
the checkpoint sets the model, the bit width (the batcher's too), the hidden
width, the layer count and the shifts, and the record names it.
``--eval-accuracy`` takes the logits from the engine ``--mode`` chose (step,
fused or mega; quant-in-loop: the step engine's, the same integers).
``--mesh DP,SP`` runs the quantized model on a (dp, sp) mesh
(``parallel/engine.MeshEngine``): batches over dp, each dp row running the
whole-model kernel on its share at sp 1, the adjacency rows over sp with
the ring of packed shard GEMMs at sp > 1 (``bucket_rows`` then rounds up to
a multiple of 256 x sp). Its devices are ``cuda:0 ... cuda:DP*SP-1`` for
``--device cuda``, else the one ``--device`` names, repeated (``cuda:0``:
every shard on one GPU; ``cpu``). The flags it does not read
(``--resident``, ``--mode``, ``--fmt``, ``--timing-split``,
``--quant-in-loop``) draw a warning; ``--regular`` runs the baseline
instead, as the JAX CLI does.

Prints ``Avg. Epoch: <ms> ms`` as the reference does
(``main_qgtc.py:157-159``), then one JSON record, with
``launch_sync_ms`` (all epochs launched, one synchronize, divided; 0
under ``--sync-every-epoch``), also appended to ``--json-out``. A malformed ``--mesh`` stops with exit
2 (``bad --mesh``).
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import os
import random
import sys
import time
from typing import Optional, Tuple

import numpy as np
import torch

from qgtc_ppopp22_tpu_torch.graph import ClusterBatcher, load_dataset
from qgtc_ppopp22_tpu_torch.graph.datasets import DEFAULT_PSIZE
from qgtc_ppopp22_tpu_torch.models.train import load_checkpoint
from qgtc_ppopp22_tpu_torch.parallel.engine import MeshEngine
from qgtc_ppopp22_tpu_torch.runtime import BaselineEngine, QGTCEngine, SparseEngine
from qgtc_ppopp22_tpu_torch.utils.metrics import write_json_line

NOT_PORTED = ()  # the JAX CLI's flags that this one refuses: none since --mesh


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="QGTC quantized GNN inference (PyTorch)")
    p.add_argument("--dataset", type=str, default="ppi")
    p.add_argument("--data-dir", type=str, default="qgtc_graphs")
    p.add_argument("--dataset-scale", type=float, default=1.0,
                   help="shrink factor for synthetic stand-in datasets")
    p.add_argument("--n-epochs", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=20)
    p.add_argument("--psize", type=int, default=None,
                   help="partition count (default: 1500, or a per-dataset "
                        "override for very large graphs)")
    p.add_argument("--hidden", type=int, default=None)
    p.add_argument("--num-layers", type=int, default=3)
    p.add_argument("--bit_width", type=int, default=2)
    p.add_argument("--use_QGTC", action="store_true",
                   help="the quantized engine (the default)")
    p.add_argument("--regular", action="store_true",
                   help="the full-precision baseline (DGL-driver role)")
    p.add_argument("--run_GIN", action="store_true")
    p.add_argument("--fmt", choices=("digits", "bits"), default="digits",
                   help="the quantized engine's working format: digit planes, "
                        "or bit planes on the one-bit tensor cores (step mode)")
    p.add_argument("--resident", action="store_true",
                   help="step mode: move batches to the device once; time compute only")
    p.add_argument("--mode", choices=("step", "fused", "mega"), default="step",
                   help="epoch execution: one chain per batch, the buckets "
                        "staged on the device and the epoch replayed as one "
                        "captured CUDA graph, or one whole-model kernel "
                        "launch per shape bucket")
    p.add_argument("--quant-in-loop", action="store_true",
                   help="quantize and bit-pack the features on the device "
                        "inside the timed epochs (the reference's in-loop "
                        "val2bit variant, cluster_gcn.py:181-206), in the "
                        "captured fused epoch; takes the place of --mode")
    p.add_argument("--timing-split", action="store_true",
                   help="report the transfer / compute split of the engine "
                        "--mode selects")
    p.add_argument("--sync-every-epoch", action="store_true",
                   help="per-epoch wall times instead of the reference's "
                        "one synchronize after all epochs")
    p.add_argument("--eval-accuracy", action="store_true",
                   help="report accuracy (and micro/macro F1 on multilabel data)")
    p.add_argument("--zerotile_jump", action="store_true", default=None,
                   help="force zero-tile skipping: the step and fused engines' "
                        "TileMap K skip (digits), the mega kernel's compacted schedule "
                        "(absent: off in step and fused modes; in mega mode auto, on at "
                        ">=45%% skippable blocks, pn >= 2048, <= 4 bits)")
    p.add_argument("--sparse", action="store_true",
                   help="the full-graph sparse quantized engine (CSR gather and "
                        "index_add_; no clustering, no densification)")
    p.add_argument("--use-pp", action="store_true",
                   help="precompute the feature aggregation (the sampler's precalc): "
                        "features become [X, (A X) / degree], twice as wide")
    p.add_argument("--bucket-rows", type=int, default=512,
                   help="batches' node counts pad up to a multiple of this")
    p.add_argument("--partition-method", type=str, default="auto",
                   help="auto (native when its library builds, else bfs), native, bfs or rcm")
    p.add_argument("--cache-dir", type=str, default="./datasets",
                   help="where partition lists are cached")
    p.add_argument("--json-out", type=str, default=None,
                   help="append the JSON record to this file")
    p.add_argument("--profile-dir", type=str, default=None,
                   help="write a torch.profiler trace of the timed epochs into this directory")
    p.add_argument("--weights", type=str, default=None,
                   help="deploy a QAT checkpoint (models/train.py save_checkpoint, either "
                        "package's) instead of seeded weights; it sets the model, bit width, "
                        "hidden width, layers and shifts")
    p.add_argument("--rnd_seed", type=int, default=3)
    p.add_argument("--mesh", type=str, default=None, metavar="DP,SP",
                   help="run the packed engine over a (dp, sp) device mesh (parallel/engine.py): "
                        "batches over dp (each dp row runs the whole-model kernel on its "
                        "share), adjacency rows over sp (the ring of packed shard GEMMs); "
                        "devices: distinct GPUs for --device cuda, else --device repeated")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device the engine runs on (never changed "
                        "on its own)")
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    mode = "quant-in-loop" if args.quant_in_loop else args.mode
    mesh = _parse_mesh(parser, args.mesh)
    if not args.sparse and not (mesh and not args.regular):  # these engines warn instead
        _refuse_combinations(parser, args, mode)
    random.seed(args.rnd_seed)
    np.random.seed(args.rnd_seed)
    device = torch.device(args.device)
    device_name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"

    t0 = time.perf_counter()
    ds = load_dataset(args.dataset, data_dir=args.data_dir, scale=args.dataset_scale)
    print(f"[t] dataset load/synth: {time.perf_counter() - t0:.1f}s")
    print(
        f"dataset {ds.name}: {ds.num_nodes} nodes, {ds.graph.num_edges} edges, "
        f"dim {ds.feat_dim}, {ds.num_classes} classes"
    )
    timed = dict(n_epochs=args.n_epochs, sync_every_epoch=args.sync_every_epoch)
    model = "gin" if args.run_GIN else "gcn"
    bit_width, hidden, num_layers = args.bit_width, args.hidden, args.num_layers
    ck_ws = shifts = None
    if args.weights:
        # the checkpoint is authoritative for the model and its quantization
        ck_ws, shifts, ck_cfg, model = load_checkpoint(args.weights)
        bit_width, hidden, num_layers = ck_cfg.bit_width, ck_cfg.hidden, ck_cfg.num_layers
        print(f"loaded checkpoint: {model}, {bit_width}-bit, hidden={hidden}, layers={num_layers}, "
              f"shifts={shifts}")
    if args.sparse:
        # JAX cli.py:128-142: the flags the full-graph engine does not read
        for flag, name in ((args.zerotile_jump, "--zerotile_jump"), (args.use_pp, "--use-pp"),
                           (args.regular, "--regular"), (args.resident, "--resident"),
                           (args.mode != "step", "--mode"), (args.quant_in_loop, "--quant-in-loop"),
                           (args.timing_split, "--timing-split"), (args.fmt != "digits", "--fmt"),
                           (args.mesh, "--mesh")):
            if flag:
                print(f"warning: {name} has no effect with --sparse (full-graph CSR engine)",
                      file=sys.stderr)
        eng = SparseEngine(ds, model=model, bit_width=bit_width, hidden=hidden, num_layers=num_layers,
                           seed=args.rnd_seed, shifts=shifts, float_weights=ck_ws, device=device)
        with _profiled(args.profile_dir, device):
            stats = eng.run_epochs(**timed)
        record = dict(dataset=ds.name, bit_width=bit_width, model=model, engine="sparse-full-graph",
                      n_epochs=args.n_epochs, sync_every_epoch=args.sync_every_epoch, device=str(device),
                      device_name=device_name, weights=args.weights)
        if args.eval_accuracy:
            _accuracy(record, eng.evaluate, eng.evaluate_f1, ds)
        return _emit(record, stats, args)

    t0 = time.perf_counter()
    psize = args.psize or DEFAULT_PSIZE.get(ds.name, 1500)
    bucket_rows = args.bucket_rows
    if mesh and mesh[1] > 1:  # each sp shard holds whole 256-row pack groups (JAX cli.py:199-202)
        bucket_rows = -(-bucket_rows // (256 * mesh[1])) * (256 * mesh[1])
    batcher = ClusterBatcher(
        ds, psize=psize, batch_size=args.batch_size, bit_width=bit_width,
        seed=args.rnd_seed, bucket_rows=bucket_rows, precalc=args.use_pp,
        partition_method=args.partition_method, cache_dir=args.cache_dir,
    )
    print(
        f"[t] partition+pack ({batcher.partition_method}): {time.perf_counter() - t0:.1f}s; "
        f"{len(batcher)} batches/epoch, shape buckets {batcher.buckets()}"
    )
    if args.regular:
        model = "gin" if args.run_GIN else "sage"
        eng = BaselineEngine(
            feat_dim=batcher.feat_dim, num_classes=ds.num_classes, model=model,
            hidden=args.hidden, num_layers=args.num_layers, seed=args.rnd_seed,
            device=device,
        )
        with _profiled(args.profile_dir, device):
            if args.mode == "mega":
                stats = eng.run_epochs_mega(batcher, ds, **timed)
            elif args.mode == "fused":
                stats = eng.run_epochs_fused(batcher, ds, **timed)
            else:
                stats = eng.run_epochs(batcher, ds, resident=args.resident, **timed)
        evaluate = functools.partial(eng.evaluate, batcher, ds)
        evaluate_f1 = functools.partial(eng.evaluate_f1, batcher, ds)
    elif mesh:
        # JAX cli.py:235-248: the flags the mesh engine does not read
        for flag, name in ((args.resident, "--resident"), (args.mode != "step", "--mode"),
                           (args.fmt != "digits", "--fmt"), (args.timing_split, "--timing-split"),
                           (args.quant_in_loop, "--quant-in-loop")):
            if flag:
                print(f"warning: {name} has no effect with --mesh (the mesh engine picks "
                      "mega-per-shard automatically)", file=sys.stderr)
        n_dev = mesh[0] * mesh[1]
        eng = MeshEngine(
            feat_dim=batcher.feat_dim, num_classes=ds.num_classes, dp=mesh[0], sp=mesh[1], model=model,
            bit_width=bit_width, hidden=hidden, num_layers=num_layers, seed=args.rnd_seed, shifts=shifts,
            zerotile_jump=args.zerotile_jump,
            devices=None if device.type == "cuda" and device.index is None else [device] * n_dev,
        )
        if ck_ws is not None:
            eng.set_float_weights(ck_ws)
        with _profiled(args.profile_dir, device):
            stats = eng.run_epochs(batcher, **timed)
        print(f"mesh dp={mesh[0]} sp={mesh[1]}: bucket modes {eng.modes}")
        evaluate = functools.partial(eng.evaluate, batcher)
        evaluate_f1 = functools.partial(eng.evaluate_f1, batcher)
    else:
        eng = QGTCEngine(
            feat_dim=batcher.feat_dim, num_classes=ds.num_classes, model=model,
            bit_width=bit_width, hidden=hidden, num_layers=num_layers,
            zerotile_jump=args.zerotile_jump, fmt=args.fmt, seed=args.rnd_seed,
            device=device, shifts=shifts,
        )
        if ck_ws is not None:
            eng.set_float_weights(ck_ws)
        with _profiled(args.profile_dir, device):
            if mode == "quant-in-loop":
                stats = eng.run_epochs_quant_in_loop(batcher, **timed)
            elif mode == "mega":
                stats = eng.run_epochs_mega(batcher, **timed)
            elif mode == "fused":
                stats = eng.run_epochs_fused(batcher, **timed)
            else:
                stats = eng.run_epochs(batcher, resident=args.resident, **timed)
        # the logits of the engine that ran (quant-in-loop's equal the step engine's)
        eval_mode = mode if mode in ("fused", "mega") else "step"
        evaluate = functools.partial(eng.evaluate, batcher, mode=eval_mode)
        evaluate_f1 = functools.partial(eng.evaluate_f1, batcher, mode=eval_mode)
    record = dict(
        dataset=ds.name, bit_width=bit_width, model=model,
        engine=f"{'regular' if args.regular else 'qgtc'}-{mode}", fmt=args.fmt,
        psize=psize, batch_size=args.batch_size, n_epochs=args.n_epochs,
        zerotile_jump=args.zerotile_jump, resident=args.resident, mode=args.mode, mesh=args.mesh,
        use_pp=args.use_pp, bucket_rows=bucket_rows, partition_method=batcher.partition_method,
        sync_every_epoch=args.sync_every_epoch, device=str(device), device_name=device_name,
        weights=args.weights,
    )
    if mesh and not args.regular:
        record["engine"], record["mesh_modes"] = f"qgtc-mesh-dp{mesh[0]}-sp{mesh[1]}", eng.modes
    elif args.quant_in_loop:
        record["quant_in_loop"] = True
    elif mode == "mega":
        record["buckets"] = eng.mega_buckets
    if args.zerotile_jump:
        # the reference's tile counters (print_counter, kernel.h:17-28), a
        # host-side sum of the maps shipped with the batches
        processed, total = batcher.tile_counts()
        record["tiles_total"], record["tiles_processed"] = total, processed
        print(f"zero-tile: processed {processed}/{total} (jumped {1 - processed / max(total, 1):.1%})")
    if args.timing_split and not (mesh and not args.regular):
        # the split of the engine --mode chose (JAX cli.py:413-440)
        if mode == "step":
            half = max(args.n_epochs // 2, 2)
            both = eng.run_epochs(batcher, n_epochs=half, resident=False).avg_ms
            compute = eng.run_epochs(batcher, n_epochs=half, resident=True).avg_ms
            transfer = max(both - compute, 0.0)
        else:  # staged on the device: the epoch is compute, the copies are timed alone
            compute, transfer = stats.avg_ms, eng.measure_transfer_ms(batcher)
        record["transfer_ms"], record["compute_ms"] = transfer, compute
        print(f"timing split ({mode}): transfer {transfer:.2f} ms, compute {compute:.2f} ms per epoch")
    if args.eval_accuracy:
        _accuracy(record, evaluate, evaluate_f1, ds)
    return _emit(record, stats, args)


def _parse_mesh(parser, text: Optional[str]) -> Optional[Tuple[int, int]]:
    """``--mesh DP,SP`` -> (dp, sp); anything else stops with exit 2, as the
    JAX CLI (``cli.py:193-198``)."""
    if text is None:
        return None
    try:
        dp, sp = (int(v) for v in text.split(","))
    except ValueError:
        dp = sp = 0
    if dp < 1 or sp < 1:
        parser.error(f"bad --mesh {text!r}; expected DP,SP")
    return dp, sp


def _refuse_combinations(parser, args, mode: str) -> None:
    """Stop on a flag the chosen cluster engine would not honour."""
    if args.regular:
        for flag, name in ((args.zerotile_jump, "--zerotile_jump"), (args.fmt != "digits", "--fmt"),
                           (args.quant_in_loop, "--quant-in-loop"), (args.timing_split, "--timing-split"),
                           (args.weights, "--weights")):
            if flag:
                parser.error(f"{name} is the quantized engine's option")
    if args.fmt != "digits" and mode != "step":
        parser.error(f"{mode} mode requires fmt='digits'")
    if mode != "step" and args.resident:
        parser.error("--resident is the step modes' option; the fused, quant-in-loop "
                     "and mega modes always stage their buckets on the device")


@contextlib.contextmanager
def _profiled(profile_dir, device: torch.device):
    """A ``torch.profiler`` trace of the block (the timed epochs), written
    as ``trace.json`` (Chrome trace format) into ``profile_dir``; nothing
    without one."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        yield
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"profile: {path}")


def _accuracy(record: dict, evaluate, evaluate_f1, ds) -> None:
    record["accuracy"] = evaluate(ds.labels)
    print(f"accuracy: {record['accuracy']:.4f}")
    if ds.multilabels is not None:
        record.update(evaluate_f1(ds.multilabels))
        print(f"F1-mic: {record['f1_micro']:.4f}, F1-mac: {record['f1_macro']:.4f}")


def _emit(record: dict, stats, args) -> int:
    """The one tail every engine shares (JAX ``cli.py:454-467``): the
    reference's ``Avg. Epoch`` line (``main_qgtc.py:157-159``), then the
    record as one JSON line, also appended to ``--json-out``."""
    print(f"Avg. Epoch: {stats.avg_ms:.3f} ms")
    record["avg_epoch_ms"] = stats.avg_ms
    record["epoch_ms"] = stats.epoch_ms
    record["launch_sync_ms"] = stats.launch_sync_ms
    print(write_json_line(args.json_out, record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
