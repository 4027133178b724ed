"""The mega epoch's floor on the H100: bytes and operations per batch.

    python -m qgtc_ppopp22_tpu_torch.benchmarks.roofline [--datasets ogbn-arxiv] [--bits 1 2 4 8] \\
        [--models gcn gin] [--probe | --hbm-gbps G --int8-tops T --l2-mb L] [--measured-csv F] \\
        [--device cuda|cpu] [--csv F]

The counterpart of the JAX repository's ``benchmarks/roofline.py``, rebuilt
for this card: that script models a TPU (every width padded to 128 MXU
lanes, VMEM residency tiers, v5e rates, TPU times). Here, per batch of
each dataset's cluster batches, for the 3-layer GCN (hidden 16) and GIN
(hidden 64) chains of ``models/qmodels.py``:

* **operations**: 2 M N K for every GEMM of the chain in its order (GCN:
  update, then aggregate, per layer; GIN: aggregate X, then update and
  aggregate, then the last update), on the model's real widths (features,
  hidden, classes; M the bucket's rows), counted once whatever the bit
  width (up to 8 bits is one int8 pass on any implementation). An
  aggregation counts only the batch's occupied (row chunk x column block)
  blocks where the bucket takes the compacted schedule, which
  ``runtime.mega_zero_tile_gate`` decides as the engine does;
* **bytes**: K1's staged operands read once (the packed ``a_words``, X's
  digit planes or its plane of byte levels, the weights' blob of
  ``fused_model.pack_mega_weights``, one a bucket) and the logits' real
  extents [num_nodes, classes] in float32 written once;
* **floor** per batch = max(bytes / HBM rate, operations / int8 rate),
  the epoch's floor their sum, twice: on the H100 SXM's data-sheet rates
  (3.35 TB/s, 1,979 TOP/s int8) and on rates measured on the card by
  ``--probe`` (a device copy of 1 GiB, the best ``torch._int_mm`` and bf16
  ``torch.matmul`` of a 8192 square), or passed in off the card. No rate
  defaults to a measured one.

Columns: JAX's (``dataset, model, bits, batches, hbm_mb_epoch,
mxu_gmacs_epoch`` (G multiply-adds needed), ``hbm_floor_ms, mxu_floor_ms,
floor_ms, measured_ms, measured_over_floor, bound``), then ``k1_gmacs_epoch``
(the multiply-adds K1's plan computes: every digit plane, the padded
columns; empty where K1 refuses a bucket), ``k1_refused`` (buckets K1's plan
refuses, run by the fused loop), ``compact_buckets``, the same floor on the
measured rates (``floor_ms_card``, ``measured_over_floor_card``,
``bound_card``), ``fits_l2`` (the epoch's staged bytes below the card's L2:
back-to-back epochs can then read them from L2, and the byte floor is not a
floor) and ``card``. ``measured_ms`` comes from the port's own
``run_all`` CSV (``--measured-csv``: its mega rows), never from
``results/epochs_matrix.csv`` (TPU times). No CSV is written unless asked.
"""

from __future__ import annotations

import argparse
import csv as csv_mod
import sys
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from qgtc_ppopp22_tpu_torch.bench import study_device
from qgtc_ppopp22_tpu_torch.graph import ClusterBatcher, load_dataset
from qgtc_ppopp22_tpu_torch.graph.datasets import DEFAULT_PSIZE
from qgtc_ppopp22_tpu_torch.ops import fused_model
from qgtc_ppopp22_tpu_torch.ops.bitpack import LANE, num_digits, round_up
from qgtc_ppopp22_tpu_torch.runtime import QGTCEngine, mega_block_occ, mega_zero_tile_gate, plan_mega_shards
from qgtc_ppopp22_tpu_torch.utils.metrics import write_csv

DATASHEET = {"hbm": 3.35e12, "int8": 1979e12, "bf16": 989e12}  # H100 SXM: bytes/s, dense operations/s
DATASETS = ("Proteins", "artist", "soc-BlogCatalog", "ppi", "ogbn-arxiv", "reddit", "ogbn-products")
MODELS = ("gcn", "gin")


def chain_gemms(model: str, m: int, dims: Sequence[int]) -> list:
    """``[(kind, M, K, N)]`` of one batch's chain in ``models/qmodels.py``'s
    order: ``dims`` = [features, hidden..., classes], ``m`` the rows."""
    n = len(dims) - 1
    out = []
    if model == "gcn":
        for l in range(n):
            out += [("update", m, dims[l], dims[l + 1]), ("aggregate", m, m, dims[l + 1])]
    elif model == "gin":
        out.append(("aggregate", m, m, dims[0]))
        for l in range(n - 1):
            out += [("update", m, dims[l], dims[l + 1]), ("aggregate", m, m, dims[l + 1])]
        out.append(("update", m, dims[n - 1], dims[n]))
    else:
        raise ValueError(model)
    return out


def chain_ops(model: str, m: int, dims: Sequence[int], agg_share: float = 1.0) -> float:
    """Operations of one batch's chain (2 M N K a GEMM), the aggregations
    scaled by the share of A's blocks they visit."""
    return sum(2 * M * K * N * (agg_share if kind == "aggregate" else 1.0)
               for kind, M, K, N in chain_gemms(model, m, dims))


def k1_ops(geo: "fused_model.MegaPlan", model: str, agg_share: float) -> float:
    """Operations of one batch as K1's plan computes them: each GEMM over
    the padded columns it computes (``MegaPlan.widths``, X's padded width)
    and every digit-plane pair, the aggregations over the visited share."""
    nd_h, nd_w, _, nd_xd, planes, qws, kins = fused_model._k1_dims(geo, model)
    pn, gin = geo.pn, model == "gin"
    agg = sum(2 * pn * pn * w * nd_h for w in planes)
    if gin:
        agg += 2 * pn * pn * geo.xp * nd_xd
    lhs = [nd_h] * len(kins) if gin else [nd_xd] + [nd_h] * (len(kins) - 1)
    upd = sum(2 * pn * k * w * nd * nd_w for k, w, nd in zip(kins, geo.widths, lhs))
    return agg * agg_share + upd


def probe(device: torch.device, reps: int = 20) -> dict:
    """Rates measured on the card: HBM bytes/s from a device copy of 1 GiB
    (bytes read plus written over the best time), and the best int8
    ``torch._int_mm`` (B row- or column-major, the faster) and bf16
    ``torch.matmul`` of a 8192 square, in operations/s (2 N^3 over the best
    time); CUDA events around each call."""
    if device.type != "cuda":
        raise RuntimeError("the probe measures the card; off it pass the rates in")

    def best_ms(fn):
        fn()
        torch.cuda.synchronize(device)
        t = float("inf")
        for _ in range(reps):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            t = min(t, e0.elapsed_time(e1))
        return t

    nb = 1 << 30
    src = torch.ones(nb, dtype=torch.uint8, device=device)
    dst = torch.empty_like(src)
    hbm = 2 * nb / (best_ms(lambda: dst.copy_(src)) * 1e-3)
    del src, dst
    n = 8192
    g = torch.Generator(device=device).manual_seed(0)
    a8 = torch.randint(-128, 128, (n, n), dtype=torch.int8, device=device, generator=g)
    b8 = torch.randint(-128, 128, (n, n), dtype=torch.int8, device=device, generator=g)
    b8c = b8.t().contiguous().t()  # the same B column-major: cuBLASLt's int8 layout
    int8 = 2 * n ** 3 / (min(best_ms(lambda: torch._int_mm(a8, b)) for b in (b8, b8c)) * 1e-3)
    ab, bb = a8.to(torch.bfloat16), b8.to(torch.bfloat16)
    bf16 = 2 * n ** 3 / (best_ms(lambda: torch.matmul(ab, bb)) * 1e-3)
    return {"hbm": hbm, "int8": int8, "bf16": bf16}


def bucket_work(batches, model: str, bits: int, eng: QGTCEngine) -> dict:
    """One bucket's per-batch bytes and operations (needed and K1's), its
    staged bytes, K1's refusal and the schedule the engine's gate gives it."""
    pn, xshape = batches[0].padded_nodes, batches[0].bit_X.shape
    levels = num_digits(bits) == 2
    x_bytes = (1 if levels else num_digits(bits)) * round_up(xshape[0], LANE) * round_up(xshape[1], LANE)
    cfg = eng.cfg
    dims = [cfg.in_dim] + [cfg.hidden] * (cfg.num_layers - 1) + [cfg.out_dim]
    refused, geo = None, None
    try:
        geo = plan_mega_shards(batches, lambda _d: eng.weights, [(eng.device, slice(None))], model=model,
                               clamp_bits=eng.clamp_bits, shifts=None, cfg=cfg)[0]
        fused_model.fused_model_plan(geo, model)  # the card's launch plan: its shared memory
    except ValueError as e:
        refused = f"{type(e).__name__}: {e}"
    form = geo.form if geo is not None else ("signed" if levels and all(
        w.shape[1] < w.padded_cols for w in eng.weights) else "digits")
    mw = fused_model.pack_mega_weights(eng.weights, form)
    blob = mw.blob.numel() + (0 if mw.corr is None else mw.corr.numel() * 4)
    chunk = next(c for c in (512, 256) if pn % c == 0)
    occ = [mega_block_occ(b.a_words.numpy(), chunk, fused_model.mega_colblock(pn)) for b in batches]
    gate = mega_zero_tile_gate(None, float(1.0 - np.mean(occ)), pn, bits, None)
    out = dict(bytes=[], ops=[], k1=[], staged=0, refused=refused, compact=gate == "compact")
    for b, o in zip(batches, occ):
        share = float(o.mean()) if gate == "compact" else 1.0
        staged = b.a_words.numel() * 4 + x_bytes + blob / len(batches)
        out["staged"] += staged
        out["bytes"].append(staged + b.num_nodes * cfg.out_dim * 4)
        out["ops"].append(chain_ops(model, pn, dims, share))
        out["k1"].append(None if refused else k1_ops(geo, model, share))
    return out


def floors(work: list, rates: dict) -> tuple:
    """(floor ms, byte floor ms, operation floor ms) of the epoch."""
    by = [x for w in work for x in w["bytes"]]
    ops = [x for w in work for x in w["ops"]]
    per_batch = sum(max(b / rates["hbm"], o / rates["int8"]) for b, o in zip(by, ops))
    return per_batch * 1e3, sum(by) / rates["hbm"] * 1e3, sum(ops) / rates["int8"] * 1e3


def dataset_rows(ds, batcher: ClusterBatcher, bits: Sequence[int], models: Sequence[str], card: str,
                 measured: Optional[Dict[tuple, float]] = None, rates: Optional[dict] = None,
                 l2_bytes: Optional[int] = None) -> list:
    """The rows of one dataset's batches: every model x width."""
    measured = measured or {}
    groups: dict = {}
    for b in batcher.batches:
        groups.setdefault((b.padded_nodes, b.bit_X.shape[1]), []).append(b)
    out = []
    for model in models:
        for bw in bits:
            eng = QGTCEngine(feat_dim=batcher.feat_dim, num_classes=ds.num_classes, model=model, bit_width=bw,
                             device="cpu")
            work = [bucket_work(bs, model, bw, eng) for bs in groups.values()]
            floor, hbm_ms, ops_ms = floors(work, DATASHEET)
            nbytes = sum(x for w in work for x in w["bytes"])
            ops = sum(x for w in work for x in w["ops"])
            k1 = [x for w in work for x in w["k1"]]
            meas = measured.get((ds.name, model, bw))
            row = dict(dataset=ds.name, model=model, bits=bw, batches=len(batcher.batches),
                       hbm_mb_epoch=round(nbytes / 1e6, 3), mxu_gmacs_epoch=round(ops / 2e9, 4),
                       hbm_floor_ms=round(hbm_ms, 5), mxu_floor_ms=round(ops_ms, 5), floor_ms=round(floor, 5),
                       measured_ms=meas, measured_over_floor=round(meas / floor, 2) if meas else None,
                       bound="operations" if ops_ms > hbm_ms else "bytes",
                       k1_gmacs_epoch=None if None in k1 else round(sum(k1) / 2e9, 4),
                       k1_refused=sum(w["refused"] is not None for w in work),
                       compact_buckets=sum(w["compact"] for w in work),
                       floor_ms_card=None, measured_over_floor_card=None, bound_card=None, fits_l2=None, card=card)
            if rates is not None:
                f_card, hbm_c, ops_c = floors(work, rates)
                row.update(floor_ms_card=round(f_card, 5),
                           measured_over_floor_card=round(meas / f_card, 2) if meas else None,
                           bound_card="operations" if ops_c > hbm_c else "bytes")
            if l2_bytes is not None:
                row["fits_l2"] = sum(w["staged"] for w in work) < l2_bytes
            out.append(row)
            print(row, flush=True)
    return out


def read_measured(path: str) -> Dict[tuple, float]:
    """``{(dataset, model, bits): epoch_ms}`` of a ``run_all`` CSV's timed
    quantized mega rows."""
    out = {}
    with open(path) as f:
        for r in csv_mod.DictReader(f):
            if r["engine"] == "qgtc" and r["mode"] == "mega" and r["epoch_ms"] and not r.get("not_run"):
                out[(r["dataset"], r["model"], int(r["bits"]))] = float(r["epoch_ms"])
    return out


def rows(datasets: Sequence[str] = ("ogbn-arxiv",), bits: Sequence[int] = (1, 2, 4, 8),
         models: Sequence[str] = MODELS, batch_size: int = 20, do_probe: bool = False,
         rates: Optional[dict] = None, l2_bytes: Optional[int] = None, measured: Optional[dict] = None,
         device="cuda", csv: Optional[str] = None) -> list:
    """The roofline over ``datasets``. ``do_probe`` measures the rates and
    reads the L2 size on the card (printed with the card); otherwise
    ``rates`` / ``l2_bytes`` are the caller's, or absent."""
    dev, card = study_device(device)
    if do_probe:
        rates = probe(dev)
        l2_bytes = torch.cuda.get_device_properties(dev).L2_cache_size
        print(f"roofline: measured HBM {rates['hbm'] / 1e9:.1f} GB/s, int8 {rates['int8'] / 1e12:.1f} TOP/s, "
              f"bf16 {rates['bf16'] / 1e12:.1f} TFLOP/s, L2 {l2_bytes / 2 ** 20:.1f} MiB [{card}]", flush=True)
    out = []
    for name in datasets:
        ds = load_dataset(name)
        it = ClusterBatcher(ds, psize=DEFAULT_PSIZE.get(name, 1500), batch_size=batch_size, bit_width=2,
                            cache_dir="./datasets")
        out += dataset_rows(ds, it, bits, models, card, measured, rates, l2_bytes)
        if csv:
            write_csv(csv, out, list(out[0]))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--datasets", nargs="+", default=["ogbn-arxiv"])
    p.add_argument("--bits", nargs="+", type=int, default=[1, 2, 4, 8])
    p.add_argument("--models", nargs="+", choices=MODELS, default=list(MODELS))
    p.add_argument("--batch-size", type=int, default=20)
    p.add_argument("--probe", action="store_true", help="measure the rates and the L2 size on the card")
    p.add_argument("--hbm-gbps", type=float, default=None, help="off the card: the HBM rate to use, GB/s")
    p.add_argument("--int8-tops", type=float, default=None, help="off the card: the int8 rate to use, TOP/s")
    p.add_argument("--l2-mb", type=float, default=None, help="off the card: the L2 size to use, MiB")
    p.add_argument("--measured-csv", default=None, help="a run_all CSV of the port (its mega rows)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--csv", default=None)
    args = p.parse_args(argv)
    rates = None
    if args.hbm_gbps is not None or args.int8_tops is not None:
        if args.probe or args.hbm_gbps is None or args.int8_tops is None:
            p.error("pass both --hbm-gbps and --int8-tops, or --probe")
        rates = {"hbm": args.hbm_gbps * 1e9, "int8": args.int8_tops * 1e12}
    l2 = None if args.l2_mb is None else int(args.l2_mb * 2 ** 20)
    measured = read_measured(args.measured_csv) if args.measured_csv else None
    rows(args.datasets, args.bits, args.models, args.batch_size, args.probe, rates, l2, measured, args.device,
         args.csv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
