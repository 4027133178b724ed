"""One run of one benchmark cell, on the machine it is started on.

    python3 -m h100bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The run builds the cell's inputs (the traffic
file's graph, the features and weights ``--seed`` draws), sets up the
program (the configuration's entry: batching, staging, the first epoch),
warms up, runs epochs back to back for ``--seconds`` of host time, and
checks the logits of two of them against the plain reference: one of the
first 64, drawn from the seed, and the last. With
``--trace 1`` it then profiles a short stretch of epochs and reports the
per-layer metrics; else the end-to-end ones. The last line of standard
output is one JSON object; the compared numbers, each beside its limit, are
the last lines of standard error and the last key of that object.

A run without the CUDA devices the cell asks for exits 2 and prints no
result; one whose process holds JAX or the JAX package once the window has
closed exits 3 and prints none either.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
CACHE = HERE / "_cache"
# Caches of compilers the program may use: fixed places inside the checkout.
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")

import torch  # noqa: E402

from h100bench import check, devtrace, graphs, spec, work  # noqa: E402

WARMUP_EPOCHS = 20
TRACE_SECONDS = 0.5
KEEP_FROM = 64  # the checked epochs: one of the window's first 64, drawn from the seed, and the last
FORBIDDEN = {"jax", "jaxlib", "flax", "qgtc_ppopp22_tpu"}


def float_weights(cfg: dict, feat_dim: int, classes: int, seed: int, device: torch.device) -> list:
    """The model's float weights for ``seed``, drawn on ``device`` in one call:
    uniform over [0, 2^bits), so the quantized levels cover the whole range."""
    widths = work.dims(cfg, feat_dim, classes)
    shapes = [(widths[l], widths[l + 1]) for l in range(len(widths) - 1)]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(sum(a * b for a, b in shapes), generator=gen, device=device) * float(1 << int(cfg["bit_width"]))
    return [w.view(s) for w, s in zip(torch.split(flat, [a * b for a, b in shapes]), shapes)]


def inputs(cell: dict, seed: int, device: torch.device) -> dict:
    tr, cfg = cell["traffic"], cell["config"]
    indptr, indices = graphs.graph(tr, CACHE)
    feats, labels = graphs.node_data(len(indptr) - 1, int(tr["features"]), int(tr["classes"]), seed)
    return dict(indptr=indptr, indices=indices, features=feats, labels=labels,
                float_weights=float_weights(cfg, int(tr["features"]), int(tr["classes"]), seed, device))


def make_entry(cell: dict, data: dict, device: torch.device, **kw):
    return spec.module("entries", cell["config"]["entry"]).Entry(
        cell["config"], cell["traffic"], data["indptr"], data["indices"], data["features"], data["labels"],
        data["float_weights"], device, CACHE, **kw)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def window(epoch, seconds: float, device: torch.device, keep: int = 0) -> dict:
    """Epochs back to back for ``seconds`` of host time: the host clock from
    the first launch to the final synchronize, and each epoch's time from
    CUDA events recorded on the stream between epochs (the host clock
    around each epoch off the card). Returns them with the outputs of epoch
    ``keep`` (or of the last, in a window that ends before it) and of the
    last epoch."""
    cuda = device.type == "cuda"
    marks, n, kept, outs = [], 0, None, None
    t0 = time.perf_counter()
    while True:
        if cuda:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        else:
            marks.append(time.perf_counter())
        outs = epoch()
        if n == keep:
            kept = outs
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    if cuda:
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
    sync(device)
    t1 = time.perf_counter()
    if cuda:
        per_epoch = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    else:
        marks.append(t1)
        per_epoch = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    return dict(seconds=t1 - t0, epochs=n, epoch_ms=per_epoch, outs=[outs] if kept is None else [kept, outs])


def checked(cell: dict, data: dict, entry, epochs: list, device: torch.device) -> dict:
    """The compared numbers of the outputs of ``epochs`` (each an epoch's),
    after the program's device state is dropped: the reference runs in the
    memory the program held."""
    programs = [dict(entry.per_batch(outs)) for outs in epochs]
    batches = entry.batches
    entry.close()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    cfg = cell["config"]
    ref = spec.module("reference", cfg["reference"]).batch_logits(
        data["indptr"], data["indices"], data["features"], data["float_weights"], cfg, batches, device)
    return check.compare(programs, ref, batches, len(data["indptr"]) - 1, int(cell["traffic"]["classes"]))


def card_line(device: torch.device) -> str:
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[device.index or 0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unreadable"


def breakdown(tr: dict) -> dict:
    ops = sorted(tr["op_s"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in tr["gaps"][:10]]}


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device: torch.device, bench: dict) -> dict:
    """Everything of a run but the look for the chip and the check of the
    loaded modules: the result's fields, with ``checks`` last."""
    cfg, tr = cell["config"], cell["traffic"]
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    data = inputs(cell, seed, device)
    entry = make_entry(cell, data, device)
    print("buckets " + json.dumps([{k: v for k, v in b.items() if k != "index"} for b in entry.buckets]),
          flush=True)
    for _ in range(WARMUP_EPOCHS):
        entry.epoch()
    sync(device)
    spans = dict(entry.spans, setup_s=time.perf_counter() - T_START)
    win = window(entry.epoch, seconds, device, keep=seed % KEEP_FROM)
    traced = None
    if trace and device.type == "cuda":
        traced = devtrace.traced_window(entry.launches, TRACE_SECONDS, device, CACHE / "trace" / f"{cell['name']}.json")
    mem = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    widths = work.dims(cfg, int(tr["features"]), int(tr["classes"]))
    bits, peak = int(cfg["bit_width"]), work.peaks(kind)
    sizes = [len(b) for b in entry.batches]
    ctx = dict(
        spans=spans, window=win, trace=traced, buckets=entry.buckets, peak=peak,
        batch_ops=[work.batch_ops(cfg["model"], n, widths) for n in sizes],
        batch_floor_s=[work.batch_floor_s(cfg["model"], n, widths, bits, peak) for n in sizes] if peak else None,
    )
    metrics = {}
    for m in spec.metrics_for(bench, cell["name"], trace):
        value = spec.module("metrics", m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    numbers = checked(cell, data, entry, win.pop("outs"), device)
    limits = cfg["limits"]
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind, "count": int(cell["chips"]),
           "memory_peak_bytes": int(mem), "card": card_line(device)}
    if traced is not None:
        dev.update(busy_s=traced["busy_s"], window_s=traced["window_s"])
    result = {"correct": check.judge(numbers, limits), "attempted": win["epochs"], "failed": 0,
              "metrics": metrics, "device": dev}
    if traced is not None:
        result["breakdown"] = breakdown(traced)
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    return result


def loaded_forbidden() -> set:
    return {name.split(".")[0] for name in list(sys.modules)} & FORBIDDEN


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = spec.benchmark()
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"needs {cell['chips']} CUDA device(s), found {found}", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed % (1 << 63), args.seconds, bool(args.trace), torch.device("cuda:0"), bench)
    bad = loaded_forbidden()
    if bad:
        print(f"the run loaded {sorted(bad)}: the benchmark may load none of {sorted(FORBIDDEN)}", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
