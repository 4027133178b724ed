"""Does each ring rotation's copy hide under the shard GEMMs beside it?

    python -m qgtc_ppopp22_tpu_torch.benchmarks.ring_overlap [--device cuda:0|cpu] [--csv F]

The JAX repository's ``benchmarks/ring_overlap.py`` asks this of its
``ppermute`` ring on a TPU mesh; here it is asked of the port's ring
(``parallel/sharded.ring_aggregate``: each rotation's copies are issued on
the shards' copy streams before the rotation's GEMMs, ordered by CUDA
events). JAX's shape: n 2048, features 128, hidden 64, classes 128, 2-bit,
adjacency density 0.01, seed 0, integer weight levels drawn with NumPy.
Every mesh runs over one device repeated (``cuda:0`` or ``cpu``), so this
shows the ring's structure, not NVLink: every hop is a copy within one
card's memory. Three parts:

(a) **overlap** (on the card only): one forward under ``torch.profiler``
    at sp 4 on each ring, the dense digit-plane one
    (``sp_gcn_forward_ring``, K3 raw int32 shard GEMMs) and the packed one
    the engines run (``dp_sp_epoch_packed``, K2 raw int32, K3 updates):
    the ring's copies and the K2 / K3 kernels per aggregation, and the
    share of the copies' device time that overlaps a K2 / K3 kernel on
    the compute stream (the profiler's stream timeline);
(b) **link volume** per aggregation per device by JAX's formulas: the
    ring's sp - 1 rotations of rows_loc x hidden int8 against the
    all-gather's whole n x hidden, and beside them the bytes the port's
    ring moves (digit planes padded to 128 columns);
(c) **timing**: host ms per step of ``dp_sp_epoch_step`` at dp 2 x sp 4,
    B 4, ring and gather aggregation, ``STEPS`` steps each
    (``utils/timing.host_bench``).

Every ring's and gather's logits must equal the step engine's
(``models/qmodels.qgcn_forward`` on the packed adjacency, K2 and K3), or
the module raises. Every row carries ``card``. No file is written unless
``--csv`` is given (``results/ring_overlap.txt`` is the JAX package's).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import Optional

import numpy as np
import torch

from qgtc_ppopp22_tpu_torch.bench import study_device
from qgtc_ppopp22_tpu_torch.models.qmodels import qgcn_forward
from qgtc_ppopp22_tpu_torch.ops.bitpack import LANE, num_digits, round_up
from qgtc_ppopp22_tpu_torch.ops.digits import digit_pack
from qgtc_ppopp22_tpu_torch.ops.packmm import pack_rows
from qgtc_ppopp22_tpu_torch.parallel import (dp_sp_epoch_packed, dp_sp_epoch_step, make_mesh, shard_batches,
                                             sp_gcn_forward_ring)
from qgtc_ppopp22_tpu_torch.utils.metrics import write_csv
from qgtc_ppopp22_tpu_torch.utils.timing import host_bench

N, FEAT, HIDDEN, CLASSES, BITS, DENSITY, SEED = 2048, 128, 64, 128, 2, 0.01, 0  # JAX's shape
SP = 4  # the overlap and link-volume mesh: (1, 4)
MESH_T, B_T, STEPS = (2, 4), 4, 10  # the timing mesh (dp, sp), its batches and steps
REPS = 3  # forwards in the overlap's profiler session
GEMM_KERNELS = ("k2_kernel", "k3_kernel")


def operands(n: int = N, device="cpu"):
    """JAX's operands on ``device``: the packed 1-bit adjacency, its digit
    plane, the feature digits and the weights' digits."""
    rng = np.random.default_rng(SEED)
    qa = (rng.random((n, n)) < DENSITY).astype(np.int32)
    qx = rng.integers(0, 4, (n, FEAT)).astype(np.int32)
    qws = [rng.integers(0, 4, s).astype(np.int32) for s in [(FEAT, HIDDEN), (HIDDEN, HIDDEN), (HIDDEN, CLASSES)]]
    qa_t = torch.from_numpy(qa).to(device)
    ws = [digit_pack(torch.from_numpy(w).to(device), BITS) for w in qws]
    return pack_rows(qa_t, 1), digit_pack(qa_t, 1), digit_pack(torch.from_numpy(qx).to(device), BITS), ws


def link_volume(n: int = N, sp: int = SP, hid: int = HIDDEN, bits: int = BITS) -> dict:
    """Bytes per aggregation per device: JAX's formulas
    (``benchmarks/ring_overlap.py:88-103``: int8 digits of the hidden's
    real columns), and the port's ring's hops (its digit planes, padded
    to 128 columns)."""
    rows_loc = n // sp
    hop_port = num_digits(bits) * rows_loc * round_up(hid, LANE)
    return dict(rows_loc=rows_loc, rotations=sp - 1, ring_bytes_per_rotation=rows_loc * hid,
                ring_bytes=(sp - 1) * rows_loc * hid, gather_bytes=n * hid,
                port_ring_bytes_per_rotation=hop_port, port_ring_bytes=(sp - 1) * hop_port)


def _check(what: str, got: torch.Tensor, ref: torch.Tensor, n: int) -> None:
    if not torch.equal(got[:n, :CLASSES].cpu(), ref[:n, :CLASSES].cpu()):
        raise AssertionError(f"ring_overlap: {what} logits != the step engine's")


def _trace_events(fn, reps: int) -> list:
    """(name, category, stream, start us, end us) of every kernel and copy of
    ``reps`` calls of ``fn``, from one profiler session's Chrome trace; the
    session is padded before and after, since a session can lose its first
    or last records, and the padding's events are left out."""
    from torch.profiler import ProfilerActivity, profile

    pad = torch.zeros(1, device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(64):
            pad.add_(1)
        torch.cuda.synchronize()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        for _ in range(64):
            pad.add_(1)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    out = []
    for e in trace.get("traceEvents", []):
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy"):
            stream = e.get("args", {}).get("stream", e.get("tid"))
            out.append((e["name"], e["cat"], stream, float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))))
    return out


def overlap(events: list, aggregations: int) -> dict:
    """The ring's copies (memcpys off the GEMMs' stream) and its K2 / K3
    kernels per aggregation, their device us, and the share of the copies'
    time inside a K2 / K3 kernel's interval on the compute stream."""
    gemms = [e for e in events if e[1] == "kernel" and any(k in e[0] for k in GEMM_KERNELS)]
    if not gemms:
        raise RuntimeError("the profiler recorded no K2 / K3 kernel")
    compute = {e[2] for e in gemms}
    copies = [e for e in events if e[1] == "gpu_memcpy" and e[2] not in compute]
    spans = sorted((e[3], e[4]) for e in gemms)
    merged: list = []
    for s, t in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    copy_us = sum(t - s for _, _, _, s, t in copies)
    hidden = sum(max(0.0, min(t, m1) - max(s, m0)) for _, _, _, s, t in copies for m0, m1 in merged)
    return dict(copies_per_aggregation=len(copies) / aggregations, gemms_per_aggregation=len(gemms) / aggregations,
                copy_streams=len({e[2] for e in copies}), copy_us=round(copy_us, 3),
                gemm_us=round(sum(t - s for s, t in spans), 3),
                overlap_share=round(hidden / copy_us, 4) if copy_us else None)


def rows(device="cuda:0", n: int = N, steps: int = STEPS) -> list:
    """(a), (b) and (c) on ``device`` repeated, each a row; ``n`` the
    adjacency's size (JAX's 2048; smaller in tests)."""
    dev, card = study_device(device)
    one = torch.device("cuda", 0) if dev.type == "cuda" and dev.index is None else dev
    a_packed, a_digits, x, ws = operands(n, one)
    ref = qgcn_forward(a_packed, x, ws, BITS)
    out = []
    # (a) the ring's copies against its GEMMs, one forward of each ring at sp 4
    mesh = make_mesh(1, SP, [one] * SP)
    rings = {"dense ring (K3 raw int32)": lambda: sp_gcn_forward_ring(mesh, a_digits, x, ws, BITS),
             "packed ring (K2 raw int32)": lambda: dp_sp_epoch_packed(
                 mesh, a_packed.words[None], x.digits[None], ws, BITS, x_bits=BITS, x_cols=FEAT).gather(one)[0]}
    for what, fn in rings.items():
        if n % (SP * 256) and "packed" in what:
            continue  # the packed ring shards whole 256-row pack groups
        _check(what, fn(), ref, n)
        row = dict(part="a", what=what, dp=1, sp=SP, card=card)
        if one.type == "cuda":
            for attempt in range(3):  # a profiler session can come back without the kernels' records
                try:
                    row.update(overlap(_trace_events(fn, REPS), 3 * REPS))
                    break
                except RuntimeError:
                    if attempt == 2:
                        raise
        else:
            row["not_run"] = "no CUDA device: the overlap needs the profiler's stream timeline"
        out.append(row)
    # (b) link volume per aggregation per device
    out.append(dict(part="b", what="link volume per aggregation per device (bytes)", dp=1, sp=SP,
                    **link_volume(n), card=card))
    # (c) host ms per step at (2, 4), B 4, ring and gather
    dp, sp = MESH_T
    mesh2 = make_mesh(dp, sp, [one] * (dp * sp))
    a_sh, x_sh = shard_batches(mesh2, torch.stack([a_digits.digits] * B_T), torch.stack([x.digits] * B_T))
    for mode in ("ring", "gather"):
        def step(m=mode):
            return dp_sp_epoch_step(mesh2, a_sh, x_sh, ws, BITS, a_bits=1, x_bits=BITS, agg_mode=m, x_cols=FEAT)

        for i, logits in enumerate(step().gather(one)):
            _check(f"dp_sp_epoch_step {mode} batch {i}", logits, ref, n)
        out.append(dict(part="c", what=f"dp_sp_epoch_step {mode}", dp=dp, sp=sp, batches=B_T, steps=steps,
                        host_ms_per_step=round(host_bench(step, (), steps) * 1e3, 3), card=card))
    for r in out:
        print(r, flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--csv", default=None)
    args = p.parse_args(argv)
    print(f"ring_overlap: GCN {BITS}-bit, n {N}, features {FEAT}, hidden {HIDDEN}, classes {CLASSES}, every mesh "
          f"over {args.device} repeated (structure, not NVLink)")
    out = rows(args.device)
    if args.csv:
        keys = list(dict.fromkeys(k for r in out for k in r))
        write_csv(args.csv, [{k: r.get(k) for k in keys} for r in out], keys)
    return 0


if __name__ == "__main__":
    sys.exit(main())
