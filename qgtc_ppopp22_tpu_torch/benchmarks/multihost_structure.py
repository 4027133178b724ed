"""Per-process epoch walls of the multi-process mesh path.

    python -m qgtc_ppopp22_tpu_torch.benchmarks.multihost_structure [--device cuda:0|cpu] [--csv F]

The counterpart of the JAX repository's
``benchmarks/multihost_structure.py``: one run of
``parallel/multihost_worker.py`` in one process, then one in two processes
(``gloo``, a free ``localhost`` port), each process on ``--device`` (by
default ``cuda:0``). Each process runs the worker's two meshes, (dp 2, sp
1), K1 a dp row, and (dp 2, sp 2), the ring, and stages only its
``host_batch_slice`` share of every bucket, so the structure shows as half
the local batches a process at 2 processes, and each process's epoch wall
next to the 1-process one, per mesh. With every
process on one device (``cuda:0`` or ``cpu``) the processes share it, so
the walls show structure, not speed-up. The efficiency of dp over
processes stays an arithmetic model (``parallel/multihost.py``).
"""

from __future__ import annotations

import argparse
import re
import socket
import subprocess
import sys
from pathlib import Path

from qgtc_ppopp22_tpu_torch.parallel.multihost_worker import MESHES
from qgtc_ppopp22_tpu_torch.utils.metrics import write_csv

ROOT = Path(__file__).resolve().parents[2]


def run(nproc: int, device: str, timeout: int = 600) -> list:
    """[(process, dp, sp, epoch wall ms, local batches)] of each process and
    mesh of one run."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, "-m", "qgtc_ppopp22_tpu_torch.parallel.multihost_worker", str(r),
                               str(nproc), str(port), "--device", device], cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(nproc)]
    walls = []
    for r, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=timeout)
        finally:
            p.kill()
        m = re.findall(rf"p{r}: EPOCH-WALL dp=(\d+) sp=(\d+) ms=([0-9.]+) local_batches=(\d+)", out)
        if p.returncode != 0 or out.count(f"p{r}: MESH-EPOCH-OK") != len(MESHES) or len(m) != len(MESHES):
            raise RuntimeError(f"worker {r} of {nproc} failed (exit {p.returncode}):\n{out[-3000:]}")
        walls += [(r, int(dp), int(sp), float(ms), int(nb)) for dp, sp, ms, nb in m]
    return walls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--csv", default=None)
    args = ap.parse_args(argv)
    rows = []
    for nproc in (1, 2):
        for pid, dp, sp, ms, nb in run(nproc, args.device):
            rows.append(dict(nproc=nproc, process=pid, dp=dp, sp=sp, epoch_wall_ms=ms, local_batches=nb,
                             device=args.device))
            print(rows[-1], flush=True)
    for dp, sp in MESHES:
        w1 = next(r["epoch_wall_ms"] for r in rows if (r["nproc"], r["dp"], r["sp"]) == (1, dp, sp))
        w2 = max(r["epoch_wall_ms"] for r in rows if (r["nproc"], r["dp"], r["sp"]) == (2, dp, sp))
        print(f"structure (dp {dp}, sp {sp} a process): 2-process wall {w2:.3f} ms against 1-process {w1:.3f} ms "
              f"({w1 / max(w2, 1e-9):.2f}x), every process on {args.device}")
    if args.csv:
        write_csv(args.csv, rows, list(rows[0]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
