"""Device time of the dense integer GEMM kernels built on
``csrc/gemm_core.cuh``: K2 ``packmm`` and K3 ``digitmm`` at the step
engine's C1 shapes (pn = 2560, 2-bit GCN, hidden 16, 40 classes), and
every row of the kernel sweep's Fig. 8a (K2 packed out at 1, 2 and 4
bits, K4 ``packmm_signed`` at 8 bits).

The script calls only what the port has offered since the kernel sweep
(``packmm_to_digits``, ``packmm_to_f32``, ``digitmm_to_digits`` without
a map, ``kernel_sweep.figure_cases``), so two checkouts can be timed
on one card in one command: copy it into the other checkout's
``benchmarks/`` folder and run it from each checkout's root in turns (A,
B, B, A), each run on the kernels that its checkout builds. Operands come
from ``np.random.default_rng(--seed)`` (the dense K loop does not depend
on the data) and the sweep's ``default_rng(0)``.

Prints the card's name and power limit, then one JSON line per row
(``{"tag", "row", "us"}``): the device time per call, the lesser of two
rounds of ``--iters`` calls in one profiler session. Needs a CUDA device.

Usage::

    python -m qgtc_ppopp22_tpu_torch.benchmarks.gemm_times [--tag NAME] [--iters 20]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from qgtc_ppopp22_tpu_torch.benchmarks import kernel_sweep
from qgtc_ppopp22_tpu_torch.ops import digitmm, packmm
from qgtc_ppopp22_tpu_torch.ops.digits import digit_pack
from qgtc_ppopp22_tpu_torch.ops.packmm import pack_rows

PN, FEAT, HIDDEN, CLASSES, BITS = 2560, 128, 16, 40, 2


def c1_calls(seed: int, device) -> dict:
    """The step engine's dense GEMMs at C1's shapes: the aggregation
    A x H (1-bit A, 2-bit H, to digits and, for the last layer, to f32)
    and the update X x W."""
    rng = np.random.default_rng(seed)

    def levels(rows, cols, bits):
        return torch.from_numpy(rng.integers(0, 1 << bits, (rows, cols)).astype(np.int32)).to(device)

    a = pack_rows(levels(PN, PN, 1), 1)
    h16 = digit_pack(levels(PN, HIDDEN, BITS), BITS)
    h40 = digit_pack(levels(PN, CLASSES, BITS), BITS)
    x = digit_pack(levels(PN, FEAT, BITS), BITS)
    w = digit_pack(levels(FEAT, HIDDEN, BITS), BITS)
    return {
        f"packmm_to_digits A[{PN}x{PN}] 1-bit x H[{PN}x{HIDDEN}] 2-bit":
            lambda: packmm.packmm_to_digits(a, h16, BITS),
        f"packmm_to_f32 A[{PN}x{PN}] 1-bit x H[{PN}x{CLASSES}] 2-bit":
            lambda: packmm.packmm_to_f32(a, h40),
        f"digitmm_to_digits X[{PN}x{FEAT}] x W[{FEAT}x{HIDDEN}] 2-bit":
            lambda: digitmm.digitmm_to_digits(x, w, BITS),
    }


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tag", default="", help="label printed on every row")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--seed", type=int, default=3)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("gemm_times: no CUDA device", file=sys.stderr)
        return 1
    from qgtc_ppopp22_tpu_torch.utils.timing import device_times_ms

    dev = torch.device("cuda")
    rows = c1_calls(args.seed, dev)
    for c in kernel_sweep.figure_cases("8a", np.random.default_rng(0), dev):
        kind = "packmm_signed" if c.bits == 8 else "packmm packed"
        rows[f"sweep 8a {kind} bits={c.bits} M=K={c.M} N={c.N}"] = c.run
    fns = {(name, rep): fn for rep in (0, 1) for name, fn in rows.items()}
    dt = device_times_ms(fns, iters=args.iters)
    print(f"card: {card_line()}")
    for name in rows:
        us = min(dt[(name, 0)], dt[(name, 1)]) * 1e3
        print(json.dumps({"tag": args.tag, "row": name, "us": round(us, 2)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
