"""Where a K5 CTA's cycles go, on the card: ``csrc/fused_baseline.cu``
built again with ``-DK5_TRACE=1`` (each CTA adds ``clock64`` spans to a
device array: the consumers' waits for a full slot and their steps, the
producer's waits for a free slot, the group barriers, the first batch's X
conversion, the whole kernel), run over C1-baseline's 75 batches
(``gemm_times.k5_operands``) on ``fused_baseline_plan``'s default and the
plans named on the command line. Prints the card's name and power limit,
then per plan the mean and max over the CTAs of each span, in thousands of
cycles. The traced build is a diagnostic: the kernel the port runs is built
without the flag. Needs a CUDA device and ``nvcc``.

Usage::

    python -m qgtc_ppopp22_tpu_torch.benchmarks.k5_trace [--plan g=1] [--plan g=3] ...
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys

import numpy as np
import torch

SPANS = ("consumer wait for a full slot", "consumer steps", "producer wait for a free slot", None,
         "group barriers", "first batch's X conversion", "kernel")


def traced_library():
    """The traced build of the K5 entry, as its own shared library."""
    from qgtc_ppopp22_tpu_torch.ops import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _build.BUILD_DIR / "libk5_trace.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-DK5_TRACE=1", "-shared", "-o", str(out),
           str(_build.CSRC / "fused_baseline.cu")]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stderr}")
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.qgtc_fused_baseline.argtypes = [p, p, p, p, p, p, p, i, p]
    lib.qgtc_fused_baseline.restype = i
    lib.qgtc_k5_trace.argtypes = [p, i]
    lib.qgtc_k5_trace.restype = i
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--plan", action="append", default=[],
                    help="a forced plan as g=<batches in flight>")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k5_trace: no CUDA device", file=sys.stderr)
        return 1
    from qgtc_ppopp22_tpu_torch.benchmarks.gemm_times import c1_batches, card_line, k5_operands
    from qgtc_ppopp22_tpu_torch.ops import fused_model

    dev = torch.device("cuda")
    ds, batcher = c1_batches()
    a, x, weights = k5_operands(ds, batcher, dev)
    w, pk = weights["C1-baseline"]
    shapes = [tuple(t.shape) for t in w]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lib = traced_library()
    buf = np.zeros(1024 * 8, np.uint64)
    print(f"card: {card_line()}")
    untraced = fused_model.library
    fused_model.library = lambda: lib
    try:
        for spec in [""] + args.plan:
            kw = {k: int(v) for k, v in (item.split("=") for item in spec.split(",") if item)}
            plan = fused_model.fused_baseline_plan(a.shape, x.shape, shapes, sms=sms, **kw)
            fused_model.fused_baseline_epoch(a, x, w, packed=pk, _plan=plan)  # warm
            torch.cuda.synchronize()
            lib.qgtc_k5_trace(buf.ctypes.data, 1)
            fused_model.fused_baseline_epoch(a, x, w, packed=pk, _plan=plan)
            torch.cuda.synchronize()
            if lib.qgtc_k5_trace(buf.ctypes.data, 1):
                raise RuntimeError("qgtc_k5_trace failed")
            t = buf.reshape(1024, 8)[:plan.grid].astype(np.float64) / 1e3
            print(f"K5 C1-baseline {plan}")
            for i, name in enumerate(SPANS):
                if name:
                    print(f"  {name}: mean {t[:, i].mean():.1f}, max {t[:, i].max():.1f} kcycles a CTA")
    finally:
        fused_model.library = untraced
    return 0


if __name__ == "__main__":
    sys.exit(main())
