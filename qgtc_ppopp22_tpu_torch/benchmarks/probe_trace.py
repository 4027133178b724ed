"""Where a redesigned probe's CTA spends its cycles, on the card: the
probe's source (``csrc/grid_overhead.cu`` for P3b ``kdot``,
``csrc/exp_packmm_packed.cu`` for P1b's packed output) built again with
``-DPROBE_TRACE=1``, so that thread 0 of each CTA adds ``clock64`` spans of
the shared ring loop (``csrc/probe_ring.cuh``) to a device array: the
waits for a step's copies, the barriers, the issue of a step's copies,
the steps' MMAs (body), the transposes (prep) and the whole loop. Runs
P3b at its study's rows (pn 2048 x 50 batches, oc 48, K 0, 1 and 2) and
P1b at JAX's first row (1-bit 4096² x 16, tm 4096) and at 4096² x 64
(group 256), each on its default plan, and prints the card's name and
power limit, then per row the mean over the CTAs of each span in
thousands of cycles and per step in cycles. The traced build is a
diagnostic: the kernels the port runs are built without the flag, and
thread 0's view is one warp's. Needs a CUDA device and ``nvcc``.

Usage::

    python -m qgtc_ppopp22_tpu_torch.benchmarks.probe_trace
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import numpy as np
import torch

SPANS = ("wait for the step's copies", "barrier", "issue", "body (MMAs)", "prep (transpose)", "loop")
TRACE_CTAS, TRACE_SPANS = 8192, 8  # csrc/probe_ring.cuh


def traced_library(source: str):
    """``csrc/<source>`` built with the trace, as its own shared library."""
    from qgtc_ppopp22_tpu_torch.ops import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _build.BUILD_DIR / f"libprobe_trace_{source.split('.')[0]}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-DPROBE_TRACE=1", "-shared", "-o", str(out),
           str(_build.CSRC / source)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stderr}")
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    if source == "grid_overhead.cu":
        lib.qgtc_kdot.argtypes = [p, p, p] + [i] * 7 + [p]
        lib.qgtc_kdot.restype = i
    else:
        lib.qgtc_exp_packedout.argtypes = [p, p, p] + [i] * 10 + [p]
        lib.qgtc_exp_packedout.restype = i
    lib.qgtc_probe_trace.argtypes = [p, i]
    lib.qgtc_probe_trace.restype = i
    return lib


def traced(lib, run, ctas: int, steps: float):
    """One traced call of ``run`` (after one untraced warm-up) -> {span:
    (mean kcycles a CTA, mean cycles a step)} over its first ``ctas`` CTAs."""
    buf = np.zeros(TRACE_CTAS * TRACE_SPANS, np.uint64)
    run()
    torch.cuda.synchronize()
    if lib.qgtc_probe_trace(buf.ctypes.data, 1):
        raise RuntimeError("qgtc_probe_trace failed")
    run()
    torch.cuda.synchronize()
    if lib.qgtc_probe_trace(buf.ctypes.data, 1):
        raise RuntimeError("qgtc_probe_trace failed")
    t = buf.reshape(TRACE_CTAS, TRACE_SPANS)[:min(ctas, TRACE_CTAS)].astype(np.float64)
    return {name: (t[:, i].mean() / 1e3, t[:, i].mean() / steps) for i, name in enumerate(SPANS)}


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("probe_trace: no CUDA device", file=sys.stderr)
        return 1
    from qgtc_ppopp22_tpu_torch.benchmarks import exp_packmm as ep
    from qgtc_ppopp22_tpu_torch.benchmarks import grid_overhead_study as go
    from qgtc_ppopp22_tpu_torch.benchmarks.gemm_times import card_line

    dev = torch.device("cuda")
    print(f"card: {card_line()}")
    rows = []
    lib = traced_library("grid_overhead.cu")
    pn, B = go.KDOT_SHAPE
    gen = torch.Generator(device=dev).manual_seed(0)
    x = go.random_x(B, pn, gen, dev)
    s = torch.randint(-128, 128, (pn, pn), dtype=torch.int8, device=dev, generator=gen)
    untraced = go.library
    go.library = lambda: lib
    try:
        for K in (0, 1, 2):
            plan = go.kdot_plan(pn, 48, K)
            steps = -(-pn // plan.rows // plan.cl) * (pn // go.K_STEP)
            rows.append((f"P3b kdot pn {pn} B {B} K {K} oc 48 ({plan})",
                         traced(lib, lambda K=K, pl=plan: go.kdot(x, s, 48, K, _plan=pl), B * plan.cl, steps)))
    finally:
        go.library = untraced
    lib = traced_library("exp_packmm_packed.cu")
    rng = np.random.default_rng(0)
    untraced = ep.library
    ep.library = lambda: lib
    try:
        for M, K, N, bits, tm, group in ((4096, 4096, 16, 1, 4096, 0), (4096, 4096, 64, 1, 4096, 256)):
            qa, _, b = ep.operands(M, K, N, bits, rng, dev)
            words = torch.from_numpy(ep.pack_rows_np(qa, bits, group or tm)[None]).to(dev)
            plan = ep.packedout_plan(M, K, N, bits, group or tm)
            steps = K // plan.depth / plan.splits
            rows.append((f"P1b {bits}-bit A[{M}x{K}] x B[{K}x{N}] tm {tm} group {group} ({plan})",
                         traced(lib, lambda w=words, b=b: ep.packmm_exp_packedout(w, b, bits, tm, group),
                                plan.grid[0] * plan.grid[1] * plan.grid[2], steps)))
    finally:
        ep.library = untraced
    for what, spans in rows:
        print(what)
        for name, (kcyc, per_step) in spans.items():
            print(f"  {name}: {kcyc:.1f} kcycles a CTA, {per_step:.0f} cycles a step")
    return 0


if __name__ == "__main__":
    sys.exit(main())
