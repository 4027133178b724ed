"""Kernel microbenchmarks on the card (port of ``benchmarks/kernel_sweep.py``:
the reference's ``2_7c_QGTC_GEMM_INT8.py``, ``5_9_adjmatrix_size.py`` and
``cuBLASGemmEX/`` in one harness).

Sweeps the packed-operand GEMM bit in / bit out (the reference's
``bitMM2Bit_profile`` op: A arrives M-packed, the epilogue requantizes and
repacks) over the paper's shapes and bit widths, and reports TFLOP/s under
the reference's ``2*M*N*K`` convention, beside ``torch._int_mm`` on int8
operands (the cuBLAS GemmEx INT8 role). Figures:

* ``8a``: M = K in {1024, 2048, 4096}, N in {16, 32, 64}, bits 1/2/4/8
  (the 8-bit rows take a :class:`PreparedRHS` and store N columns);
* ``8c``: 1-bit, the same M = K, N from 16 to 1024;
* ``int8``: ``torch._int_mm`` on 0/1 A and 0..15 B at the 8a shapes;
* ``profile``: 1-bit, M = K = 32768, N in {16, 64}; A is drawn directly in
  the word domain (random words are a random 0/1 matrix's packed form).

Operands come from ``np.random.default_rng(0)`` in the JAX sweep's draw
order; packing and ``prepare_rhs`` stay outside the timed call, and the
time is the call's device time (``utils/timing.device_times_ms``). Rows go
to stdout and, with ``--csv``, to a CSV file (``bits, M, K, N, us,
tflops``). Needs a CUDA device; there is no CPU fallback.

Usage::

    python -m qgtc_ppopp22_tpu_torch.benchmarks.kernel_sweep --figure 8a [--csv out.csv]
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from qgtc_ppopp22_tpu_torch.ops import _gemm
from qgtc_ppopp22_tpu_torch.ops.bitgemm import flops_convention
from qgtc_ppopp22_tpu_torch.ops.digits import DigitTensor, digit_pack
from qgtc_ppopp22_tpu_torch.ops.packmm import (
    PackedTensor,
    PreparedRHS,
    pack_rows,
    packed_signed,
    packmm_plain,
    packmm_to_packed,
    prepare_rhs,
)

FIGURES = ("8a", "8c", "int8", "profile")
MK = (1024, 2048, 4096)


@dataclasses.dataclass
class Case:
    """One row of a figure: its operands, on the device they were built
    for, and the call that is timed."""

    bits: int
    M: int
    K: int
    N: int
    a: Union[PackedTensor, torch.Tensor]  # int8 [M, K] for the int8 figure
    b: Union[DigitTensor, PreparedRHS, torch.Tensor]
    out_cols: Optional[int] = None
    int8: bool = False

    def run(self):
        """The timed call: ``packmm_to_packed`` (or ``torch._int_mm``)."""
        if self.int8:
            return torch._int_mm(self.a, self.b)
        return packmm_to_packed(self.a, self.b, self.bits, out_cols=self.out_cols)

    def plain(self, rows: Optional[int] = None):
        """The plain version of :meth:`run` on the same operands; over the
        first ``rows`` rows of A only (whole 256-row groups) if given."""
        if self.int8:
            return _gemm.plain_product(self.a[:rows], self.b).to(torch.int32)
        a = self.a
        if rows is not None:
            words = a.words[:, : rows // a.rows_per_word]
            a = PackedTensor(words=words, shape=(rows, a.shape[1]), bits=a.bits)
        return packmm_plain(a, self.b, self.bits, out_form="packed", out_cols=self.out_cols)

    def row(self, ms: float) -> Dict:
        """The CSV row for a device time of ``ms`` per call."""
        t = ms * 1e-3
        tflops = flops_convention(self.M, self.N, self.K) / t / 1e12
        return dict(bits=self.bits, M=self.M, K=self.K, N=self.N, us=round(t * 1e6, 2),
                    tflops=round(tflops, 3))


def shape_case(M: int, K: int, N: int, bits: int, rng, device) -> Case:
    """A ``bench_shape`` row: random levels, A M-packed, B as digit planes,
    or as a PreparedRHS storing N columns for 5-8 bits (weights are
    prepared once, outside the timed region, as the reference packs them
    before its loop)."""
    qa = rng.integers(0, 1 << bits, (M, K)).astype(np.int32)
    qb = rng.integers(0, 1 << bits, (K, N)).astype(np.int32)
    a = pack_rows(torch.from_numpy(qa).to(device), bits)
    b = digit_pack(torch.from_numpy(qb).to(device), bits)
    if packed_signed(bits):
        return Case(bits, M, K, N, a, prepare_rhs(b), out_cols=N)
    return Case(bits, M, K, N, a, b)


def int8_case(M: int, K: int, N: int, rng, device) -> Case:
    """A ``bench_int8`` row: int8 0/1 A and 0..15 B for ``torch._int_mm``."""
    a = torch.from_numpy(rng.integers(0, 2, (M, K)).astype(np.int8)).to(device)
    b = torch.from_numpy(rng.integers(0, 16, (K, N)).astype(np.int8)).to(device)
    return Case(8, M, K, N, a, b, int8=True)


def profile_case(M: int, K: int, N: int, bits: int, rng, device) -> Case:
    """A ``bench_profile_shape`` row: 1-bit A drawn as random words, so
    the dense M x K levels never exist on the host."""
    if bits != 1:
        raise ValueError(f"the profile shapes are 1-bit, got {bits}")
    w = rng.integers(-(2**31), 2**31, (1, M // 32, K), dtype=np.int64).astype(np.int32)
    a = PackedTensor(words=torch.from_numpy(w).to(device), shape=(M, K), bits=bits)
    qb = rng.integers(0, 1 << bits, (K, N)).astype(np.int32)
    return Case(bits, M, K, N, a, digit_pack(torch.from_numpy(qb).to(device), bits))


def figure_cases(figure: str, rng, device="cuda") -> List[Case]:
    """Every row of ``figure``, in the JAX sweep's order (and so its draws)."""
    if figure == "8a":
        return [shape_case(mk, mk, n, bits, rng, device)
                for bits in (1, 2, 4, 8) for mk in MK for n in (16, 32, 64)]
    if figure == "8c":
        return [shape_case(mk, mk, n, 1, rng, device)
                for mk in MK for n in (16, 32, 64, 128, 256, 512, 1024)]
    if figure == "int8":
        return [int8_case(mk, mk, n, rng, device) for mk in MK for n in (16, 32, 64)]
    if figure == "profile":
        return [profile_case(32768, 32768, n, 1, rng, device) for n in (16, 64)]
    raise ValueError(f"unknown figure {figure!r}; choose from {FIGURES}")


def time_cases(cases: List[Case], iters: int = 20) -> List[Dict]:
    """Each case's row from the device time of its call (one profiler
    session for all of them). Requires a CUDA device."""
    from qgtc_ppopp22_tpu_torch.utils.timing import device_times_ms

    ms = device_times_ms({i: c.run for i, c in enumerate(cases)}, iters=iters)
    return [c.row(ms[i]) for i, c in enumerate(cases)]


def run_figure(figure: str, iters: int = 20) -> List[Dict]:
    """Build ``figure``'s operands on the card from ``default_rng(0)`` and
    time them."""
    if not torch.cuda.is_available():
        raise RuntimeError("the kernel sweep times the card's kernels and needs a CUDA device")
    return time_cases(figure_cases(figure, np.random.default_rng(0), "cuda"), iters)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--figure", choices=FIGURES, default="8a")
    p.add_argument("--csv", type=str, default=None)
    args = p.parse_args(argv)
    rows = run_figure(args.figure)
    for r in rows:
        print(r, flush=True)
    if args.csv and rows:
        from qgtc_ppopp22_tpu_torch.utils.metrics import write_csv

        write_csv(args.csv, rows, list(rows[0].keys()))
        print(f"wrote {args.csv}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
