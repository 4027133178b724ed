"""Plumbing shared by the two GEMM modules (``digitmm``, ``packmm``):
the int32 accumulator guard, the plain epilogue and the kernel launch."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from qgtc_ppopp22_tpu_torch.ops._build import check, library
from qgtc_ppopp22_tpu_torch.ops.bitpack import DIGIT_BITS, num_digits
from qgtc_ppopp22_tpu_torch.ops.digits import DigitTensor, split_digits
from qgtc_ppopp22_tpu_torch.ops.quantize import requantize_wrapped

OUT_DIGITS, OUT_F32, OUT_I32 = 0, 1, 2  # csrc/gemm_core.cuh OutKind
TILE = 64  # the kernels' BM = BN = BK; padded extents must be multiples


def check_accumulator(nd_a: int, nd_b: int, kp: int, signed: bool = False) -> None:
    """Refuse a contraction whose worst case could overflow int32: the
    exact-integer contract would break silently."""
    if signed:
        # |a_s| <= 128, B levels <= 255, plus the rank-1 correction.
        worst = 2 * 128 * 255
    else:
        worst = sum(
            225 * (1 << (DIGIT_BITS * (d + e)))
            for d in range(nd_a)
            for e in range(nd_b)
        )
    if worst * kp >= (1 << 31):
        raise ValueError(
            f"padded K={kp} at {nd_a}x{nd_b} digit planes can overflow the "
            "int32 accumulator; split the contraction"
        )


def plain_product(a_levels: torch.Tensor, b_levels: torch.Tensor) -> torch.Tensor:
    """Exact integer product of two level matrices, in float64.

    The accumulator guard keeps every partial sum below 2^31 < 2^53, so
    the float64 product is exact in any summation order."""
    return torch.matmul(a_levels.to(torch.float64), b_levels.to(torch.float64)).to(
        torch.int64
    )


def plain_epilogue(
    acc: torch.Tensor,
    shape: Tuple[int, int],
    out_bits: Optional[int],
    shift: int,
    raw_i32: bool,
):
    """The kernels' epilogue on a whole padded int accumulator."""
    M, N = shape
    if out_bits is None:
        return (acc.to(torch.int32) if raw_i32 else acc.to(torch.float32))[:M, :N]
    levels = requantize_wrapped(acc, out_bits, shift)
    return DigitTensor(digits=split_digits(levels, out_bits), shape=shape, bits=out_bits)


def _operand(t: torch.Tensor, dtype: torch.dtype, name: str) -> int:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
    return t.data_ptr()


def launch(
    entry: str,
    a: torch.Tensor,
    a_dtype: torch.dtype,
    a_arg: int,
    b: torch.Tensor,
    mp: int,
    shape: Tuple[int, int],
    out_bits: Optional[int],
    shift: int,
    raw_i32: bool,
):
    """Run the CUDA entry point ``entry`` of the kernel library.

    ``a_arg`` is the entry's A descriptor (digit count for digitmm,
    field width for packmm); ``b`` is int8[nd_b, kp, np]. The output is
    allocated here and written whole by the kernel, padding included."""
    if b.device != a.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    nd_b, kp, np_ = b.shape
    if mp % TILE or kp % TILE or np_ % TILE:
        raise ValueError(f"padded extents {(mp, kp, np_)} are not multiples of {TILE}")
    if out_bits is None:
        kind = OUT_I32 if raw_i32 else OUT_F32
        out = torch.empty(
            (mp, np_), dtype=torch.int32 if raw_i32 else torch.float32, device=a.device
        )
    else:
        kind = OUT_DIGITS
        out = torch.empty((num_digits(out_bits), mp, np_), dtype=torch.int8, device=a.device)
    a_ptr = _operand(a, a_dtype, "A")
    b_ptr = _operand(b, torch.int8, "B")
    lib = library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = getattr(lib, entry)(
            out.data_ptr(), a_ptr, b_ptr, a_arg, nd_b, mp, kp, np_, kind,
            out_bits or 0, shift, stream,
        )
    check(err, entry)
    M, N = shape
    if out_bits is None:
        return out[:M, :N]
    return DigitTensor(digits=out, shape=shape, bits=out_bits)
