"""Digit planes x digit planes with the fused requantize epilogue.

Counterpart of ``qgtc_ppopp22_tpu/ops/digitmm.py`` (TPU kernel
``_digitmm``): ``C = sum_{d,e} dot(A_d, B_e) << 4*(d+e)`` in int32, then
requantized into digit planes (``digitmm_to_digits``) or stored raw as
float32 / int32. It carries the step engine's ``H x W`` updates.

Dispatch: operands on the CPU run :func:`digitmm_plain`; operands on a
CUDA device launch the kernel of ``csrc/digitmm.cu`` or raise. The
block-sparse K skip (``tile_map``) is not ported.
"""

from __future__ import annotations

from typing import Optional

import torch

from qgtc_ppopp22_tpu_torch.ops import _gemm
from qgtc_ppopp22_tpu_torch.ops.digits import DigitTensor, digit_levels

LAUNCHES = 0  # kernel launches since the count was last reset to 0


def _check(a: DigitTensor, b: DigitTensor) -> None:
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"contraction mismatch: {a.shape} @ {b.shape}")
    nd_a, _, kp = a.digits.shape
    nd_b, kp_b, _ = b.digits.shape
    if kp != kp_b:
        raise ValueError(f"padded K mismatch: lhs {kp} vs rhs {kp_b}")
    _gemm.check_accumulator(nd_a, nd_b, kp)


def digitmm_plain(
    a: DigitTensor,
    b: DigitTensor,
    out_bits: Optional[int] = None,
    shift: int = 0,
    raw_i32: bool = False,
):
    """Plain PyTorch version on any device: the levels product, then the
    kernel's epilogue. Returns what the matching wrapper returns."""
    _check(a, b)
    acc = _gemm.plain_product(digit_levels(a), digit_levels(b))
    return _gemm.plain_epilogue(acc, (a.shape[0], b.shape[1]), out_bits, shift, raw_i32)


def _digitmm(a: DigitTensor, b: DigitTensor, out_bits, shift, raw_i32):
    global LAUNCHES
    _check(a, b)
    if not a.digits.is_cuda:
        return digitmm_plain(a, b, out_bits, shift, raw_i32)
    out = _gemm.launch(
        "qgtc_digitmm", a.digits, torch.int8, a.ndigits, b.digits,
        a.padded_rows, (a.shape[0], b.shape[1]), out_bits, shift, raw_i32,
    )
    LAUNCHES += 1
    return out


def digitmm_to_digits(
    a: DigitTensor, b: DigitTensor, out_bits: int, shift: int = 0
) -> DigitTensor:
    """``requantize(A_levels @ B_levels >> shift, out_bits)`` as digit
    planes over the whole padded extent (``bitMM2Bit`` role)."""
    return _digitmm(a, b, out_bits, shift, False)


def digitmm_to_f32(a: DigitTensor, b: DigitTensor) -> torch.Tensor:
    """``A_levels @ B_levels`` as float32 [M, N] (``bitMM2Int`` role)."""
    return _digitmm(a, b, None, 0, False)


def digitmm_to_i32(a: DigitTensor, b: DigitTensor) -> torch.Tensor:
    """``A_levels @ B_levels`` as the raw int32 accumulator [M, N]."""
    return _digitmm(a, b, None, 0, True)
