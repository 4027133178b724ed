"""Digit-domain working format: int8 base-16 digit planes.

Counterpart of ``qgtc_ppopp22_tpu/ops/digits.py``. ``digits[d]`` holds
bits ``4d .. 4d+3`` of each level, so a w-bit x a-bit GEMM is
``ceil(w/4) * ceil(a/4)`` exact int8 products:
``C = sum_{d,e} dot(A_d, B_e) << 4*(d+e)``. Both dimensions are
zero-padded to multiples of 128; zero padding is exact (level-0 rows
and columns contribute nothing and requantize to 0).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from qgtc_ppopp22_tpu_torch.ops.bitpack import (
    DIGIT_BITS,
    LANE,
    BitTensor,
    num_digits,
    round_up,
    unpack_plane_words,
)


@dataclasses.dataclass(frozen=True)
class DigitTensor:
    """A logically (M, K) integer-level matrix as int8 digit planes
    ``digits``: int8[ndigits, Mp, Kp], Mp and Kp multiples of 128."""

    digits: torch.Tensor
    shape: Tuple[int, int]
    bits: int

    @property
    def ndigits(self) -> int:
        return self.digits.shape[0]

    @property
    def padded_rows(self) -> int:
        return self.digits.shape[1]

    @property
    def padded_cols(self) -> int:
        return self.digits.shape[2]

    def nbytes(self) -> int:
        return self.digits.numel()

    def to(self, device) -> "DigitTensor":
        return dataclasses.replace(self, digits=self.digits.to(device))


def to_digit_tensor(bt: BitTensor) -> DigitTensor:
    """Packed bit-planes -> digit planes; the 256-multiple padding of the
    packed container is trimmed to 128 multiples (it is zero)."""
    M, K = bt.shape
    Mp, Kp = round_up(M, LANE), round_up(K, LANE)
    ones = unpack_plane_words(bt.planes)
    out = []
    for d in range(num_digits(bt.bits)):
        lo = d * DIGIT_BITS
        hi = min(lo + DIGIT_BITS, bt.bits)
        acc = ones[lo]
        for b in range(lo + 1, hi):
            acc = acc | (ones[b] << (b - lo))
        out.append(acc[:Mp, :Kp].to(torch.int8))
    return DigitTensor(digits=torch.stack(out), shape=(M, K), bits=bt.bits)


def split_digits(levels: torch.Tensor, bits: int) -> torch.Tensor:
    """Levels in ``[0, 2^bits)`` -> int8[ndigits, *levels.shape]."""
    out = []
    for d in range(num_digits(bits)):
        width = min(DIGIT_BITS, bits - d * DIGIT_BITS)
        out.append(((levels >> (d * DIGIT_BITS)) & ((1 << width) - 1)).to(torch.int8))
    return torch.stack(out)


def digit_pack(q: torch.Tensor, bits: int) -> DigitTensor:
    """Integer levels (M, K) -> digit planes, keeping the low ``bits``
    bits of each level (``2^bits`` wraps to 0, as the packers do)."""
    M, K = q.shape
    Mp, Kp = round_up(max(M, 1), LANE), round_up(max(K, 1), LANE)
    lv = torch.zeros((Mp, Kp), dtype=torch.int32, device=q.device)
    lv[:M, :K] = q.to(torch.int32) & ((1 << bits) - 1)
    return DigitTensor(digits=split_digits(lv, bits), shape=(M, K), bits=bits)


def digit_levels(dt: DigitTensor) -> torch.Tensor:
    """Digit planes -> int32 levels over the whole padded extent."""
    vals = torch.zeros(dt.digits.shape[1:], dtype=torch.int32, device=dt.digits.device)
    for d in range(dt.ndigits):
        vals = vals + (dt.digits[d].to(torch.int32) << (d * DIGIT_BITS))
    return vals


def digit_unpack(dt: DigitTensor) -> torch.Tensor:
    """Digit planes -> int32 levels (M, K)."""
    M, K = dt.shape
    return digit_levels(dt)[:M, :K]
