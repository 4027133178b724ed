"""Bit-plane containers and pack/unpack ops on torch tensors.

Counterpart of ``qgtc_ppopp22_tpu/ops/bitpack.py`` with the same layout:

    planes : int32[bits, Mw, Kp]      Mw = Mp / 32

Word ``planes[b, w, k]`` packs bit-plane ``b`` of the elements
``(32*w + j, k)``, ``j in [0, 32)``, bit ``j`` of the word holding row
``32*w + j``. Both dimensions are zero-padded to multiples of 256.

The JAX package stores the words as uint32; here they are int32 with
the same bits (torch's uint32 supports few ops). Every right shift is
followed by a mask, because int32 ``>>`` sign-extends.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from qgtc_ppopp22_tpu_torch.ops.quantize import quantize

ROWS_PER_WORD = 32  # logical rows packed per 32-bit word
SUBLANE = 8  # kept from the reference layout: M pads to 32 * 8 = 256
LANE = 128  # digit tensors pad to multiples of 128
ROW_PAD = ROWS_PER_WORD * SUBLANE  # 256
COL_PAD = ROW_PAD  # columns pad like rows, so any BitTensor is either operand
DIGIT_BITS = 4  # base-16 digit decomposition for int8 GEMMs


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def num_digits(bits: int) -> int:
    """Number of base-16 digits covering ``bits`` bit-planes."""
    return -(-bits // DIGIT_BITS)


def field_width(bits: int) -> int:
    """Packed field bits per value within one digit plane of an M-packed
    tensor (``ops/packmm.py``; 8 = the offset-signed byte plane of 5-8
    bit levels)."""
    if bits <= 2:
        return bits
    if bits <= DIGIT_BITS:
        return DIGIT_BITS
    return 8


def packed_signed(bits: int) -> bool:
    """True when ``bits`` packs as the single offset-signed byte plane."""
    return field_width(bits) == 8


def u32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in ``[0, 2^32)`` -> int32 with the same 32 bits."""
    return (x - ((x >> 31) & 1) * (1 << 32)).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class BitTensor:
    """A logically (M, K) integer matrix stored as packed bit-planes."""

    planes: torch.Tensor  # int32[bits, Mw, Kp]
    shape: Tuple[int, int]
    bits: int

    def __post_init__(self):
        if self.planes.shape[0] != self.bits:
            raise ValueError(f"{self.planes.shape[0]} planes for {self.bits} bits")

    @property
    def padded_rows(self) -> int:
        return self.planes.shape[1] * ROWS_PER_WORD

    @property
    def padded_cols(self) -> int:
        return self.planes.shape[2]

    def nbytes(self) -> int:
        return self.planes.numel() * 4

    def to(self, device) -> "BitTensor":
        return dataclasses.replace(self, planes=self.planes.to(device))


def pack_bits(q: torch.Tensor, bits: int) -> BitTensor:
    """int levels (M, K) -> packed bit-planes, keeping the low ``bits``
    bits (a level of ``2^bits`` wraps to 0, as the reference packer)."""
    M, K = q.shape
    Mp = round_up(max(M, 1), ROW_PAD)
    Kp = round_up(max(K, 1), COL_PAD)
    dev = q.device
    lv = torch.zeros((Mp, Kp), dtype=torch.int64, device=dev)
    lv[:M, :K] = q.to(torch.int64) & ((1 << bits) - 1)
    b_idx = torch.arange(bits, device=dev).view(-1, 1, 1)
    planes = ((lv[None] >> b_idx) & 1).view(bits, Mp // ROWS_PER_WORD, ROWS_PER_WORD, Kp)
    j_idx = torch.arange(ROWS_PER_WORD, device=dev).view(1, 1, -1, 1)
    words = (planes << j_idx).sum(dim=2)
    return BitTensor(planes=u32_to_i32(words), shape=(M, K), bits=bits)


def pack_bits_np(q, bits: int) -> BitTensor:
    """Host-side (NumPy) packer; same container as :func:`pack_bits`,
    returned on the CPU."""
    q = np.asarray(q)
    M, K = q.shape
    Mp = round_up(max(M, 1), ROW_PAD)
    Kp = round_up(max(K, 1), COL_PAD)
    qq = np.zeros((Mp, Kp), np.uint32)
    qq[:M, :K] = q.astype(np.int64) & np.int64((1 << bits) - 1)
    b_idx = np.arange(bits, dtype=np.uint32)[:, None, None]
    planes = (qq[None] >> b_idx) & np.uint32(1)
    planes = planes.reshape(bits, Mp // ROWS_PER_WORD, ROWS_PER_WORD, Kp)
    j_idx = np.arange(ROWS_PER_WORD, dtype=np.uint32)[None, None, :, None]
    words = np.bitwise_or.reduce((planes << j_idx).astype(np.uint32), axis=2)
    return BitTensor(
        planes=torch.from_numpy(words.view(np.int32)), shape=(M, K), bits=bits
    )


def unpack_plane_words(words: torch.Tensor) -> torch.Tensor:
    """int32[..., Mw, Kp] -> int32[..., Mw*32, Kp] of 0/1 bits."""
    *lead, mw, kp = words.shape
    j_idx = torch.arange(ROWS_PER_WORD, dtype=torch.int32, device=words.device)
    j_idx = j_idx.view((1,) * len(lead) + (1, ROWS_PER_WORD, 1))
    bits = (words[..., :, None, :] >> j_idx) & 1
    return bits.reshape(*lead, mw * ROWS_PER_WORD, kp)


def unpack_bits(bt: BitTensor) -> torch.Tensor:
    """Packed bit-planes -> int32 levels (M, K)."""
    M, K = bt.shape
    ones = unpack_plane_words(bt.planes)  # [bits, Mp, Kp]
    b_idx = torch.arange(bt.bits, dtype=torch.int32, device=ones.device)
    vals = (ones << b_idx.view(-1, 1, 1)).sum(dim=0, dtype=torch.int32)
    return vals[:M, :K]


def to_digits(bt: BitTensor) -> torch.Tensor:
    """Packed bit-planes -> int8 base-16 digits [ndigits, Mp, Kp]
    (digit ``d`` gathers planes ``4d .. 4d+3``; no trimming)."""
    ones = unpack_plane_words(bt.planes)
    digits = []
    for d in range(num_digits(bt.bits)):
        lo = d * DIGIT_BITS
        hi = min(lo + DIGIT_BITS, bt.bits)
        acc = torch.zeros_like(ones[0])
        for b in range(lo, hi):
            acc = acc | (ones[b] << (b - lo))
        digits.append(acc.to(torch.int8))
    return torch.stack(digits)


def val2bit(x: torch.Tensor, bits: int) -> BitTensor:
    """float (M, K) -> quantize -> packed bit-planes (reference ``val2bit``)."""
    return pack_bits(quantize(x, bits), bits)


def bit2val(bt: BitTensor) -> torch.Tensor:
    """Packed bit-planes -> float32 levels (reference ``bit2val``)."""
    return unpack_bits(bt).to(torch.float32)
