"""M-packed A x digit planes, and the packed container it consumes.

Counterpart of ``qgtc_ppopp22_tpu/ops/packmm.py`` (TPU kernel
``_packmm``). It carries every aggregation ``A x H`` of the step engine
and the final ``A x H -> f32``.

Layout (``PackedTensor``, byte for byte the JAX one): per digit plane,
values are packed ``P = 8 // f`` rows per byte (f = field bits: 1 for
1-bit, 2 for 2-bit, 4 for 3-4 bit), 4 bytes per int32 word, rows
permuted within fixed 256-row groups: group row ``q*(4*gw) + 4*i + k``
lives in bits ``[8k + f*q, 8k + f*(q+1))`` of word row ``i``, with
``gw = 256 / (32 / f)``. Levels of 5-8 bits are one plain int8 plane of
offset-signed bytes (``level - 128``); a GEMM against it adds the exact
rank-1 correction ``128 * colsum(B_levels)``.

Dispatch: operands on the CPU run :func:`packmm_plain`; operands on a
CUDA device launch the kernel of ``csrc/packmm.cu`` or raise. The
zero-tile K skip, the packed-words output and ``PreparedRHS`` are not
ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from qgtc_ppopp22_tpu_torch.ops import _gemm
from qgtc_ppopp22_tpu_torch.ops.bitpack import DIGIT_BITS, num_digits, round_up, u32_to_i32
from qgtc_ppopp22_tpu_torch.ops.digits import DigitTensor, digit_levels

PACK_GROUP = 256  # rows per permutation group (layout contract)
_OFFSET = 128  # signed-plane offset: stored byte = level - 128

LAUNCHES = 0  # kernel launches since the count was last reset to 0


def field_width(bits: int) -> int:
    """Packed field bits per value within one digit plane (8 = the
    offset-signed byte plane of 5-8 bit levels)."""
    if bits <= 2:
        return bits
    if bits <= DIGIT_BITS:
        return DIGIT_BITS
    return 8


def packed_signed(bits: int) -> bool:
    """True when ``bits`` packs as the single offset-signed byte plane."""
    return field_width(bits) == 8


@dataclasses.dataclass(frozen=True)
class PackedTensor:
    """(M, K) integer levels, bit-packed along M.

    ``words``: int32[nd, Mp // (32 // f), Kp] with Mp = round_up(M, 256)
    and Kp = round_up(K, 128); for 5-8 bits int8[1, Mp, Kp]."""

    words: torch.Tensor
    shape: Tuple[int, int]
    bits: int

    @property
    def ndigits(self) -> int:
        return self.words.shape[0]

    @property
    def rows_per_word(self) -> int:
        return 1 if packed_signed(self.bits) else 32 // field_width(self.bits)

    @property
    def padded_rows(self) -> int:
        return self.words.shape[1] * self.rows_per_word

    @property
    def padded_cols(self) -> int:
        return self.words.shape[2]

    def nbytes(self) -> int:
        return self.words.numel() * self.words.element_size()

    def to(self, device) -> "PackedTensor":
        return dataclasses.replace(self, words=self.words.to(device))


def _group_perm(f: int) -> np.ndarray:
    """``rows[q, i, k] = q*4*gw + 4*i + k``: the logical row (within a
    256-row group) that the packer puts into bits ``8k + f*q`` of word
    row ``i``."""
    P = 8 // f
    gw = PACK_GROUP // (32 // f)
    q, i, k = np.meshgrid(np.arange(P), np.arange(gw), np.arange(4), indexing="ij")
    return q * (4 * gw) + 4 * i + k


def _shifts(f: int) -> np.ndarray:
    """Bit offset of slot (q, i, k), shape [P, 1, 4]."""
    return 8 * np.arange(4)[None, None, :] + f * np.arange(8 // f)[:, None, None]


def pack_rows_np(q: np.ndarray, bits: int) -> np.ndarray:
    """Host-side packer: int levels (M, K) -> the ``PackedTensor`` payload
    (int32 words, or the int8 signed plane for 5-8 bits)."""
    f = field_width(bits)
    M, K = q.shape
    Mp, Kp = round_up(max(M, 1), PACK_GROUP), round_up(max(K, 1), 128)
    lv = np.zeros((Mp, Kp), np.uint32)
    lv[:M, :K] = q.astype(np.int64) & np.int64((1 << bits) - 1)
    if packed_signed(bits):
        return (lv ^ np.uint32(_OFFSET)).astype(np.uint8).view(np.int8)[None]
    P, rpw = 8 // f, 32 // f
    gw = PACK_GROUP // rpw
    out = np.zeros((num_digits(bits), Mp // rpw, Kp), np.uint32)
    shifts = _shifts(f).astype(np.uint32)
    for d in range(num_digits(bits)):
        width = min(DIGIT_BITS, bits - d * DIGIT_BITS)
        dig = (lv >> np.uint32(d * DIGIT_BITS)) & np.uint32((1 << width) - 1)
        g = dig.reshape(-1, P, gw, 4, Kp)  # group row = q*4gw + 4i + k
        words = np.bitwise_or.reduce(g << shifts[None, :, :, :, None], axis=(1, 3))
        out[d] = words.reshape(Mp // rpw, Kp)
    return out.view(np.int32)


def unpack_rows_np(words: np.ndarray, bits: int) -> np.ndarray:
    """Host-side inverse of :func:`pack_rows_np` for 1-4 bit levels:
    int32 words [1, Mp/rpw, Kp] -> uint32 levels [Mp, Kp]."""
    if packed_signed(bits):
        raise ValueError(f"{bits}-bit levels pack as a byte plane, not as words")
    f = field_width(bits)
    g = words.view(np.uint32).reshape(-1, PACK_GROUP // (32 // f), words.shape[-1])
    shifts = _shifts(f).astype(np.uint32)[None, :, :, :, None]
    return ((g[:, None, :, None, :] >> shifts) & np.uint32((1 << f) - 1)).reshape(-1, words.shape[-1])


def pack_rows(q: torch.Tensor, bits: int) -> PackedTensor:
    """Device packer: int levels (M, K) -> :class:`PackedTensor`."""
    f = field_width(bits)
    M, K = q.shape
    Mp, Kp = round_up(max(M, 1), PACK_GROUP), round_up(max(K, 1), 128)
    lv = torch.zeros((Mp, Kp), dtype=torch.int64, device=q.device)
    lv[:M, :K] = q.to(torch.int64) & ((1 << bits) - 1)
    if packed_signed(bits):
        return PackedTensor(words=(lv - _OFFSET).to(torch.int8)[None], shape=(M, K), bits=bits)
    P, rpw = 8 // f, 32 // f
    gw = PACK_GROUP // rpw
    shifts = torch.as_tensor(_shifts(f), device=q.device)[None, :, :, :, None]
    planes = []
    for d in range(num_digits(bits)):
        width = min(DIGIT_BITS, bits - d * DIGIT_BITS)
        dig = (lv >> (d * DIGIT_BITS)) & ((1 << width) - 1)
        words = (dig.view(-1, P, gw, 4, Kp) << shifts).sum(dim=(1, 3))
        planes.append(words.reshape(Mp // rpw, Kp))
    return PackedTensor(words=u32_to_i32(torch.stack(planes)), shape=(M, K), bits=bits)


def packed_levels(pt: PackedTensor) -> torch.Tensor:
    """PackedTensor -> int32 levels over the whole padded extent."""
    if packed_signed(pt.bits):
        return pt.words[0].to(torch.int32) + _OFFSET
    f = field_width(pt.bits)
    P, rpw = 8 // f, 32 // f
    gw = PACK_GROUP // rpw
    nd, mw, Kp = pt.words.shape
    shifts = torch.as_tensor(_shifts(f), dtype=torch.int32, device=pt.words.device)
    g = pt.words.view(nd, -1, gw, Kp)
    # [nd, ngroups, P, gw, 4, Kp]; the mask drops int32 sign extension
    parts = (g[:, :, None, :, None, :] >> shifts[None, None, :, :, :, None]) & ((1 << f) - 1)
    vals = parts.reshape(nd, mw * rpw, Kp)
    out = torch.zeros((mw * rpw, Kp), dtype=torch.int32, device=pt.words.device)
    for d in range(nd):
        out = out + (vals[d] << (d * DIGIT_BITS))
    return out


def unpack_rows(pt: PackedTensor) -> torch.Tensor:
    """PackedTensor -> int32 levels (M, K)."""
    M, K = pt.shape
    return packed_levels(pt)[:M, :K]


def build_tile_map_packed_np(
    words: np.ndarray,
    bits: int,
    tile_m: int = PACK_GROUP,
    tile_k: int = 256,
) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side zero-tile schedule ``(kidx, kcnt)`` over M-packed words:
    per row tile, the occupied K tiles first, then the last valid index
    repeated. Built once at pack time and shipped with each batch."""
    rpw = 1 if packed_signed(bits) else 32 // field_width(bits)
    nd, mw, kp = words.shape
    mp = mw * rpw
    if tile_m % PACK_GROUP or mp % tile_m or kp % tile_k:
        raise ValueError((tile_m, tile_k, mp, kp))
    nm, nk = mp // tile_m, kp // tile_k
    tiles = words.reshape(nd, nm, tile_m // rpw, nk, tile_k)
    zw = np.int8(-128) if packed_signed(bits) else np.int32(0)  # level 0
    occ = np.any(tiles != zw, axis=(0, 2, 4))
    kcnt = np.sum(occ, axis=1).astype(np.int32)
    order = np.argsort(~occ, axis=1, kind="stable").astype(np.int32)
    t = np.arange(nk, dtype=np.int32)[None, :]
    clamp = np.minimum(t, np.maximum(kcnt - 1, 0)[:, None])
    kidx = np.take_along_axis(order, clamp, axis=1)
    return kidx, kcnt


# ---------------------------------------------------------------------------
# GEMM
# ---------------------------------------------------------------------------


def _check(a: PackedTensor, b: DigitTensor) -> None:
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"contraction mismatch: {a.shape} @ {b.shape}")
    nd_a, _, kp = a.words.shape
    nd_b, kp_b, _ = b.digits.shape
    if kp != kp_b:
        raise ValueError(f"padded K mismatch: lhs {kp} vs rhs {kp_b}")
    if nd_a != 1:
        raise ValueError(f"a packed A holds one plane, got {nd_a}")
    _gemm.check_accumulator(nd_a, nd_b, kp, signed=packed_signed(a.bits))


def packmm_plain(
    a: PackedTensor,
    b: DigitTensor,
    out_bits: Optional[int] = None,
    shift: int = 0,
    raw_i32: bool = False,
):
    """Plain PyTorch version on any device: decode A to levels, take the
    levels product, then the kernel's epilogue. Returns what the matching
    wrapper returns."""
    _check(a, b)
    acc = _gemm.plain_product(packed_levels(a), digit_levels(b))
    return _gemm.plain_epilogue(acc, (a.shape[0], b.shape[1]), out_bits, shift, raw_i32)


def _packmm(a: PackedTensor, b: DigitTensor, out_bits, shift, raw_i32):
    global LAUNCHES
    _check(a, b)
    if not a.words.is_cuda:
        return packmm_plain(a, b, out_bits, shift, raw_i32)
    signed = packed_signed(a.bits)
    out = _gemm.launch(
        "qgtc_packmm", a.words, torch.int8 if signed else torch.int32,
        field_width(a.bits), b.digits, a.padded_rows, (a.shape[0], b.shape[1]),
        out_bits, shift, raw_i32,
    )
    LAUNCHES += 1
    return out


def packmm_to_digits(
    a: PackedTensor, b: DigitTensor, out_bits: int, shift: int = 0
) -> DigitTensor:
    """Packed-A GEMM, requantized digit-plane output over the whole
    padded extent (``bitMM2Bit`` role with the fused epilogue)."""
    return _packmm(a, b, out_bits, shift, False)


def packmm_to_f32(a: PackedTensor, b: DigitTensor) -> torch.Tensor:
    """Packed-A GEMM, float32 [M, N] output (``bitMM2Int`` role)."""
    return _packmm(a, b, None, 0, False)


def packmm_to_i32(a: PackedTensor, b: DigitTensor) -> torch.Tensor:
    """Packed-A GEMM, raw int32 accumulator [M, N]."""
    return _packmm(a, b, None, 0, True)
