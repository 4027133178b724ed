"""M-packed A x digit planes, and the packed container it consumes.

Counterpart of ``qgtc_ppopp22_tpu/ops/packmm.py`` (TPU kernels
``_packmm`` and ``_packmm_signed_stream``). It carries every aggregation
``A x H`` of the step engine and the final ``A x H -> f32``, and the
kernel sweep's bit-in/bit-out products (``packmm_to_packed``).

Layout (``PackedTensor``, byte for byte the JAX one): per digit plane,
values are packed ``P = 8 // f`` rows per byte (f = field bits: 1 for
1-bit, 2 for 2-bit, 4 for 3-4 bit), 4 bytes per int32 word, rows
permuted within fixed 256-row groups: group row ``q*(4*gw) + 4*i + k``
lives in bits ``[8k + f*q, 8k + f*(q+1))`` of word row ``i``, with
``gw = 256 / (32 / f)``. Levels of 5-8 bits are one plain int8 plane of
offset-signed bytes (``level - 128``); a GEMM against it adds the exact
rank-1 correction ``128 * colsum(B_levels)``.

A :class:`PreparedRHS` (a weight-like B as one offset-signed byte plane
with a ones lane, :func:`prepare_rhs`) pairs with a 5-8 bit A and runs
one int8 pass with the whole offset correction in the epilogue.

Zero-tile jumping: a ``TileMap`` (``tile_map=``, built by
:func:`build_tile_map_packed`, or shipped with each cluster batch) makes
each row tile visit only the K tiles it lists; a tile listed n times
counts n times, an unlisted one not at all. A ``PreparedRHS`` takes no
map (``ValueError``, as in JAX).

Dispatch: operands on the CPU run :func:`packmm_plain` (which takes a
``PreparedRHS`` to :func:`packmm_signed_plain`); operands on a CUDA
device launch the kernel of ``csrc/packmm.cu`` (``LAUNCHES``), or of
``csrc/packmm_signed.cu`` for a ``PreparedRHS`` (``SIGNED_LAUNCHES``),
or raise. A 1-, 2- or 4-bit A runs ``csrc/packmm_k2.cuh`` on the launch
geometry that :func:`packmm_plan` chooses; a 5-8-bit A (against digit
planes or a ``PreparedRHS``) runs ``csrc/packmm_k4.cuh`` on the one that
:func:`packmm_signed_plan` chooses.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple, Union

import numpy as np
import torch

from qgtc_ppopp22_tpu_torch.ops import _gemm
from qgtc_ppopp22_tpu_torch.ops._gemm import SMS, Plan
from qgtc_ppopp22_tpu_torch.ops.bitgemm import TileMap
from qgtc_ppopp22_tpu_torch.ops.bitpack import (
    DIGIT_BITS,
    field_width,
    num_digits,
    packed_signed,
    round_up,
    u32_to_i32,
)
from qgtc_ppopp22_tpu_torch.ops.digits import DigitTensor, digit_levels, digit_unpack, split_digits
from qgtc_ppopp22_tpu_torch.ops.quantize import requantize_wrapped

PACK_GROUP = 256  # rows per permutation group (layout contract)
_OFFSET = 128  # signed-plane offset: stored byte = level - 128

RESIDENT = 4 * SMS  # K2's CTAs the card holds at once: what the split fills
MAX_SPLIT = 4  # CTAs that share one output tile (csrc/packmm_k2.cuh, packmm_k4.cuh)
PACK_SPLIT = 2  # for packed words, beside the 4 CTAs of a group: a cluster <= 8
SIGNED_RESIDENT = 3 * SMS // 4  # K4's CTAs the split fills: clusters of up to 4 place in one wave
SIGNED_STEP = 128  # K4's contraction depth a step (csrc/packmm_k4.cuh KS)
SIGNED_ROWS = 128  # K4's rows a CTA (csrc/packmm_k4.cuh ROWS)

LAUNCHES = 0  # csrc/packmm.cu launches since the count was last reset to 0
MAPPED_LAUNCHES = 0  # those of them given a TileMap, likewise
SIGNED_LAUNCHES = 0  # csrc/packmm_signed.cu launches, likewise


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


def _pack_levels(lv: torch.Tensor, bits: int) -> torch.Tensor:
    """Levels ``[Mp, C]`` in ``[0, 2^bits)``, Mp a multiple of 256 -> the
    ``PackedTensor`` payload over all of them (int32 words, or the int8
    signed plane for 5-8 bits): the kernels' packed-words epilogue."""
    lv = lv.to(torch.int64)
    if packed_signed(bits):
        return (lv - _OFFSET).to(torch.int8)[None]
    f = field_width(bits)
    P, rpw = 8 // f, 32 // f
    gw = PACK_GROUP // rpw
    Mp, C = lv.shape
    shifts = torch.as_tensor(_shifts(f), device=lv.device)[None, :, :, :, None]
    planes = []
    for d in range(num_digits(bits)):
        width = min(DIGIT_BITS, bits - d * DIGIT_BITS)
        dig = (lv >> (d * DIGIT_BITS)) & ((1 << width) - 1)
        words = (dig.reshape(-1, P, gw, 4, C) << shifts).sum(dim=(1, 3))
        planes.append(words.reshape(Mp // rpw, C))
    return u32_to_i32(torch.stack(planes))


def pack_rows(q: torch.Tensor, bits: int) -> PackedTensor:
    """Device packer: int levels (M, K) -> :class:`PackedTensor`."""
    M, K = q.shape
    Mp, Kp = round_up(max(M, 1), PACK_GROUP), round_up(max(K, 1), 128)
    lv = torch.zeros((Mp, Kp), dtype=torch.int64, device=q.device)
    lv[:M, :K] = q.to(torch.int64) & ((1 << bits) - 1)
    return PackedTensor(words=_pack_levels(lv, bits), shape=(M, K), bits=bits)


def pack_digit_tensor(dt: DigitTensor) -> PackedTensor:
    """DigitTensor -> PackedTensor."""
    return pack_rows(digit_unpack(dt), dt.bits)


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


def build_tile_map_packed(
    pt: PackedTensor, tile_m: Optional[int] = None, tile_k: Optional[int] = None
) -> TileMap:
    """Occupancy map over (tile_m x tile_k) tiles of a PackedTensor, on
    its device (JAX ``build_tile_map_packed``, the same defaults: tile_m
    the largest multiple of 256 dividing the padded rows into tiles of at
    most ~512, tile_k 256 where it divides the padded K, else 128). A
    tile is zero when every word inside it is (every byte -128 for a
    signed plane, level 0)."""
    nd, mw, kp = pt.words.shape
    rpw = pt.rows_per_word
    mp = mw * rpw
    tile_m = tile_m or max(PACK_GROUP, mp // max(mp // 512, 1))
    tile_k = tile_k or (256 if kp % 256 == 0 else 128)
    if tile_m % PACK_GROUP or mp % tile_m or kp % tile_k:
        raise ValueError((tile_m, tile_k, mp, kp))
    nm, nk = mp // tile_m, kp // tile_k
    tiles = pt.words.reshape(nd, nm, tile_m // rpw, nk, tile_k)
    zero = -_OFFSET if packed_signed(pt.bits) else 0
    occ = (tiles != zero).any(dim=4).any(dim=2).any(dim=0)
    kidx, kcnt = _gemm.occupancy_schedule(occ)
    return TileMap(kidx=kidx, kcnt=kcnt, tile_m=tile_m, tile_k=tile_k)


# ---------------------------------------------------------------------------
# PreparedRHS: the signed-plane right operand
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PreparedRHS:
    """Pack-time form of a weight-like (K, N) right operand for a 5-8 bit
    (signed-plane) A.

    ``plane``: int8[Kp, Np] = B levels - 128 (padding is level 0, -128),
    with lane ``Np - 1`` set to 1, so a dot against it also yields
    ``rowsum(A - 128)`` in that lane. ``corr``: int32[8, Np], row 0 =
    ``128 * colsum(plane) + 128^2 * Kp`` (rows 1-7 zero): with the rowsum,
    the remaining terms of ``A@B = (A-128)(B-128) + 128 rowsum(A-128) +
    128 colsum(B-128) + 128^2 K``. ``plane_t``: the plane transposed,
    int8[Np, Kp], the form the card's kernel streams (made once by
    :func:`prepare_rhs`; the plain version does not read it)."""

    plane: torch.Tensor
    corr: torch.Tensor
    shape: Tuple[int, int]
    bits: int
    plane_t: Optional[torch.Tensor] = None

    def to(self, device) -> "PreparedRHS":
        return dataclasses.replace(self, plane=self.plane.to(device), corr=self.corr.to(device),
                                   plane_t=None if self.plane_t is None else self.plane_t.to(device))


def prepare_rhs(b: DigitTensor) -> PreparedRHS:
    """The :class:`PreparedRHS` form of ``b``. It needs a free lane (real
    width rounded to 8 below the padded width) for the ones column."""
    K, N = b.shape
    _, kp, np_ = b.digits.shape
    if round_up(max(N, 1), 8) >= np_:
        raise ValueError(f"prepare_rhs needs a free lane: N={N} fills the {np_}-lane tile")
    sb = digit_levels(b).to(torch.int64) - _OFFSET
    sb[:, np_ - 1] = 1
    corr = torch.zeros((8, np_), dtype=torch.int64, device=sb.device)
    corr[0] = (sb.sum(dim=0) << 7) + _OFFSET * _OFFSET * kp
    plane = sb.to(torch.int8)
    return PreparedRHS(plane=plane, corr=corr.to(torch.int32), shape=(K, N), bits=b.bits,
                       plane_t=plane.t().contiguous())


Rhs = Union[DigitTensor, PreparedRHS]


# ---------------------------------------------------------------------------
# GEMM
# ---------------------------------------------------------------------------


def _stored_cols(out_form: str, out_cols: Optional[int], np_: int) -> int:
    """Columns a terminal (f32, i32, packed) output stores: ``out_cols``
    rounded up to 8, at most the padded width."""
    if out_cols is None:
        return np_
    if out_form == "digits":
        raise ValueError(
            "out_cols is for terminal outputs (f32/packed); digit outputs feed "
            "chained GEMMs and keep their padding"
        )
    return min(round_up(max(int(out_cols), 1), 8), np_)


def packmm_plan(mp: int, kp: int, np_: int, n: int, out_form: str, ocp: int,
                tile_map: Optional[TileMap] = None, bnt: Optional[int] = None) -> Plan:
    """The launch geometry of K2 for an M-packed 1-, 2- or 4-bit A of
    ``mp`` padded rows and ``kp`` padded columns against a B of ``n`` real
    and ``np_`` padded columns. ``out_form``: ``"digits"``, ``"f32"``,
    ``"i32"``, ``"plane"`` (the signed byte plane of 5-8-bit packed out) or
    ``"words"`` (M-packed words); ``ocp``: the stored columns of the
    terminal forms; ``bnt``: a column tile to take instead of the chosen
    one (``benchmarks/gemm_times.py --plans`` compares them).

    The computed columns are ``round_up(n, 8)`` (at most the stored ones);
    the column tile is the narrowest of 16, 32 and 64 that holds them. Where
    the row tiles number fewer than 2 an SM, narrower tiles win: each tile
    unpacks A again, but more, narrower CTAs hide more of a step's latency.
    There 64 columns are two tiles of 32, and up to 48 columns of a per-tile
    output (not packed words) are tiles of 16. The split fills the CTAs the
    card holds at once (4 an SM) where the grid is small: ``RESIDENT //
    (column tiles x row tiles)``, at most 4 (2 for words, whose 4 CTAs of a
    256-row group share the cluster too), with at least 4 K steps a CTA
    dense or one listed K tile a CTA with ``tile_map``.

    Measured (``benchmarks/gemm_times.py --plans``, one H100 SXM at 700 W),
    on C1's 40 row tiles, to digits at N 16 23.8 / 14.6 / 12.1 / 10.5 us
    at S 1 / 2 / 3 / 4; to f32 at N 24 10.4 us on tiles of 16, 11.0 on one
    of 32; at N 40 11.6 / 12.5 / 17.1 on tiles of 16 / 32 / 64, at N 48
    11.6 / 12.5; at N 64 14.5 on four of 16 (S 3), 12.7 on two of 32; to
    digits at N 40 12.4 / 13.8 on 16 / 32. 1-bit 4096² to words at S 2: N
    40 28.7 on either 16 or 32; N 64 34.5 / 29.0 / 41.7 on 16 / 32 / 64.

    The plan depends only on these integers (and the map's ``tile_k``), so
    it is computed once per shape."""
    return _cached_plan(mp, kp, np_, n, out_form, ocp, None if tile_map is None else tile_map.tile_k, bnt)


@functools.lru_cache(maxsize=None)
def _cached_plan(mp: int, kp: int, np_: int, n: int, out_form: str, ocp: int,
                 tile_k: Optional[int], bnt: Optional[int]) -> Plan:
    if out_form not in ("digits", "f32", "i32", "plane", "words"):
        raise ValueError(f"unknown out_form {out_form!r}")
    ncomp = min(round_up(max(n, 1), 8), np_ if out_form == "digits" else ocp)
    rows = mp // _gemm.TILE
    if bnt is None:
        small = rows < 2 * SMS
        if ncomp <= 16 or (small and ncomp <= 48 and out_form != "words"):
            bnt = 16
        else:
            bnt = 32 if ncomp <= 32 or (small and ncomp <= 64) else 64
    tiles = (-(-ncomp // bnt), rows)
    steps = kp // _gemm.TILE // 4 if tile_k is None else kp // tile_k
    words = out_form == "words"
    splits = max(1, min(PACK_SPLIT if words else MAX_SPLIT, RESIDENT // (tiles[0] * tiles[1]), steps))
    return Plan(bnt=bnt, splits=splits, cluster=(1, PACK_GROUP // _gemm.TILE if words else 1, splits),
                grid=(*tiles, splits))


def packmm_signed_plan(mp: int, kp: int, np_: int, n: int, out_form: str, ocp: int,
                       tile_map: Optional[TileMap] = None, bnt: Optional[int] = None) -> Plan:
    """The launch geometry of ``csrc/packmm_k4.cuh`` for a 5-8-bit A (the
    offset-signed byte plane) of ``mp`` padded rows and ``kp`` padded
    columns: K4 against a ``PreparedRHS``, or K2's 8-bit route against
    digit planes. ``n``: the columns not stored as level 0 (the
    ``PreparedRHS`` product's ``mask_n``, or B's real columns); ``np_``,
    ``out_form``, ``ocp``, ``tile_map`` and ``bnt`` as in
    :func:`packmm_plan`.

    The computed columns are ``round_up(n, 8)`` (at most the stored ones);
    the column tile is the narrowest of 16, 32 and 64 that holds them, so
    A is read once wherever they fit one tile (the sweep's 8-bit rows).
    A CTA owns 128 rows. The split fills three quarters of the SMs, one
    CTA each: ``SIGNED_RESIDENT // (column tiles x row tiles)``, at most 4
    (2 for words, whose 2 CTAs of a 256-row group share the cluster too),
    with at least 2 of the kernel's 128-deep K steps a CTA dense or one
    listed K tile a CTA with ``tile_map``. At 4096² that is 3 CTAs of 32
    row tiles: 96 CTAs, whose clusters place in one wave, where 4 made 128
    and some SMs ran two (measured, ``benchmarks/gemm_times.py --plans``,
    one H100 at 700 W: K4 at 4096² x 64 10.2 us at S 3, 11.5 at S 4; K2's
    8-bit plane 26.0 and 38.4).

    The plan depends only on these integers (and the map's ``tile_k``), so
    it is computed once per shape."""
    return _cached_signed_plan(mp, kp, np_, n, out_form, ocp, None if tile_map is None else tile_map.tile_k, bnt)


@functools.lru_cache(maxsize=None)
def _cached_signed_plan(mp: int, kp: int, np_: int, n: int, out_form: str, ocp: int,
                        tile_k: Optional[int], bnt: Optional[int]) -> Plan:
    if out_form not in ("digits", "f32", "i32", "plane", "words"):
        raise ValueError(f"unknown out_form {out_form!r}")
    ncomp = min(round_up(max(n, 1), 8), np_ if out_form == "digits" else ocp)
    if bnt is None:
        bnt = next((t for t in (16, 32) if ncomp <= t), 64)
    tiles = (-(-ncomp // bnt), mp // SIGNED_ROWS)
    steps = -(-kp // SIGNED_STEP) // 2 if tile_k is None else kp // tile_k
    words = out_form == "words"
    splits = max(1, min(PACK_SPLIT if words else MAX_SPLIT, SIGNED_RESIDENT // (tiles[0] * tiles[1]), steps))
    return Plan(bnt=bnt, splits=splits, cluster=(1, PACK_GROUP // SIGNED_ROWS if words else 1, splits),
                grid=(*tiles, splits))


def _plan_form(out_bits: Optional[int], out_form: str, raw_i32: bool) -> str:
    """The wrapper's output arguments as :func:`packmm_plan`'s form."""
    if out_bits is None:
        return "i32" if raw_i32 else "f32"
    if out_form != "packed":
        return "digits"
    return "plane" if packed_signed(out_bits) else "words"


def _check(a: PackedTensor, b: DigitTensor, out_form: str = "digits",
           out_cols: Optional[int] = None, tile_map: Optional[TileMap] = None) -> int:
    """The K2 checks (a map's tile_m a multiple of the 256-row group, as
    JAX requires); returns the stored columns."""
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"contraction mismatch: {a.shape} @ {b.shape}")
    nd_a, _, kp = a.words.shape
    nd_b, kp_b, np_ = b.digits.shape
    if kp != kp_b:
        raise ValueError(f"padded K mismatch: lhs {kp} vs rhs {kp_b}")
    if nd_a != 1:
        raise ValueError(f"a packed A holds one plane, got {nd_a}")
    _gemm.check_accumulator(nd_a, nd_b, kp, signed=packed_signed(a.bits))
    if tile_map is not None:
        _gemm.check_tile_map(tile_map, a.padded_rows, kp, a.words.device, PACK_GROUP)
    return _stored_cols(out_form, out_cols, np_)


def _no_map_with_prepared(tile_map: Optional[TileMap]) -> None:
    if tile_map is not None:
        raise ValueError(
            "PreparedRHS runs the dense streaming kernel; pass a DigitTensor RHS "
            "for sparse/tiled schedules"
        )


def _check_signed(a: PackedTensor, bp: PreparedRHS, out_form: str,
                  out_cols: Optional[int]) -> Tuple[int, bool]:
    """The K4 checks; returns the stored columns and whether the lanes
    >= N of the stored region are masked back to level 0 (the ones lane's
    junk and the padding columns)."""
    if not packed_signed(a.bits):
        raise ValueError("PreparedRHS pairs with a signed-plane A (bits 5-8)")
    M, Ka = a.shape
    Kb, N = bp.shape
    if Ka != Kb:
        raise ValueError(f"contraction mismatch: {a.shape} @ {bp.shape}")
    kp = a.words.shape[2]
    kpb, np_ = bp.plane.shape
    if kp != kpb:
        raise ValueError(f"padded K mismatch: lhs {kp} vs rhs {kpb}")
    # dot + rowsum + colsum + constant, each <= 128^2 * kp
    if 4 * 128 * 128 * kp >= (1 << 31):
        raise ValueError(f"padded K={kp} can overflow the int32 accumulator; split the contraction")
    ocp = _stored_cols(out_form, out_cols, np_)
    need_mask = ocp > round_up(max(N, 1), 8) or N % 8 != 0 or (out_cols is None and np_ > N)
    return ocp, need_mask


def _signed_stores(a: PackedTensor, bp: PreparedRHS, out_bits: Optional[int], out_form: str,
                   out_cols: Optional[int]) -> Tuple[int, int]:
    """The stored columns and ``mask_n`` of a PreparedRHS product on the
    card: lanes >= ``mask_n`` are stored as level 0 (the TPU kernel's
    mask, always for digits out; ``np`` where nothing is masked)."""
    ocp, need_mask = _check_signed(a, bp, out_form, out_cols)
    digits_out = out_bits is not None and out_form == "digits"
    return ocp, bp.shape[1] if need_mask or digits_out else bp.plane.shape[1]


def packmm_signed_plain(
    a: PackedTensor,
    bp: PreparedRHS,
    out_bits: Optional[int] = None,
    out_form: str = "digits",
    shift: int = 0,
    raw_i32: bool = False,
    out_cols: Optional[int] = None,
):
    """Plain PyTorch version of the PreparedRHS product on any device: the
    offset algebra literally (the dot in float64, exact below 2^53, then
    int64), the lane mask of the TPU kernel (digit outputs always, the
    others under ``need_mask``), then its stores. Returns what the
    wrapper returns, padding included: rows >= M come out as level 0."""
    ocp, need_mask = _check_signed(a, bp, out_form, out_cols)
    M, N = a.shape[0], bp.shape[1]
    np_ = bp.plane.shape[1]
    acc = _gemm.plain_product(a.words[0], bp.plane)
    acc = acc + (acc[:, np_ - 1:] << 7) + bp.corr[0].to(torch.int64)
    real = torch.arange(np_, device=acc.device) < N

    def mask(v, force=False):
        return torch.where(real, v, torch.zeros_like(v)) if need_mask or force else v

    if out_bits is None:
        return _gemm.plain_epilogue(mask(acc), (M, N), None, 0, raw_i32, ocp)
    r = requantize_wrapped(acc, out_bits, shift)
    if out_form == "digits":
        return DigitTensor(digits=split_digits(mask(r, force=True), out_bits), shape=(M, N), bits=out_bits)
    return PackedTensor(words=_pack_levels(mask(r)[:, :ocp], out_bits), shape=(M, N), bits=out_bits)


def packmm_plain(
    a: PackedTensor,
    b: Rhs,
    out_bits: Optional[int] = None,
    shift: int = 0,
    raw_i32: bool = False,
    out_form: str = "digits",
    out_cols: Optional[int] = None,
    tile_map: Optional[TileMap] = None,
):
    """Plain PyTorch version on any device: decode A to levels, weight
    them by how often ``tile_map`` visits their tile (``_gemm.tile_weights``;
    for a signed-plane A the kernel drops a skipped tile's dot and its
    colsum correction together, which is exactly this), take the levels
    product, then the kernel's epilogue. Returns what the matching
    wrapper returns; a :class:`PreparedRHS` goes to
    :func:`packmm_signed_plain`."""
    if isinstance(b, PreparedRHS):
        _check_signed(a, b, out_form, out_cols)
        _no_map_with_prepared(tile_map)
        return packmm_signed_plain(a, b, out_bits, out_form, shift, raw_i32, out_cols)
    ocp = _check(a, b, out_form, out_cols, tile_map)
    acc = _gemm.plain_product(packed_levels(a), digit_levels(b), tile_map)
    shape = (a.shape[0], b.shape[1])
    if out_bits is None or out_form != "packed":
        return _gemm.plain_epilogue(acc, shape, out_bits, shift, raw_i32, ocp)
    levels = requantize_wrapped(acc, out_bits, shift)[:, :ocp]
    return PackedTensor(words=_pack_levels(levels, out_bits), shape=shape, bits=out_bits)


def _packmm(a: PackedTensor, b: Rhs, out_bits, out_form, shift, raw_i32, out_cols=None,
            tile_map=None, _plan: Optional[Plan] = None):
    """Every ``packmm_*`` wrapper. ``_plan`` replaces the launch that
    :func:`packmm_plan` (a 1/2/4-bit A) or :func:`packmm_signed_plan` (a
    5-8-bit A) chooses on the card (the CUDA tests force each split and
    column tile with it); the kernel refuses a plan it cannot run."""
    global LAUNCHES, MAPPED_LAUNCHES, SIGNED_LAUNCHES
    shape = (a.shape[0], b.shape[1])
    form = _plan_form(out_bits, out_form, raw_i32)
    if isinstance(b, PreparedRHS):
        ocp, mask_n = _signed_stores(a, b, out_bits, out_form, out_cols)
        _no_map_with_prepared(tile_map)
        if not a.words.is_cuda:
            return packmm_signed_plain(a, b, out_bits, out_form, shift, raw_i32, out_cols)
        kp, np_ = b.plane.shape
        if b.corr.device != a.words.device or b.corr.shape != (8, np_):
            raise ValueError(f"corr {tuple(b.corr.shape)} on {b.corr.device} does not fit")
        plane_t = b.plane_t
        if plane_t is None or plane_t.shape != (np_, kp) or plane_t.device != a.words.device:
            raise ValueError(f"the kernel takes the plane transposed, [{np_}, {kp}] on {a.words.device} "
                             "(prepare_rhs makes it)")
        plan = _plan or packmm_signed_plan(a.padded_rows, a.padded_cols, np_, mask_n, form, ocp)
        out = _gemm.launch(
            "qgtc_packmm_signed", a.words, torch.int8, plane_t, a.padded_rows, shape,
            out_bits, out_form, shift, raw_i32, ocp,
            head=(_gemm._operand(b.corr, torch.int32, "corr"),),
            tail=(mask_n, plan.bnt, *plan.grid, *plan.cluster), b_dims=(kp, np_),
        )
        SIGNED_LAUNCHES += 1
    else:
        ocp = _check(a, b, out_form, out_cols, tile_map)
        if not a.words.is_cuda:
            return packmm_plain(a, b, out_bits, shift, raw_i32, out_form, out_cols, tile_map)
        signed = packed_signed(a.bits)
        plan = _plan or (packmm_signed_plan if signed else packmm_plan)(
            a.padded_rows, a.padded_cols, b.padded_cols, b.shape[1], form, ocp, tile_map)
        out = _gemm.launch(
            "qgtc_packmm", a.words, torch.int8 if signed else torch.int32,
            b.digits, a.padded_rows, shape, out_bits, out_form, shift, raw_i32, ocp,
            head=(field_width(a.bits), b.ndigits),
            tail=(*_gemm.map_args(tile_map), b.shape[1], plan.bnt, *plan.grid, *plan.cluster),
        )
        LAUNCHES += 1
        MAPPED_LAUNCHES += tile_map is not None
    if out_bits is not None and out_form == "packed":
        return PackedTensor(words=out, shape=shape, bits=out_bits)
    return out


def packmm_to_digits(
    a: PackedTensor, b: Rhs, out_bits: int, tile_map: Optional[TileMap] = None, shift: int = 0
) -> DigitTensor:
    """Packed-A GEMM, requantized digit-plane output over the whole
    padded extent (``bitMM2Bit`` role with the fused epilogue)."""
    return _packmm(a, b, out_bits, "digits", shift, False, tile_map=tile_map)


def packmm_to_f32(
    a: PackedTensor, b: Rhs, tile_map: Optional[TileMap] = None, out_cols: Optional[int] = None
) -> torch.Tensor:
    """Packed-A GEMM, float32 [M, N] output (``bitMM2Int`` role);
    ``out_cols`` narrows the store to the real column count."""
    return _packmm(a, b, None, "f32", 0, False, out_cols, tile_map)


def packmm_to_i32(a: PackedTensor, b: Rhs, tile_map: Optional[TileMap] = None) -> torch.Tensor:
    """Packed-A GEMM, raw int32 accumulator [M, N]."""
    return _packmm(a, b, None, "f32", 0, True, tile_map=tile_map)


def packmm_to_packed(
    a: PackedTensor, b: Rhs, out_bits: int, tile_map: Optional[TileMap] = None, shift: int = 0,
    out_cols: Optional[int] = None,
) -> PackedTensor:
    """Packed-A GEMM, M-packed output: bit in, bit out (the reference's
    ``bitMM2Bit_profile`` op): requantize, then repack in the kernel.
    ``out_cols`` narrows the store to the real column count."""
    return _packmm(a, b, out_bits, "packed", shift, False, out_cols, tile_map)
