"""Bit-plane GEMM with the fused requantize + repack epilogue.

Counterpart of ``qgtc_ppopp22_tpu/ops/bitgemm.py`` (TPU kernel
``_bitmm``): both operands are packed :class:`BitTensor`\\ s and

    C = sum_{i < a_bits, j < b_bits} popc(A_i AND B_j) << (i + j)

in int32 (wrapping as int32 does), then either requantized and repacked
into ``out_bits`` bit planes (``bitmm_to_bits``, the reference's
``bitMM2Bit``) or stored as float32 (``bitmm_to_int``, ``bitMM2Int``).
An optional :class:`TileMap` skips the left operand's all-zero
(tile_m x tile_k) tiles (zero-tile jumping).

Dispatch: operands on the CPU run :func:`bitmm_plain`; operands on a
CUDA device launch the one-bit tensor-core kernel of ``csrc/bitmm.cu``
(``bitmm_k6.cuh``) on the launch :func:`bitmm_plan` chooses, or raise.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch

from qgtc_ppopp22_tpu_torch.ops import _gemm
from qgtc_ppopp22_tpu_torch.ops._build import check, library
from qgtc_ppopp22_tpu_torch.ops._gemm import SMS, Plan
from qgtc_ppopp22_tpu_torch.ops.bitpack import (
    ROWS_PER_WORD,
    BitTensor,
    pack_bits,
    round_up,
    u32_to_i32,
    unpack_bits,
)
from qgtc_ppopp22_tpu_torch.ops.quantize import requantize_wrapped

K_STEP = 256  # contraction bits of one K step (csrc/bitmm_k6.cuh KC)
RESIDENT = 4 * SMS  # the kernel's CTAs the card holds at once: what the split fills
MAX_SPLIT = 4  # CTAs that share one output tile (csrc/bitmm_k6.cuh)
MIN_STEPS = 4  # K steps a CTA of a split holds at least

LAUNCHES = 0  # kernel launches since the count was last reset to 0


def flops_convention(m: int, n: int, k: int) -> int:
    """Logical FLOPs of a bit-GEMM, reference convention: ``2*M*N*K``
    whatever the bit widths (``QGTC_device.cu:420-422``)."""
    return 2 * m * n * k


@dataclasses.dataclass(frozen=True)
class TileMap:
    """Block-sparse schedule over the left operand's (M-tile, K-tile)
    grid: ``kidx[i, t]`` is the t-th K-tile to visit for row tile ``i``;
    entries past ``kcnt[i]`` repeat the last valid index."""

    kidx: torch.Tensor  # int32[nm, nk]
    kcnt: torch.Tensor  # int32[nm]
    tile_m: int
    tile_k: int


def _pick_tile(total: int, candidates) -> int:
    for c in candidates:
        if total % c == 0:
            return c
    raise ValueError(f"no tile in {candidates} divides {total}")


def lhs_tiles(a: BitTensor) -> Tuple[int, int]:
    """(tile_m, tile_k) the GEMM uses for this left operand."""
    _, mw, kp = a.planes.shape
    return _pick_tile(mw, (16, 8)) * ROWS_PER_WORD, _pick_tile(kp, (512, 256))


def build_tile_map(
    a: BitTensor, tile_m: Optional[int] = None, tile_k: Optional[int] = None
) -> TileMap:
    """Occupancy map of ``a``'s (tile_m x tile_k) tiles, on ``a``'s
    device. A tile is zero when every word of every plane inside it is
    zero; ``kidx`` lists each row tile's occupied K tiles in order, its
    tail repeating the last one (0 where none is occupied)."""
    auto_m, auto_k = lhs_tiles(a)
    tile_m = auto_m if tile_m is None else tile_m
    tile_k = auto_k if tile_k is None else tile_k
    bits, mw, kp = a.planes.shape
    tmw = tile_m // ROWS_PER_WORD
    if mw % tmw or kp % tile_k:
        raise ValueError(f"tiles {(tile_m, tile_k)} do not divide planes {tuple(a.planes.shape)}")
    nm, nk = mw // tmw, kp // tile_k
    occ = (a.planes.reshape(bits, nm, tmw, nk, tile_k) != 0).any(dim=4).any(dim=2).any(dim=0)
    kidx, kcnt = _gemm.occupancy_schedule(occ)
    return TileMap(kidx=kidx, kcnt=kcnt, tile_m=tile_m, tile_k=tile_k)


def zero_tile_stats(
    a: BitTensor, tile_m: Optional[int] = None, tile_k: Optional[int] = None
) -> dict:
    """Zero-tile-jumping statistics (reference Figure 8b study):
    ``total`` K-tile visits, ``processed`` the non-zero ones."""
    tm = build_tile_map(a, tile_m, tile_k)
    total = int(tm.kidx.numel())
    processed = int(tm.kcnt.sum())
    return {"total": total, "processed": processed, "ratio": processed / max(total, 1)}


def _check(a: BitTensor, b: BitTensor, out_bits: Optional[int],
           tile_map: Optional[TileMap]) -> Tuple[int, int]:
    """The TPU kernel's shape checks (``bitgemm.py:273-296``) plus the
    bit widths the kernel takes; returns its (tile_m, tile_k)."""
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"contraction mismatch: {a.shape} @ {b.shape}")
    _, mw, kp = a.planes.shape
    _, kw, np_ = b.planes.shape
    if kp != kw * ROWS_PER_WORD:
        raise ValueError(f"padded K mismatch: lhs {kp} vs rhs {kw * ROWS_PER_WORD}")
    for name, bits in (("lhs bits", a.bits), ("rhs bits", b.bits), ("out_bits", out_bits)):
        if bits is not None and not 1 <= bits <= 8:
            raise ValueError(f"{name} must be in [1, 8], got {bits}")
    if b.planes.device != a.planes.device:
        raise ValueError(f"operands on {a.planes.device} and {b.planes.device}")
    tm, tk = lhs_tiles(a)
    _pick_tile(np_, (256, 128))
    if tile_map is not None:
        if (tile_map.tile_m, tile_map.tile_k) != (tm, tk):
            raise ValueError(
                f"tile_map built for {(tile_map.tile_m, tile_map.tile_k)}, kernel uses {(tm, tk)}"
            )
        nm, nk = mw * ROWS_PER_WORD // tm, kp // tk
        if tuple(tile_map.kidx.shape) != (nm, nk) or tuple(tile_map.kcnt.shape) != (nm,):
            raise ValueError(f"tile_map of shape {tuple(tile_map.kidx.shape)} for a {nm} x {nk} tile grid")
        if tile_map.kidx.device != a.planes.device or tile_map.kcnt.device != a.planes.device:
            raise ValueError(f"tile_map on {tile_map.kidx.device}, operands on {a.planes.device}")
    return tm, tk


def bitmm_plain(
    a: BitTensor, b: BitTensor, out_bits: Optional[int], tile_map: Optional[TileMap] = None
):
    """Plain PyTorch version on any device: unpack both operands, the
    exact integer product wrapped to int32, then the kernel's epilogue.
    With a ``tile_map`` each tile of A counts as often as the map visits
    it (once if listed, 0 if not). Returns what the matching wrapper
    returns: a BitTensor for ``out_bits``, else float32 [M, N]."""
    _check(a, b, out_bits, tile_map)
    acc = u32_to_i32(_gemm.plain_product(unpack_bits(a), unpack_bits(b), tile_map) & 0xFFFFFFFF)
    if out_bits is None:
        return acc.to(torch.float32)
    return pack_bits(requantize_wrapped(acc, out_bits), out_bits)


def bitmm_plan(mp: int, kp: int, np_: int, n: int, out_form: str,
               tile_map: Optional[TileMap] = None, bnt: Optional[int] = None) -> Plan:
    """The launch geometry of K6 for an A of ``mp`` padded rows and ``kp``
    padded columns against a B of ``n`` real and ``np_`` padded columns.
    ``out_form``: ``"bits"`` (requantized planes) or ``"f32"``; ``bnt``: a
    column tile to take instead of the chosen one
    (``benchmarks/gemm_times.py --plans`` compares them).

    The computed columns are ``round_up(n, 8)`` (at most ``np_``); the
    column tile is the narrowest of 16, 32 and 64 that holds them, 64 above
    that: each column tile transposes A again. The split fills the CTAs
    the card holds at once (4 an SM) where the grid is small:
    ``RESIDENT // (column tiles x row tiles)``, at most 4, with at least
    ``MIN_STEPS`` 256-deep K steps a CTA and, with ``tile_map``, at most
    its K tiles a row. A contraction of fewer steps (an update at K <= 256)
    runs unsplit.

    Measured (``benchmarks/gemm_times.py --plans``, one H100 SXM at 700 W),
    C1's 40 row tiles (10 K steps): to bits at N 16 on a 16-column tile
    6.89 / 5.44 / 5.49 / 5.66 us at S 1 / 2 / 3 / 4; to f32 at N 40 on
    three 16-column tiles 7.36 / 7.42 / 7.12 / 9.27, on one of 64 9.11 /
    7.44 / 8.90 / 8.71; at N 64 on one of 64 9.10 / 7.45 / 8.89 / 8.71, two
    of 32 7.56 / 7.52 / 7.69 / 8.06: the cluster's reduction costs more
    than a split of fewer than 4 steps a CTA saves.

    The plan depends only on these integers (and the map's ``tile_k``), so
    it is computed once per shape."""
    return _cached_plan(mp, kp, np_, n, out_form, None if tile_map is None else tile_map.tile_k, bnt)


@functools.lru_cache(maxsize=None)
def _cached_plan(mp: int, kp: int, np_: int, n: int, out_form: str, tile_k: Optional[int],
                 bnt: Optional[int]) -> Plan:
    if out_form not in ("bits", "f32"):
        raise ValueError(f"unknown out_form {out_form!r}")
    ncomp = min(round_up(max(n, 1), 8), np_)
    if bnt is None:
        bnt = next((t for t in (16, 32) if ncomp <= t), 64)
    tiles = (-(-ncomp // bnt), mp // _gemm.TILE)
    steps = kp // K_STEP // MIN_STEPS
    if tile_k is not None:
        steps = min(steps, kp // tile_k)
    splits = max(1, min(MAX_SPLIT, RESIDENT // (tiles[0] * tiles[1]), steps))
    return Plan(bnt=bnt, splits=splits, cluster=(1, 1, splits), grid=(*tiles, splits))


@functools.lru_cache(maxsize=None)
def _meta(a_bits: int, b_bits: int, mp: int, kp: int, np_: int, out_bits: int, tm: int, tk: int,
          n: int, tile_k: Optional[int], plan: Optional[Plan]) -> ctypes.Array:
    """``qgtc_bitmm``'s int arguments as one host array (``csrc/bitmm.cu``),
    built once per shape and plan: ``plan`` or, if None, :func:`bitmm_plan`'s
    choice (``tile_k``: the map's, None for a dense K)."""
    if plan is None:
        plan = _cached_plan(mp, kp, np_, n, "bits" if out_bits else "f32", tile_k, None)
    ints = (a_bits, b_bits, mp, kp, np_, out_bits, tm, tk, n, plan.bnt, *plan.grid, *plan.cluster)
    return (ctypes.c_int * len(ints))(*ints)


def _launch(a: BitTensor, b: BitTensor, out_bits: Optional[int],
            tile_map: Optional[TileMap], tm: int, tk: int, plan: Optional[Plan]) -> torch.Tensor:
    """Run ``qgtc_bitmm`` on ``plan`` (None: :func:`bitmm_plan`'s); the
    output is allocated here and written whole by the kernel, padding
    included."""
    dev = a.planes.device
    mp, kp, np_ = a.padded_rows, a.padded_cols, b.padded_cols
    if out_bits is None:
        out = torch.empty((mp, np_), dtype=torch.float32, device=dev)
    else:
        out = torch.empty((out_bits, mp // ROWS_PER_WORD, np_), dtype=torch.int32, device=dev)
    a_ptr = _gemm._operand(a.planes, torch.int32, "A planes")
    b_ptr = _gemm._operand(b.planes, torch.int32, "B planes")
    kidx, kcnt, _, _ = _gemm.map_args(tile_map)
    meta = _meta(a.bits, b.bits, mp, kp, np_, out_bits or 0, tm, tk, b.shape[1],
                 None if tile_map is None else tile_map.tile_k, plan)
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.qgtc_bitmm(out.data_ptr(), a_ptr, b_ptr, kidx, kcnt, meta, stream)
    check(err, "qgtc_bitmm")
    return out


def _bitmm(a: BitTensor, b: BitTensor, out_bits: Optional[int], tile_map: Optional[TileMap],
           _plan: Optional[Plan] = None):
    """Both wrappers. ``_plan`` replaces :func:`bitmm_plan`'s choice on the
    card (the CUDA tests force each column tile and split with it); the
    kernel refuses a plan it cannot run."""
    global LAUNCHES
    tm, tk = _check(a, b, out_bits, tile_map)
    if not a.planes.is_cuda:
        return bitmm_plain(a, b, out_bits, tile_map)
    out = _launch(a, b, out_bits, tile_map, tm, tk, _plan)
    LAUNCHES += 1
    M, N = a.shape[0], b.shape[1]
    if out_bits is None:
        return out[:M, :N]
    return BitTensor(planes=out, shape=(M, N), bits=out_bits)


def bitmm_to_bits(
    a: BitTensor, b: BitTensor, out_bits: int, tile_map: Optional[TileMap] = None
) -> BitTensor:
    """``requantize(A_levels @ B_levels, out_bits)`` packed into
    ``out_bits`` planes (reference ``bitMM2Bit``); the output composes
    as either operand of a following multiply."""
    return _bitmm(a, b, out_bits, tile_map)


def bitmm_to_int(a: BitTensor, b: BitTensor, tile_map: Optional[TileMap] = None) -> torch.Tensor:
    """``A_levels @ B_levels`` as float32 [M, N], no requantization
    (reference ``bitMM2Int``, the output layer)."""
    return _bitmm(a, b, None, tile_map)
