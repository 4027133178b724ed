"""Digit planes x digit planes with the fused requantize epilogue.

Counterpart of ``qgtc_ppopp22_tpu/ops/digitmm.py`` (TPU kernel
``_digitmm``): ``C = sum_{d,e} dot(A_d, B_e) << 4*(d+e)`` in int32, then
requantized into digit planes (``digitmm_to_digits``) or stored raw as
float32 / int32. It carries the step engine's ``H x W`` updates. A
``TileMap`` (``tile_map=``, :func:`build_tile_map_digits`) makes each
row tile visit only the K tiles it lists (the block-sparse K skip).

Dispatch: operands on the CPU run :func:`digitmm_plain`; operands on a
CUDA device launch the kernel of ``csrc/digitmm.cu`` or raise, on the
launch that :func:`digitmm_plan` chooses (the real extents, the column
tile, rows per CTA).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch

from qgtc_ppopp22_tpu_torch.ops import _gemm
from qgtc_ppopp22_tpu_torch.ops._build import check, library
from qgtc_ppopp22_tpu_torch.ops.bitgemm import TileMap, _pick_tile
from qgtc_ppopp22_tpu_torch.ops.bitpack import round_up
from qgtc_ppopp22_tpu_torch.ops.digits import DigitTensor, digit_levels

LAUNCHES = 0  # kernel launches since the count was last reset to 0
MAPPED_LAUNCHES = 0  # those of them given a TileMap, likewise

K3_BNTS = (16, 32)  # column tiles (csrc/digitmm_k3.cuh BNT)
K3_ROWS = (64, 32, 16)  # rows per CTA, one warp per 16
K3_KS = 128  # the deepest ring stage, in columns of A
K3_STAGES = 3  # ring slots (csrc/digitmm_k3.cuh STAGES)
K3_MIN_CTAS = 32  # the default rows keep at least this many CTAs
_K_GRANULE, _N_GRANULE = 32, 8  # the int8 MMA's depth and width


@dataclasses.dataclass(frozen=True)
class K3Plan:
    """One launch of K3: ``grid`` = (column tiles of ``bnt``, plus one that
    only stores the padded columns past them where there are any, row tiles
    of ``rows``) CTAs of ``2 * rows`` threads over the real contraction
    ``kr`` and columns ``nr`` (rounded up to the MMA's 32 and 8),
    ``ks``-column steps through a ring of ``K3_STAGES`` slots; ``smem``:
    dynamic shared memory in bytes (:func:`_k3_smem`)."""

    kr: int
    nr: int
    bnt: int
    rows: int
    ks: int
    grid: Tuple[int, int]
    smem: int


def _k3_smem(nd_a: int, nd_b: int, rows: int, bnt: int, ks: int) -> int:
    """K3's dynamic shared memory (csrc/digitmm_k3.cuh ``layout``, the same
    sums): ``K3_STAGES`` slots of A's rows and B's rows as they land, then
    B transposed."""
    ld = ks + 16
    slot = round_up(nd_a * rows * ld + nd_b * ks * bnt, 128)
    return K3_STAGES * slot + nd_b * bnt * ld


def digitmm_plan(nd_a: int, nd_b: int, mp: int, kp: int, np_: int, k: int, n: int,
                 tile_k: Optional[int] = None, bnt: Optional[int] = None,
                 rows: Optional[int] = None) -> K3Plan:
    """K3's launch for an A of ``nd_a`` digit planes, ``mp`` x ``kp`` padded
    and ``k`` real columns, against a B of ``nd_b`` planes, ``np_`` padded
    and ``n`` real columns (``tile_k``: a map's, None for a dense K),
    cached per shape. Each of ``bnt`` and ``rows`` given forces that
    choice (``benchmarks/gemm_times.py --plans`` compares them);
    raises ``ValueError`` on a plan the kernel cannot run (the C entry
    refuses the same).

    The real extents: ``k`` rounded up to 32, ``n`` to 8. The column tile:
    16 up to 64 columns, else 32, over as many tiles as the columns need
    (wider tiles transpose and multiply more per CTA: at C1's N 40 two of
    32 read 3.76 us, three of 16 3.15; one of 64, no longer built, 6.03).
    Rows: the most of 64, 32 and 16 that still give ``K3_MIN_CTAS`` CTAs
    (C1's 2560 rows: 40 CTAs of 64; 16 rows read 4.30 us at X x W0 against
    3.62 at 64). The ring stage: the whole real contraction up to 128
    columns (a map's tile at most); ``K3_STAGES`` slots. (Readings:
    ``benchmarks/gemm_times.py --plans``, one H100 80GB HBM3 at 700 W;
    PERF.md §6.)"""
    return _cached_k3_plan(nd_a, nd_b, mp, kp, np_, k, n, tile_k, bnt, rows)


@functools.lru_cache(maxsize=None)
def _cached_k3_plan(nd_a, nd_b, mp, kp, np_, k, n, tile_k, bnt, rows) -> K3Plan:
    kr = min(round_up(max(k, 1), _K_GRANULE), kp)
    nr = min(round_up(max(n, 1), _N_GRANULE), np_)
    if bnt is None:
        bnt = 16 if nr <= 64 else 32
    if bnt not in K3_BNTS:
        raise ValueError(f"column tile {bnt}: the kernel takes {K3_BNTS}")
    ct = -(-nr // bnt)
    if rows is None:
        rows = next((r for r in K3_ROWS if mp % r == 0 and ct * (mp // r) >= K3_MIN_CTAS), K3_ROWS[-1])
    if rows not in K3_ROWS or mp % rows:
        raise ValueError(f"rows per CTA {rows}: the kernel takes {K3_ROWS} dividing mp={mp}")
    ks = min(kr, K3_KS) if tile_k is None else min(K3_KS, tile_k)
    fill = int(ct * bnt < np_)  # digitmm stores all np_ columns, f32 and i32 too
    return K3Plan(kr, nr, bnt, rows, ks, (ct + fill, mp // rows), _k3_smem(nd_a, nd_b, rows, bnt, ks))


@functools.lru_cache(maxsize=None)
def _meta(nd_a: int, nd_b: int, mp: int, kp: int, np_: int, kind: int, out_bits: int, shift: int,
          ocp: int, tm: int, tk: int, plan: K3Plan) -> ctypes.Array:
    """``qgtc_digitmm``'s int arguments as one host array
    (``csrc/digitmm.cu``), built once per shape and plan."""
    ints = (nd_a, nd_b, mp, kp, np_, kind, out_bits, shift, ocp, tm, tk, plan.kr, plan.nr, plan.bnt,
            plan.rows, plan.ks, *plan.grid, plan.smem)
    return (ctypes.c_int * len(ints))(*ints)


def digit_lhs_tiles(a: DigitTensor):
    """(tile_m, tile_k) of zero-tile schedules over a digit-plane A: 256
    where it divides the padded extent, else 128 (JAX: cluster batches
    skip ~20% of 256 x 256 tiles and ~0% of 512 x 512)."""
    _, mp, kp = a.digits.shape
    return _pick_tile(mp, (256, 128)), _pick_tile(kp, (256, 128))


def build_tile_map_digits(
    a: DigitTensor, tile_m: Optional[int] = None, tile_k: Optional[int] = None
) -> TileMap:
    """Occupancy map over ``a``'s (tile_m x tile_k) digit tiles, on its
    device: per row tile the occupied K tiles first, in order, then the
    last one repeated (JAX ``build_tile_map_digits``)."""
    if tile_m is None or tile_k is None:
        am, ak = digit_lhs_tiles(a)
        tile_m = tile_m or am
        tile_k = tile_k or ak
    nd, mp, kp = a.digits.shape
    nm, nk = mp // tile_m, kp // tile_k
    occ = (a.digits.reshape(nd, nm, tile_m, nk, tile_k) != 0).any(dim=4).any(dim=2).any(dim=0)
    kidx, kcnt = _gemm.occupancy_schedule(occ)
    return TileMap(kidx=kidx, kcnt=kcnt, tile_m=tile_m, tile_k=tile_k)


def zero_tile_stats_digits(
    a: DigitTensor, tile_m: Optional[int] = None, tile_k: Optional[int] = None
) -> dict:
    """Zero-tile statistics (reference Fig. 8b counters): ``total`` K-tile
    visits of a dense schedule, ``processed`` the occupied ones."""
    tm = build_tile_map_digits(a, tile_m, tile_k)
    total = int(tm.kidx.shape[0] * tm.kidx.shape[1])
    processed = int(tm.kcnt.sum())
    return {"total": total, "processed": processed, "ratio": processed / max(total, 1)}


def _check(a: DigitTensor, b: DigitTensor, tile_map: Optional[TileMap] = None) -> None:
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"contraction mismatch: {a.shape} @ {b.shape}")
    nd_a, mp, kp = a.digits.shape
    nd_b, kp_b, _ = b.digits.shape
    if kp != kp_b:
        raise ValueError(f"padded K mismatch: lhs {kp} vs rhs {kp_b}")
    _gemm.check_accumulator(nd_a, nd_b, kp)
    if tile_map is not None:
        _gemm.check_tile_map(tile_map, mp, kp, a.digits.device, _gemm.TILE)


def digitmm_plain(
    a: DigitTensor,
    b: DigitTensor,
    out_bits: Optional[int] = None,
    shift: int = 0,
    raw_i32: bool = False,
    tile_map: Optional[TileMap] = None,
):
    """Plain PyTorch version on any device: the levels product (A's
    levels weighted by how often ``tile_map`` visits their tile), then
    the kernel's epilogue. Returns what the matching wrapper returns."""
    _check(a, b, tile_map)
    acc = _gemm.plain_product(digit_levels(a), digit_levels(b), tile_map)
    return _gemm.plain_epilogue(acc, (a.shape[0], b.shape[1]), out_bits, shift, raw_i32)


def _launch(a: DigitTensor, b: DigitTensor, out_bits, shift, raw_i32, tile_map, plan):
    """Run ``qgtc_digitmm`` on ``plan`` (None: :func:`digitmm_plan`'s); the
    output is allocated here and written whole by the kernel, padding
    included."""
    if b.digits.device != a.digits.device:
        raise ValueError(f"operands on {a.digits.device} and {b.digits.device}")
    nd_a, mp, kp = a.digits.shape
    nd_b, _, np_ = b.digits.shape
    if mp % _gemm.TILE or kp % _gemm.TILE or np_ % _gemm.TILE:
        raise ValueError(f"padded extents {(mp, kp, np_)} are not multiples of {_gemm.TILE}")
    if plan is None:
        plan = digitmm_plan(nd_a, nd_b, mp, kp, np_, a.shape[1], b.shape[1],
                            None if tile_map is None else tile_map.tile_k)
    kind, out = _gemm.output(out_bits, "digits", raw_i32, mp, np_, np_, a.digits.device)
    kidx, kcnt, tm, tk = _gemm.map_args(tile_map)
    meta = _meta(nd_a, nd_b, mp, kp, np_, kind, out_bits or 0, shift, np_, tm, tk, plan)
    a_ptr = _gemm._operand(a.digits, torch.int8, "A")
    b_ptr = _gemm._operand(b.digits, torch.int8, "B")
    lib = library()
    with torch.cuda.device(a.digits.device):
        stream = torch.cuda.current_stream(a.digits.device).cuda_stream
        err = lib.qgtc_digitmm(out.data_ptr(), a_ptr, b_ptr, kidx, kcnt, meta, stream)
    check(err, "qgtc_digitmm")
    shape = (a.shape[0], b.shape[1])
    if kind == _gemm.OUT_DIGITS:
        return DigitTensor(digits=out, shape=shape, bits=out_bits)
    return out[: shape[0], : shape[1]]


def _check_forced(plan: K3Plan, a: DigitTensor, b: DigitTensor, tile_map) -> None:
    """A forced launch must be the plan its own choices give at this shape
    (the C entry checks the same sums)."""
    want = digitmm_plan(a.ndigits, b.ndigits, a.padded_rows, a.padded_cols, b.digits.shape[2], a.shape[1],
                        b.shape[1], None if tile_map is None else tile_map.tile_k, bnt=plan.bnt, rows=plan.rows)
    if want != plan:
        raise ValueError(f"forced plan {plan} is not the kernel's at this shape: {want}")


def _digitmm(a: DigitTensor, b: DigitTensor, out_bits, shift, raw_i32, tile_map=None,
             _plan: Optional[K3Plan] = None):
    """Every wrapper. ``_plan`` replaces :func:`digitmm_plan`'s choice on
    the card (the CUDA tests and ``chip_smoke.py`` force each plan with
    it); the kernel refuses a plan it cannot run."""
    global LAUNCHES, MAPPED_LAUNCHES
    _check(a, b, tile_map)
    if _plan is not None:
        _check_forced(_plan, a, b, tile_map)
    if not a.digits.is_cuda:
        return digitmm_plain(a, b, out_bits, shift, raw_i32, tile_map)
    out = _launch(a, b, out_bits, shift, raw_i32, tile_map, _plan)
    LAUNCHES += 1
    MAPPED_LAUNCHES += tile_map is not None
    return out


def digitmm_to_digits(
    a: DigitTensor, b: DigitTensor, out_bits: int, tile_map: Optional[TileMap] = None,
    shift: int = 0,
) -> DigitTensor:
    """``requantize(A_levels @ B_levels >> shift, out_bits)`` as digit
    planes over the whole padded extent (``bitMM2Bit`` role)."""
    return _digitmm(a, b, out_bits, shift, False, tile_map)


def digitmm_to_f32(a: DigitTensor, b: DigitTensor, tile_map: Optional[TileMap] = None) -> torch.Tensor:
    """``A_levels @ B_levels`` as float32 [M, N] (``bitMM2Int`` role)."""
    return _digitmm(a, b, None, 0, False, tile_map)


def digitmm_to_i32(a: DigitTensor, b: DigitTensor, tile_map: Optional[TileMap] = None) -> torch.Tensor:
    """``A_levels @ B_levels`` as the raw int32 accumulator [M, N]."""
    return _digitmm(a, b, None, 0, True, tile_map)
