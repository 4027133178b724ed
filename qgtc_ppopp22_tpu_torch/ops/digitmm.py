"""Digit planes x digit planes with the fused requantize epilogue.

Counterpart of ``qgtc_ppopp22_tpu/ops/digitmm.py`` (TPU kernel
``_digitmm``): ``C = sum_{d,e} dot(A_d, B_e) << 4*(d+e)`` in int32, then
requantized into digit planes (``digitmm_to_digits``) or stored raw as
float32 / int32. It carries the step engine's ``H x W`` updates. A
``TileMap`` (``tile_map=``, :func:`build_tile_map_digits`) makes each
row tile visit only the K tiles it lists (the block-sparse K skip).

Dispatch: operands on the CPU run :func:`digitmm_plain`; operands on a
CUDA device launch the kernel of ``csrc/digitmm.cu`` or raise.
"""

from __future__ import annotations

from typing import Optional

import torch

from qgtc_ppopp22_tpu_torch.ops import _gemm
from qgtc_ppopp22_tpu_torch.ops.bitgemm import TileMap, _pick_tile
from qgtc_ppopp22_tpu_torch.ops.digits import DigitTensor, digit_levels

LAUNCHES = 0  # kernel launches since the count was last reset to 0
MAPPED_LAUNCHES = 0  # those of them given a TileMap, likewise


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


def _digitmm(a: DigitTensor, b: DigitTensor, out_bits, shift, raw_i32, tile_map=None):
    global LAUNCHES, MAPPED_LAUNCHES
    _check(a, b, tile_map)
    if not a.digits.is_cuda:
        return digitmm_plain(a, b, out_bits, shift, raw_i32, tile_map)
    out = _gemm.launch(
        "qgtc_digitmm", a.digits, torch.int8, b.digits, a.padded_rows,
        (a.shape[0], b.shape[1]), out_bits, "digits", shift, raw_i32,
        head=(a.ndigits, b.ndigits), tail=_gemm.map_args(tile_map),
    )
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
