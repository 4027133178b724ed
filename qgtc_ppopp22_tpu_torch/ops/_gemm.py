"""Plumbing shared by the GEMM modules (``digitmm``, ``packmm``,
``bitgemm``): the int32 accumulator guard, the zero-tile map's checks and
visit counts, the plain product and epilogue, the launch plan of the
cluster kernels, and the kernel launch."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from qgtc_ppopp22_tpu_torch.ops._build import check, library
from qgtc_ppopp22_tpu_torch.ops.bitpack import (
    DIGIT_BITS,
    field_width,
    num_digits,
    packed_signed,
    u32_to_i32,
)
from qgtc_ppopp22_tpu_torch.ops.digits import DigitTensor, split_digits
from qgtc_ppopp22_tpu_torch.ops.quantize import requantize_wrapped

OUT_DIGITS, OUT_F32, OUT_I32, OUT_PACKED = 0, 1, 2, 3  # csrc/gemm_core.cuh OutKind
TILE = 64  # the kernels' BM = BN = BK; padded extents must be multiples
SMS = 132  # streaming multiprocessors of an H100 SXM


@dataclasses.dataclass(frozen=True)
class Plan:
    """The launch of a split-K cluster kernel (K2's 1/2/4-bit route, K4,
    K6): the column tile ``bnt``, the ``splits`` CTAs that share each
    output tile (split-K), the thread-block ``cluster`` (x, y, z) and the
    ``grid`` (column tiles, row tiles of the kernel's CTA, splits)."""

    bnt: int
    splits: int
    cluster: Tuple[int, int, int]
    grid: Tuple[int, int, int]


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


def occupancy_schedule(occ: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A bool occupancy grid ``occ[nm, nk]`` of A's tiles -> the
    ``TileMap`` arrays ``(kidx, kcnt)``: per row tile, the occupied K
    tiles first, in order, then the last one repeated (0 where none is
    occupied), as JAX's builders order them."""
    nk = occ.shape[1]
    kcnt = occ.sum(dim=1).to(torch.int32)
    # A stable argsort of "not occupied" puts the occupied tiles first, in order.
    order = torch.argsort((~occ).to(torch.int32), dim=1, stable=True)
    t = torch.arange(nk, device=occ.device)[None, :]
    clamp = torch.minimum(t, (kcnt.to(torch.int64) - 1).clamp(min=0)[:, None])
    return torch.gather(order, 1, clamp).to(torch.int32), kcnt


def check_tile_map(tile_map, mp: int, kp: int, device, row_multiple: int) -> None:
    """The checks a ``TileMap`` (``ops/bitgemm.py``) passes before a
    GEMM over an A of ``mp`` x ``kp`` padded levels visits its tiles:
    ``(tile_m, tile_k)`` divide ``(mp, kp)`` (JAX ``packmm.py:780-789``),
    ``tile_m`` is a multiple of ``row_multiple`` (a kernel CTA's rows lie
    in one row tile) and ``tile_k`` of the kernel's K step, ``kidx`` is
    ``[mp / tile_m, kp / tile_k]`` and ``kcnt`` ``[mp / tile_m]``, both
    on A's device. Raises ``ValueError``, on every device alike."""
    tm, tk = tile_map.tile_m, tile_map.tile_k
    if tm <= 0 or tk <= 0 or mp % tm or kp % tk or tm % row_multiple or tk % TILE:
        raise ValueError(
            f"tile_map tiles {(tm, tk)} do not divide padded dims {(mp, kp)} "
            f"(tile_m must be a multiple of {row_multiple}, tile_k of {TILE})"
        )
    nm, nk = mp // tm, kp // tk
    if tuple(tile_map.kidx.shape) != (nm, nk) or tuple(tile_map.kcnt.shape) != (nm,):
        raise ValueError(
            f"tile_map kidx {tuple(tile_map.kidx.shape)} / kcnt {tuple(tile_map.kcnt.shape)} "
            f"for a {nm} x {nk} tile grid"
        )
    if tile_map.kidx.device != device or tile_map.kcnt.device != device:
        raise ValueError(f"tile_map on {tile_map.kidx.device}, operands on {device}")


def tile_weights(tile_map, rows: int, cols: int) -> torch.Tensor:
    """How many times the schedule visits each element's tile: int64
    [rows, cols]. The kernels add a K tile once per visit (the first
    ``min(kcnt, nk)`` entries of its row); an index outside the grid is
    skipped."""
    kidx = tile_map.kidx.to(torch.int64)
    nm, nk = kidx.shape
    visit = torch.arange(nk, device=kidx.device)[None, :] < tile_map.kcnt.to(torch.int64)[:, None]
    visit &= (kidx >= 0) & (kidx < nk)
    counts = torch.zeros((nm, nk), dtype=torch.int64, device=kidx.device)
    counts.scatter_add_(1, kidx.clamp(0, nk - 1), visit.to(torch.int64))
    full = counts.repeat_interleave(tile_map.tile_m, 0).repeat_interleave(tile_map.tile_k, 1)
    return full[:rows, :cols]


def plain_product(a_levels: torch.Tensor, b_levels: torch.Tensor, tile_map=None) -> torch.Tensor:
    """Exact integer product of two level matrices, in float64.

    The accumulator guard keeps every partial sum below 2^31 < 2^53, so
    the float64 product is exact in any summation order. With a
    ``tile_map``, each of A's tiles counts as often as the map visits it
    (:func:`tile_weights`), and the sum wraps to int32 as the kernels'
    does (a tile listed twice can pass the guard)."""
    if tile_map is not None:
        a_levels = a_levels.to(torch.int64) * tile_weights(tile_map, *a_levels.shape)
    acc = torch.matmul(a_levels.to(torch.float64), b_levels.to(torch.float64)).to(torch.int64)
    if tile_map is not None:
        acc = u32_to_i32(acc & 0xFFFFFFFF).to(torch.int64)
    return acc


def map_args(tile_map) -> tuple:
    """The C arguments ``(kidx, kcnt, tile_m, tile_k)`` of a mapped GEMM
    entry (``csrc/gemm_core.cuh`` ``KMap``): null pointers for none."""
    if tile_map is None:
        return None, None, 0, 0
    return (_operand(tile_map.kidx, torch.int32, "tile_map.kidx"),
            _operand(tile_map.kcnt, torch.int32, "tile_map.kcnt"),
            tile_map.tile_m, tile_map.tile_k)


def plain_epilogue(
    acc: torch.Tensor,
    shape: Tuple[int, int],
    out_bits: Optional[int],
    shift: int,
    raw_i32: bool,
    ocp: Optional[int] = None,
):
    """The kernels' epilogue on a whole padded int accumulator: float32 or
    int32 over the ``ocp`` stored columns (all if None), returned as
    ``[:M, :N]``, or requantized digit planes."""
    M, N = shape
    if out_bits is None:
        v = acc if ocp is None else acc[:, :ocp]
        return (v.to(torch.int32) if raw_i32 else v.to(torch.float32))[:M, :N]
    levels = requantize_wrapped(acc, out_bits, shift)
    return DigitTensor(digits=split_digits(levels, out_bits), shape=shape, bits=out_bits)


def _operand(t: torch.Tensor, dtype: torch.dtype, name: str) -> int:
    """The data pointer of a kernel operand, after the kernels' checks."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
    return t.data_ptr()


def output(out_bits: Optional[int], out_form: str, raw_i32: bool, mp: int, np_: int, ocp: int,
           device) -> Tuple[int, torch.Tensor]:
    """The output kind (``OutKind``) and the buffer the kernel writes whole:
    digit planes [nd, mp, np]; f32 / i32 [mp, ocp]; packed (``out_form
    'packed'``) as the signed byte plane int8[1, mp, ocp] for 5-8 bits,
    else int32 words [1, mp / (32 / f), ocp] (``ops/packmm.py`` layout)."""
    if out_bits is None:
        kind = OUT_I32 if raw_i32 else OUT_F32
        return kind, torch.empty((mp, ocp), dtype=torch.int32 if raw_i32 else torch.float32,
                                 device=device)
    if out_form != "packed":
        return OUT_DIGITS, torch.empty((num_digits(out_bits), mp, np_), dtype=torch.int8,
                                       device=device)
    if packed_signed(out_bits):
        return OUT_PACKED, torch.empty((1, mp, ocp), dtype=torch.int8, device=device)
    rpw = 32 // field_width(out_bits)
    return OUT_PACKED, torch.empty((1, mp // rpw, ocp), dtype=torch.int32, device=device)


def launch(
    entry: str,
    a: torch.Tensor,
    a_dtype: torch.dtype,
    b: torch.Tensor,
    mp: int,
    shape: Tuple[int, int],
    out_bits: Optional[int],
    out_form: str,
    shift: int,
    raw_i32: bool,
    ocp: Optional[int] = None,
    head: tuple = (),
    tail: tuple = (),
    b_dims: Optional[Tuple[int, int]] = None,
):
    """Run the CUDA entry point ``entry`` of the kernel library, whose C
    arguments are ``(out, A, B, *head, mp, kp, np, out_kind, out_bits,
    shift, ocp, *tail, stream)`` (a mapped entry's ``tail`` is
    :func:`map_args`).

    ``b`` is int8[nd_b, kp, np], or laid out otherwise with ``b_dims`` =
    (kp, np) given; ``ocp`` the stored columns of an f32, i32 or packed
    output (np if None). The output is allocated here
    (:func:`output`) and the kernel writes it whole, padding included.
    Returns a ``DigitTensor``, the f32 / i32 ``[:M, :N]``, or the packed
    payload as it is."""
    if b.device != a.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    kp, np_ = b_dims or b.shape[1:]
    if mp % TILE or kp % TILE or np_ % TILE:
        raise ValueError(f"padded extents {(mp, kp, np_)} are not multiples of {TILE}")
    ocp = np_ if ocp is None else ocp
    kind, out = output(out_bits, out_form, raw_i32, mp, np_, ocp, a.device)
    lib = library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = getattr(lib, entry)(
            out.data_ptr(), _operand(a, a_dtype, "A"), _operand(b, torch.int8, "B"), *head,
            mp, kp, np_, kind, out_bits or 0, shift, ocp, *tail, stream,
        )
    check(err, entry)
    if kind == OUT_DIGITS:
        return DigitTensor(digits=out, shape=shape, bits=out_bits)
    return out if kind == OUT_PACKED else out[: shape[0], : shape[1]]
