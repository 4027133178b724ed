"""Experiment: the packed-A GEMM's unpack, on the card (port of
``benchmarks/exp_packmm.py``).

A is bit-packed along M into int32 words: logical row ``q*(4*ms) + 4*i +
k`` of an M-tile of ``tm`` rows lives in bits ``8k + f*q ..`` of word row
``i`` (f = field bits, P = 8/f fields per byte, ms = tm / (32/f)). The
port's ``ops/packmm`` layout is the ``tm = 256`` case. Two products over
it, each a hand-written kernel (``csrc/exp_packmm.cuh``) with a plain
PyTorch version:

* :func:`packmm_exp`: words x int8 B -> float32 A.B, in five variants
  (``VARIANTS``: concat, slabs, noextract, bres, bres_chunk; the JAX
  script's names, the card's mechanisms, in the kernel's source),
  :func:`packmm_exp_int8`, the same product with an int8 A, and
  :func:`packmm_exp_rowrange`, concat on K2's 64-row ranges: one ring
  loop whose CTAs own whole word rows (as the packed output's), split-K
  over a cluster, sized by :func:`exp_packmm_plan`;
* :func:`packmm_exp_packedout`: the requantized product repacked in A's
  layout, per ``group`` rows (the reference's ``bitMM2Bit_profile`` op), by
  a kernel of its own (``csrc/exp_packmm_packed.cu``) whose CTAs own whole
  word rows, each word read once and written once (:func:`packedout_plan`,
  :func:`word_row_ctas`): timed beside K2's packed route at the same
  shapes, it reads what K2's row ranges of a 256-row group cost.

The card's question: what a K step of the probes' ring loop
(``csrc/probe_ring.cuh``) spends on the unpack of A, on staging it in
shared memory and on the MMAs. :func:`ladder` times every variant on that
loop beside K2 (``packmm_to_f32``) and ``torch._int_mm`` on the unpacked
operands, and reports us per call, us per K step (of the plan's depth)
and TFLOP/s (``2*M*N*K``).

Dispatch: CPU tensors run the plain versions; CUDA tensors launch the
kernel (``LAUNCHES``, ``PACKEDOUT_LAUNCHES``) or raise. ``tk`` (a TPU
block size) is accepted and unused: the plan sets the K step.

Usage (needs a CUDA device)::

    python -m qgtc_ppopp22_tpu_torch.benchmarks.exp_packmm [--csv out.csv] [--iters 20]
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from qgtc_ppopp22_tpu_torch.ops import _gemm
from qgtc_ppopp22_tpu_torch.ops._gemm import SMS
from qgtc_ppopp22_tpu_torch.ops._build import check, library
from qgtc_ppopp22_tpu_torch.ops.bitgemm import flops_convention
from qgtc_ppopp22_tpu_torch.ops.bitpack import round_up, u32_to_i32
from qgtc_ppopp22_tpu_torch.ops.quantize import requantize_wrapped

VARIANTS = ("concat", "slabs", "noextract", "bres", "bres_chunk")
_CODE = {"concat": 0, "slabs": 1, "noextract": 2, "bres": 3, "bres_chunk": 4, "int8": 5,
         "rowrange": 6}  # csrc Variant
K_STEP = 64  # the shallowest K step of the probes' ring (a multiple of it divides Kp)
_SMEM_LIMIT = 227 * 1024  # an H100 CTA's shared memory
# The per-K-step ladder: (M = K, N, bits); C1's aggregation first
C1_SHAPE = (2560, 16, 1)
LADDER_SHAPES = (C1_SHAPE,) + tuple((4096, n, b) for n in (16, 64) for b in (1, 2, 4))
# The JAX script's run_packedout rows (:318-331): M, K, N, bits, tm, tk, group
PACKEDOUT_ROWS = (
    (4096, 4096, 16, 1, 4096, 4096, 0), (4096, 4096, 16, 1, 2048, 4096, 0),
    (4096, 4096, 16, 1, 4096, 4096, 256), (4096, 4096, 16, 1, 4096, 4096, 512),
    (4096, 4096, 16, 1, 2048, 2048, 0), (2048, 2048, 16, 1, 2048, 2048, 0),
    (2048, 2048, 16, 1, 2048, 2048, 256), (1024, 1024, 16, 1, 1024, 1024, 0),
    (4096, 4096, 16, 2, 4096, 4096, 256), (4096, 4096, 64, 1, 4096, 4096, 256),
)

# the launch choices of the two ring kernels, P1a's f32 product
# (csrc/exp_packmm.cuh) and P1b's packed output (csrc/exp_packmm_packed.cu)
TILES = (16, 32, 64)  # column tiles
STAGES = (4, 3)  # ring depths, K1's
DEPTHS = (64, 128, 256)  # columns of the contraction a K step holds
MAX_SPLIT = 8  # CTAs of a split-K cluster: a portable cluster
RESIDENT = 2 * SMS  # the CTAs the default split fills: two an SM
CTA_ROWS = 64  # logical rows a CTA owns

LAUNCHES = 0  # csrc/exp_packmm.cu launches since the count was last reset to 0
PACKEDOUT_LAUNCHES = 0  # csrc/exp_packmm_packed.cu launches, likewise


def field_bits(bits: int) -> int:
    for f in (1, 2, 4):
        if bits <= f:
            return f
    return 8  # no packing


def pack_rows_np(q: np.ndarray, bits: int, tile_m: int) -> np.ndarray:
    """int levels (Mp, Kp) -> int32 words [Mp // (32/f), Kp], permuted
    per M-tile so in-kernel extraction lands rows in order."""
    f = field_bits(bits)
    assert f < 8
    P = 8 // f
    rpw = 32 // f  # rows per word
    Mp, Kp = q.shape
    assert Mp % tile_m == 0 and tile_m % rpw == 0
    ms = tile_m // rpw
    words = np.zeros((Mp // rpw, Kp), np.uint32)
    vals = q.astype(np.uint32) & np.uint32((1 << f) - 1)
    for t in range(Mp // tile_m):
        for qf in range(P):
            for k in range(4):
                # rows r = t*tile_m + qf*(4*ms) + 4*i + k, i in [0, ms)
                rows = vals[
                    t * tile_m + qf * 4 * ms + k : t * tile_m + (qf + 1) * 4 * ms : 4,
                    :,
                ]
                words[t * ms : (t + 1) * ms, :] |= rows << np.uint32(8 * k + f * qf)
    return words.view(np.int32)


def unpack_rows_np(words: np.ndarray, bits: int, tile_m: int) -> np.ndarray:
    f = field_bits(bits)
    P = 8 // f
    rpw = 32 // f
    mw, Kp = words.shape
    Mp = mw * rpw
    w = words.view(np.uint32)
    ms = tile_m // rpw
    out = np.zeros((Mp, Kp), np.int32)
    for t in range(Mp // tile_m):
        for qf in range(P):
            for k in range(4):
                rows = (w[t * ms:(t + 1) * ms, :] >> np.uint32(8 * k + f * qf)) \
                    & np.uint32((1 << f) - 1)
                out[t * tile_m + qf * 4 * ms + k:
                    t * tile_m + (qf + 1) * 4 * ms:4, :] = rows
    return out


# -- the layout in torch, on any device ----------------------------------

def _slot_shifts(f: int, device) -> torch.Tensor:
    """Bit offset ``8k + f*q`` of slot (q, k), shaped [1, P, 1, 4, 1]."""
    q, k = np.meshgrid(np.arange(8 // f), np.arange(4), indexing="ij")
    return torch.as_tensor(8 * k + f * q, dtype=torch.int64, device=device)[None, :, None, :, None]


def _word_slots(words: torch.Tensor, f: int, tm: int) -> torch.Tensor:
    """int32 words [mw, C] -> their unsigned values as int64 [T, 1, ms, 1, C]."""
    ms = tm // (32 // f)
    mw, C = words.shape
    return (words.to(torch.int64) & 0xFFFFFFFF).reshape(mw // ms, 1, ms, 1, C)


def unpack_levels(words: torch.Tensor, bits: int, tm: int) -> torch.Tensor:
    """int32 words [mw, C] in the layout of tile ``tm`` -> int64 levels
    [mw * 32/f, C] in logical row order."""
    f = field_bits(bits)
    w = _word_slots(words, f, tm)
    return ((w >> _slot_shifts(f, words.device)) & ((1 << f) - 1)).reshape(-1, words.shape[1])


def noextract_levels(words: torch.Tensor, bits: int, tm: int) -> torch.Tensor:
    """The ablation's A: logical row ``q*4*ms + 4*i + k`` is byte k of
    word row i, as a signed int8, for every field q (the JAX variant's
    int8 bitcast of the words, repeated P times)."""
    f = field_bits(bits)
    w = _word_slots(words, f, tm)
    k = torch.arange(4, device=words.device).reshape(1, 1, 1, 4, 1)
    byte = (w >> (8 * k)) & 0xFF
    byte = byte - 256 * (byte >= 128).to(torch.int64)
    return byte.expand(-1, 8 // f, -1, -1, -1).reshape(-1, words.shape[1])


def pack_levels(levels: torch.Tensor, bits: int, tm: int) -> torch.Tensor:
    """int levels [Mp, C] in [0, 2^f) -> int32 words [Mp / (32/f), C] in
    the layout of tile ``tm`` (the inverse of :func:`unpack_levels`)."""
    f = field_bits(bits)
    P, rpw = 8 // f, 32 // f
    ms = tm // rpw
    Mp, C = levels.shape
    slots = levels.to(torch.int64).reshape(Mp // tm, P, ms, 4, C) << _slot_shifts(f, levels.device)
    return u32_to_i32(slots.sum(dim=(1, 3)).reshape(Mp // rpw, C))


# -- the products ----------------------------------------------------------

def _shapes(words: torch.Tensor, b: torch.Tensor, bits: int, tm: int):
    """Check JAX's contract (words [1, Mp/rpw, Kp] int32 in the layout of
    tile tm, B [1, Kp, Np] int8; Mp % tm == 0, tm % rpw == 0) ->
    (f, Mp, Kp, Np)."""
    if not 1 <= bits <= 4:
        raise ValueError(f"the packed probe takes 1-4 bit levels, got {bits}")
    f = field_bits(bits)
    rpw = 32 // f
    if words.dtype != torch.int32 or b.dtype != torch.int8:
        raise TypeError(f"expected int32 words and int8 B, got {words.dtype} and {b.dtype}")
    if words.dim() != 3 or words.shape[0] != 1 or b.dim() != 3 or b.shape[0] != 1:
        raise ValueError(f"expected words [1, Mp/rpw, Kp] and B [1, Kp, Np], got "
                         f"{tuple(words.shape)} and {tuple(b.shape)}")
    Mp, Kp, Np = words.shape[1] * rpw, words.shape[2], b.shape[2]
    if b.shape[1] != Kp:
        raise ValueError(f"words have {Kp} columns, B {b.shape[1]} rows")
    if tm <= 0 or Mp % tm or tm % rpw:
        raise ValueError(f"tile tm={tm} must divide Mp={Mp} and be a multiple of {rpw}")
    if b.device != words.device:
        raise ValueError(f"operands on {words.device} and {b.device}")
    return f, Mp, Kp, Np


def _wrap_i32(acc: torch.Tensor) -> torch.Tensor:
    """An exact int64 sum -> the int32 the kernel's accumulator holds."""
    return u32_to_i32(acc & 0xFFFFFFFF)


def packmm_exp_plain(words: torch.Tensor, b: torch.Tensor, bits: int, tm: int,
                     variant: str = "concat", tk: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`packmm_exp`: float32 [Mp, Np]."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; choose from {VARIANTS}")
    _shapes(words, b, bits, tm)
    lv = noextract_levels(words[0], bits, tm) if variant == "noextract" else unpack_levels(words[0], bits, tm)
    return _wrap_i32(_gemm.plain_product(lv, b[0])).to(torch.float32)


def packmm_exp_int8_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`packmm_exp_int8`: float32 [Mp, Np]."""
    _int8_shapes(a, b)
    return _wrap_i32(_gemm.plain_product(a[0], b[0])).to(torch.float32)


def packmm_exp_packedout_plain(words: torch.Tensor, b: torch.Tensor, bits: int, tm: int,
                               group: int = 0, tk: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`packmm_exp_packedout`: int32 words
    [1, Mp / rpw, Np]."""
    g = group or tm
    _shapes(words, b, bits, g)
    acc = _wrap_i32(_gemm.plain_product(unpack_levels(words[0], bits, g), b[0]))
    return pack_levels(requantize_wrapped(acc.to(torch.int64), bits, 0), bits, g)[None]


def _int8_shapes(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"expected int8 A and B, got {a.dtype} and {b.dtype}")
    if a.dim() != 3 or a.shape[0] != 1 or b.dim() != 3 or b.shape[0] != 1 or a.shape[2] != b.shape[1]:
        raise ValueError(f"expected A [1, Mp, Kp] and B [1, Kp, Np], got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    if b.device != a.device:
        raise ValueError(f"operands on {a.device} and {b.device}")


def _kernel_shapes(Mp: int, Kp: int, Np: int, tm: Optional[int]) -> None:
    """What the kernels index beyond JAX's contract: 64-row CTAs, a K step
    of a multiple of 64, a column tile of 16 or more, and layout tiles of
    a multiple of 256 rows."""
    if Mp % 64 or Kp % K_STEP or Np % 16 or (tm is not None and tm % 256):
        raise ValueError(f"the kernel needs Mp % 64, Kp % {K_STEP}, Np % 16 and tm % 256 to be 0, "
                         f"got Mp={Mp} Kp={Kp} Np={Np} tm={tm}")


def _ring_choices(Mp: int, Kp: int, Np: int, bnt: Optional[int], stages: Optional[int],
                  depth: Optional[int]) -> tuple:
    """The column tile, ring depth and K step of a ring kernel's launch
    (each given one checked, each missing one chosen): the deepest K step
    that divides Kp; the narrowest tile that holds Np, else the widest that
    divides it, and where the row CTAs number fewer than 2 an SM, 64
    columns as two tiles of 32 (as K2's ``packmm_plan``); 4 slots."""
    if depth is None:
        depth = next(d for d in reversed(DEPTHS) if Kp % d == 0)
    if depth not in DEPTHS or Kp % depth:
        raise ValueError(f"K step {depth}: the kernel takes one of {DEPTHS} dividing Kp={Kp}")
    if bnt is None:
        bnt = next((t for t in TILES if t >= Np and Np % t == 0), None) \
            or next((t for t in reversed(TILES) if Np % t == 0), None)
        if bnt == 64 and Mp // CTA_ROWS < 2 * SMS:
            bnt = 32
    if bnt not in TILES or Np % bnt:
        raise ValueError(f"column tile {bnt}: the kernel takes one of {TILES} dividing Np={Np}")
    if stages is not None and stages not in STAGES:
        raise ValueError(f"ring depth {stages}: the kernel takes {STAGES}")
    return bnt, stages or STAGES[0], depth


def _split_cap(tiles: tuple, steps: int) -> int:
    """The CTAs an output tile may take: two CTAs an SM over the grid's
    column and row tiles, at most 8 and the K steps."""
    return max(1, min(MAX_SPLIT, RESIDENT // (tiles[0] * tiles[1]), steps))


@dataclasses.dataclass(frozen=True)
class ExpPlan:
    """One launch of P1a's kernel: a grid of ``grid`` = (column tiles, row
    CTAs, ``splits``) CTAs of 64 rows x ``bnt`` columns, the ``splits`` CTAs
    of an output tile one cluster, a ring of ``stages`` slots of K steps
    ``depth`` columns deep, ``smem`` bytes of dynamic shared memory."""

    variant: str
    bnt: int
    splits: int
    stages: int
    depth: int
    grid: tuple
    smem: int


def exp_staged_rows(variant: str, f: int) -> int:
    """The rows of A a CTA stages a K step: its 2 f word rows, K2's 8 (1-bit)
    or 16 word rows (``rowrange``), or 64 int8 rows."""
    return CTA_ROWS if variant == "int8" else ((8 if f == 1 else 16) if variant == "rowrange" else 2 * f)


def exp_packmm_smem(variant: str, f: int, bnt: int, stages: int, depth: int, share: int) -> int:
    """P1a's shared memory (``ExpLayout`` in the source) at a K share of
    ``share`` steps: two int8 A tiles [64][depth + 16] (not slabs, not
    int8), B's two transposed tiles [bnt][depth + 16] (bres and
    bres_chunk: the whole share, [bnt][share * depth + 16]), then the ring
    (the staged rows at a stride of 4 depth + 64 bytes, int8's of depth +
    16, and unless B is resident B's [depth][bnt] a slot) or, after the
    loop, the split's int32 sums [64][bnt + 4], whichever is larger."""
    res = variant in ("bres", "bres_chunk")
    ald = depth + 16
    a_tiles = 0 if variant in ("slabs", "int8") else 2 * CTA_ROWS * ald
    a_ld = depth + 16 if variant == "int8" else 4 * depth + 64
    slot = exp_staged_rows(variant, f) * a_ld + (0 if res else depth * bnt)
    b_tiles = bnt * (share * depth + 16) if res else 2 * bnt * ald
    return a_tiles + b_tiles + max(stages * slot, CTA_ROWS * (bnt + 4) * 4)


def exp_packmm_plan(Mp: int, Kp: int, Np: int, bits: int, tm: int, variant: str, bnt: Optional[int] = None,
                    splits: Optional[int] = None, stages: Optional[int] = None,
                    depth: Optional[int] = None) -> ExpPlan:
    """P1a's launch for ``variant`` (one of ``VARIANTS``, ``int8`` or
    ``rowrange``) at ``Mp`` x ``Kp`` levels, B of ``Np`` columns,
    ``bits``-bit levels in the layout of tile ``tm`` (int8: both unused). A
    CTA owns 64 rows (the word-row map of :func:`word_row_ctas`; int8 and
    rowrange: consecutive rows) and ``bnt`` columns, chosen as
    :func:`packedout_plan` chooses them; K steps of the deepest of 256, 128
    and 64 columns that divides Kp; a cap of ``RESIDENT //
    (column tiles x row CTAs)`` CTAs an output tile, at most 8 and the K
    steps, and the fewest CTAs that give each the cap's share of the steps
    (C1: 10 steps, cap 6, split 5 of 2 steps each), raised where bres's
    resident B share would not fit; 4 ring slots. Each argument given
    forces that choice (a split of 1 to 8, no more than the K steps; 3 or
    4 slots); raises ``ValueError`` on a plan the kernel cannot run (more
    than 227 KB of shared memory included; its C entry refuses the same).

    Measured (an H100 80GB HBM3 at 700 W, ``benchmarks/gemm_times.py
    --probes-only --plans``; ``PERF.md`` §6): 256-deep steps were
    the fastest at C1's 1-bit 2560² x 16 and at 4096² x 64 for concat,
    slabs and int8; at C1 the even split of 5 beat 6 (one CTA of the 6 had
    no step, the rest 2) by ~1 us; 3 or 4 slots read the same."""
    return _cached_exp_plan(Mp, Kp, Np, bits, tm, variant, bnt, splits, stages, depth)


@functools.lru_cache(maxsize=None)
def _cached_exp_plan(Mp, Kp, Np, bits, tm, variant, bnt, splits, stages, depth) -> ExpPlan:
    if variant not in _CODE:
        raise ValueError(f"unknown variant {variant!r}; choose from {tuple(_CODE)}")
    packed = variant != "int8"
    if packed and not 1 <= bits <= 4:
        raise ValueError(f"the packed probe takes 1-4 bit levels, got {bits}")
    if Mp <= 0 or Kp <= 0 or Np <= 0 or Mp % CTA_ROWS or Kp % K_STEP:
        raise ValueError(f"the kernel needs Mp % 64 and Kp % {K_STEP} to be 0, got Mp={Mp} Kp={Kp} Np={Np}")
    if packed and (tm <= 0 or tm % 256 or Mp % tm):
        raise ValueError(f"layout tile tm={tm}: the kernel needs tm % 256 and Mp % tm to be 0 (Mp={Mp})")
    if variant == "rowrange" and tm != 256:
        raise ValueError(f"rowrange reads K2's layout, tm 256, not {tm}")
    bnt, stages, depth = _ring_choices(Mp, Kp, Np, bnt, stages, depth)
    steps = Kp // depth
    tiles = (Np // bnt, Mp // CTA_ROWS)
    f = field_bits(bits) if packed else 8

    def smem(s):
        return exp_packmm_smem(variant, f, bnt, stages, depth, -(-steps // s))

    if splits is None:
        cap = _split_cap(tiles, steps)
        splits = -(-steps // -(-steps // cap))  # the fewest CTAs that give cap's share
        while smem(splits) > _SMEM_LIMIT and splits < min(MAX_SPLIT, steps):
            splits += 1  # bres: a smaller share of B
    if not 1 <= splits <= min(MAX_SPLIT, steps):
        raise ValueError(f"split {splits}: the kernel takes 1..{min(MAX_SPLIT, steps)}")
    if smem(splits) > _SMEM_LIMIT:
        raise ValueError(f"{variant}: {smem(splits)} bytes of shared memory (bnt {bnt}, split {splits}, "
                         f"{stages} slots of {depth} columns) pass the {_SMEM_LIMIT} a CTA has")
    return ExpPlan(variant, bnt, splits, stages, depth, (*tiles, splits), smem(splits))


def bres_fits(Mp: int, Kp: int, Np: int, bits: int, tm: int = 256) -> bool:
    """Whether bres and bres_chunk have a plan at this shape: each CTA's K
    share of B's column tile fits in shared memory whole, at some split."""
    try:
        exp_packmm_plan(Mp, Kp, Np, bits, tm, "bres")
        exp_packmm_plan(Mp, Kp, Np, bits, tm, "bres_chunk")
    except ValueError:
        return False
    return True


def _launch(out, a, b, variant: str, f: int, Mp: int, Kp: int, Np: int, tm: int, plan: ExpPlan):
    if plan.variant != variant:
        raise ValueError(f"a {plan.variant} plan for a {variant} launch")
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = library().qgtc_exp_packmm(out.data_ptr(), _gemm._operand(a, a.dtype, "A"),
                                        _gemm._operand(b, torch.int8, "B"), _CODE[variant], f, Mp, Kp, Np, tm,
                                        plan.bnt, plan.splits, plan.stages, plan.depth, stream)
    check(err, f"qgtc_exp_packmm({variant})")
    return out


def packmm_exp(words: torch.Tensor, b: torch.Tensor, bits: int, tm: int, variant: str = "concat",
               tk: Optional[int] = None, _plan: Optional[ExpPlan] = None) -> torch.Tensor:
    """words int32 [1, Mp/rpw, Kp] (layout tile ``tm``) x B int8 [1, Kp,
    Np] -> float32 [Mp, Np] = A.B exactly (``noextract``: its ablation's
    product, see :func:`noextract_levels`). On the card
    :func:`exp_packmm_plan` sets the launch (``_plan`` forces one)."""
    global LAUNCHES
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; choose from {VARIANTS}")
    if not words.is_cuda:
        return packmm_exp_plain(words, b, bits, tm, variant)
    f, Mp, Kp, Np = _shapes(words, b, bits, tm)
    _kernel_shapes(Mp, Kp, Np, tm)
    plan = _plan or exp_packmm_plan(Mp, Kp, Np, bits, tm, variant)
    out = torch.empty((Mp, Np), dtype=torch.float32, device=words.device)  # written whole
    _launch(out, words, b, variant, f, Mp, Kp, Np, tm, plan)
    LAUNCHES += 1
    return out


def packmm_exp_int8(a: torch.Tensor, b: torch.Tensor, _plan: Optional[ExpPlan] = None) -> torch.Tensor:
    """An int8 A [1, Mp, Kp] x B int8 [1, Kp, Np] -> float32 [Mp, Np]: the
    probe's ring loop with A's 64 rows staged as they are (8 / f times the
    packed bytes); ``_plan`` forces a launch."""
    global LAUNCHES
    if not a.is_cuda:
        return packmm_exp_int8_plain(a, b)
    _int8_shapes(a, b)
    Mp, Kp, Np = a.shape[1], a.shape[2], b.shape[2]
    _kernel_shapes(Mp, Kp, Np, None)
    plan = _plan or exp_packmm_plan(Mp, Kp, Np, 8, 0, "int8")
    out = torch.empty((Mp, Np), dtype=torch.float32, device=a.device)
    _launch(out, a, b, "int8", 8, Mp, Kp, Np, 0, plan)
    LAUNCHES += 1
    return out


@dataclasses.dataclass(frozen=True)
class PackedOutPlan:
    """One launch of the packed output's kernel: a grid of ``grid`` =
    (column tiles, row CTAs, ``splits``) CTAs of 64 rows x ``bnt`` columns,
    the ``splits`` CTAs of an output tile one cluster, a ring of ``stages``
    slots of K steps ``depth`` columns deep, ``smem`` bytes of dynamic
    shared memory."""

    bnt: int
    splits: int
    stages: int
    depth: int
    grid: tuple
    smem: int


def packedout_smem(f: int, bnt: int, stages: int, depth: int) -> int:
    """The packed output's shared memory (``Layout`` in the source): two
    transposed B tiles [bnt][depth + 16], then the ring (2 f word rows at a
    stride of 4 depth + 64 bytes and B's [depth][bnt] a slot) or, after the
    loop, the split's int32 sums [64][bnt + 4] and the levels [bnt][68],
    whichever is larger."""
    ring = stages * (2 * f * (4 * depth + 64) + depth * bnt)
    return 2 * bnt * (depth + 16) + max(ring, CTA_ROWS * (bnt + 4) * 4 + bnt * (CTA_ROWS + 4))


def packedout_plan(Mp: int, Kp: int, Np: int, bits: int, g: int, bnt: Optional[int] = None,
                   splits: Optional[int] = None, stages: Optional[int] = None,
                   depth: Optional[int] = None) -> PackedOutPlan:
    """The packed output's launch at ``Mp`` x ``Kp`` words' rows and
    columns, B of ``Np`` columns, ``bits``-bit levels in the layout of tile
    ``g``. A CTA owns the ``64 / rpw`` word rows that hold 64 rows (see
    :func:`word_row_ctas`) and ``bnt`` columns: the narrowest of 16, 32
    and 64 that holds Np, else the widest that divides it; where the row
    CTAs number fewer than 2 an SM, 64 columns are two tiles of 32 (as K2's
    ``packmm_plan``). K steps of the deepest of 256, 128 and 64 columns
    that divides Kp (a step's barrier and chain of loads cost more than
    its MMAs). The split makes two CTAs an SM, ``RESIDENT //
    (column tiles x row CTAs)``, at most 8 and the K steps; 4 ring slots.
    Each argument given forces that choice (a split of 1 to 8, no more
    than the K steps; 3 or 4 slots); raises ``ValueError`` on a plan the
    kernel cannot run (its C entry refuses the same).

    Measured (``benchmarks/gemm_times.py --probes-only --plans``, one H100
    80GB HBM3 at 700 W, 4 slots): at 1-bit 4096² x 16, K steps of 64 / 128
    / 256 columns took 35.7 / 24.5 / 20.2 us at S 1 and 14.1 / 11.8 / 10.7
    at S 4 (11.8 at S 8, 256); at x 64 on tiles of 32, 26.1 / 21.8 / 20.1
    at S 2 and 29.2 at S 4 (256), on tiles of 64 19.7 at S 2 (256)."""
    return _cached_packedout_plan(Mp, Kp, Np, bits, g, bnt, splits, stages, depth)


@functools.lru_cache(maxsize=None)
def _cached_packedout_plan(Mp, Kp, Np, bits, g, bnt, splits, stages, depth) -> PackedOutPlan:
    if not 1 <= bits <= 4:
        raise ValueError(f"the packed output takes 1-4 bit levels, got {bits}")
    if Mp <= 0 or Kp <= 0 or Np <= 0 or g <= 0 or g % 256 or Mp % g or Kp % K_STEP:
        raise ValueError(f"the kernel needs g % 256, Mp % g and Kp % {K_STEP} to be 0, got Mp={Mp} Kp={Kp} "
                         f"Np={Np} g={g}")
    bnt, stages, depth = _ring_choices(Mp, Kp, Np, bnt, stages, depth)
    steps = Kp // depth
    tiles = (Np // bnt, Mp // CTA_ROWS)
    if splits is None:
        splits = _split_cap(tiles, steps)
    if not 1 <= splits <= min(MAX_SPLIT, steps):
        raise ValueError(f"split {splits}: the kernel takes 1..{min(MAX_SPLIT, steps)}")
    return PackedOutPlan(bnt, splits, stages, depth, (*tiles, splits),
                         packedout_smem(field_bits(bits), bnt, stages, depth))


def word_row_ctas(Mp: int, bits: int, g: int) -> np.ndarray:
    """The packed output kernel's row map: int64 [Mp / 64, 64], the
    logical rows of CTA y in its local order ``q*4*WR + 4*w + k``: CTA y
    owns word rows ``y*WR .. y*WR + WR - 1`` (WR = 64 / rpw), of tile t =
    y*WR // ms from its word row i0 = y*WR % ms, and their rows ``t*g +
    q*4*ms + 4*(i0 + w) + k`` (field q, word row w, byte k)."""
    f = field_bits(bits)
    rpw, wr = 32 // f, 64 * f // 32
    ms = g // rpw
    y, q, w, k = np.meshgrid(np.arange(Mp // CTA_ROWS), np.arange(8 // f), np.arange(wr), np.arange(4),
                             indexing="ij")
    t, i0 = y * wr // ms, y * wr % ms
    return (t * g + q * 4 * ms + 4 * (i0 + w) + k).reshape(Mp // CTA_ROWS, CTA_ROWS)


def packmm_exp_packedout(words: torch.Tensor, b: torch.Tensor, bits: int, tm: int, group: int = 0,
                         tk: Optional[int] = None, _plan: Optional[PackedOutPlan] = None) -> torch.Tensor:
    """words (layout tile ``group or tm``) x B -> the requantized product
    ``r = acc > 2^b ? 2^b - 1 : (acc < 0 ? 1 : acc)``, ``r & (2^b - 1)``,
    repacked per ``group`` rows (0: per ``tm``): int32 [1, Mp/rpw, Np].
    On the card the layout tile is all that ``tm`` and ``group`` set, and
    :func:`packedout_plan` the launch (``_plan`` forces one)."""
    global PACKEDOUT_LAUNCHES
    if not words.is_cuda:
        return packmm_exp_packedout_plain(words, b, bits, tm, group)
    g = group or tm
    f, Mp, Kp, Np = _shapes(words, b, bits, g)
    _kernel_shapes(Mp, Kp, Np, g)
    plan = _plan or packedout_plan(Mp, Kp, Np, bits, g)
    out = torch.empty((1, Mp // (32 // f), Np), dtype=torch.int32, device=words.device)  # written whole
    with torch.cuda.device(words.device):
        err = library().qgtc_exp_packedout(out.data_ptr(), _gemm._operand(words, torch.int32, "A"),
                                           _gemm._operand(b, torch.int8, "B"), f, bits, Mp, Kp, Np, g,
                                           plan.bnt, plan.splits, plan.stages, plan.depth,
                                           torch.cuda.current_stream(words.device).cuda_stream)
    check(err, "qgtc_exp_packedout")
    PACKEDOUT_LAUNCHES += 1
    return out


def packmm_exp_rowrange(words: torch.Tensor, b: torch.Tensor, bits: int,
                        _plan: Optional[ExpPlan] = None) -> torch.Tensor:
    """:func:`packmm_exp`'s concat on K2's rows: CTAs of 64 consecutive
    logical rows, each staging the 8 (1-bit) or 16 word rows that hold them
    (``packmm_k2.cuh``), where concat's CTAs own whole word rows; the port's
    ``tm = 256`` layout only. The same product (plain:
    ``packmm_exp_plain(words, b, bits, 256)``)."""
    global LAUNCHES
    if not words.is_cuda:
        return packmm_exp_plain(words, b, bits, 256)
    f, Mp, Kp, Np = _shapes(words, b, bits, 256)
    _kernel_shapes(Mp, Kp, Np, 256)
    plan = _plan or exp_packmm_plan(Mp, Kp, Np, bits, 256, "rowrange")
    out = torch.empty((Mp, Np), dtype=torch.float32, device=words.device)
    _launch(out, words, b, "rowrange", f, Mp, Kp, Np, 256, plan)
    LAUNCHES += 1
    return out


# -- the studies (CUDA) ------------------------------------------------------

def operands(M: int, K: int, N: int, bits: int, rng, device, np_: Optional[int] = None):
    """JAX ``run_shape``'s draws (A levels, then B levels) -> (qa, qb, B
    int8 [1, K, np_] zero-padded; np_ = N rounded up to 16)."""
    qa = rng.integers(0, 1 << bits, (M, K)).astype(np.int32)
    qb = rng.integers(0, 1 << bits, (K, N)).astype(np.int32)
    b = np.zeros((1, K, np_ or round_up(N, 16)), np.int8)
    b[0, :, :N] = qb
    return qa, qb, torch.from_numpy(b).to(device)


def _time_ms(fns: Dict, iters: int) -> Dict:
    from qgtc_ppopp22_tpu_torch.utils.timing import device_times_ms

    return device_times_ms(fns, iters=iters)


def run_packedout(M: int, K: int, N: int, bits: int, tm: int, tk: int, rng, group: int = 0,
                  iters: int = 20, device="cuda") -> Dict:
    """One of JAX's ``run_packedout`` rows on the card: the kernel's
    output, unpacked, must equal the NumPy requantized product (raises
    ``AssertionError`` if not); then its device time."""
    g = group or tm
    qa, qb, b = operands(M, K, N, bits, rng, device)
    words = torch.from_numpy(pack_rows_np(qa, bits, g)[None]).to(device)
    out = packmm_exp_packedout(words, b, bits, tm, group, tk)
    ub = 1 << bits
    ref = (qa.astype(np.float64) @ qb).astype(np.int64)  # exact: far below 2^53
    ref = np.where(ref > ub, ub - 1, np.where(ref < 0, 1, ref)) & (ub - 1)
    got = unpack_rows_np(out[0].cpu().numpy(), bits, g)[:M, :N]
    if not np.array_equal(got.astype(np.int64), ref):
        raise AssertionError(f"packedout bits={bits} M=K={M} N={N} tm={tm} g={g}: inexact")
    t = _time_ms({0: lambda: packmm_exp_packedout(words, b, bits, tm, group, tk)}, iters)[0] * 1e-3
    return dict(probe="packedout", bits=bits, M=M, K=K, N=N, tm=tm, g=g, us=t * 1e6,
                tflops=flops_convention(M, N, K) / t / 1e12, exact=True)


def ladder_calls(mk: int, n: int, bits: int, rng, device) -> List[tuple]:
    """The ladder's rows at M = K = ``mk``: (name, call, want, depth),
    ``want`` the output the call must equal and ``depth`` the K step the
    row's kernel takes (P1a's: its default plan's; K2's 64; None for
    ``torch._int_mm``). ``bres`` and ``bres_chunk`` run where their plan
    fits (:func:`bres_fits`)."""
    from qgtc_ppopp22_tpu_torch.ops.digits import digit_pack
    from qgtc_ppopp22_tpu_torch.ops.packmm import PackedTensor, packmm_to_f32

    qa, qb, b = operands(mk, mk, n, bits, rng, device)
    tm = 256  # the port's packmm layout
    np_ = b.shape[2]
    words = torch.from_numpy(pack_rows_np(qa, bits, tm)[None]).to(device)
    a8 = torch.from_numpy(qa.astype(np.int8)[None]).to(device)
    ref = packmm_exp_plain(words, b, bits, tm)

    def depth(v):
        return exp_packmm_plan(mk, mk, np_, bits, tm, v).depth

    rows = [(v, lambda v=v: packmm_exp(words, b, bits, tm, v),
             packmm_exp_plain(words, b, bits, tm, v) if v == "noextract" else ref, depth(v))
            for v in VARIANTS if not v.startswith("bres") or bres_fits(mk, mk, np_, bits, tm)]
    rows.append(("int8", lambda: packmm_exp_int8(a8, b), ref, depth("int8")))
    # concat on K2's 64-row ranges, where concat's CTAs own whole word rows
    rows.append(("concat on K2's row ranges", lambda: packmm_exp_rowrange(words, b, bits), ref, depth("rowrange")))
    k2a = PackedTensor(words=words, shape=(mk, mk), bits=bits)
    k2b = digit_pack(torch.from_numpy(qb).to(device), bits)
    rows.append(("K2 packmm_to_f32", lambda: packmm_to_f32(k2a, k2b), ref[:, :n], K_STEP))
    ia, ib = torch.from_numpy(qa.astype(np.int8)).to(device), torch.from_numpy(qb.astype(np.int8)).to(device)
    rows.append(("torch._int_mm", lambda: torch._int_mm(ia, ib), ref[:, :n].to(torch.int32), None))
    return rows


def ladder(shapes=LADDER_SHAPES, iters: int = 20, rng=None, device="cuda") -> List[Dict]:
    """The per-K-step ladder on the card: each row's output checked
    against its plain version first (``AssertionError`` if not equal),
    then every row of a shape timed in one profiler session; ``us_per_step``
    is the call's time over the contraction's steps of the row's depth."""
    rng = np.random.default_rng(0) if rng is None else rng
    out = []
    for mk, n, bits in shapes:
        calls = ladder_calls(mk, n, bits, rng, device)
        for name, run, want, _ in calls:
            if not torch.equal(run(), want):
                raise AssertionError(f"ladder M=K={mk} N={n} bits={bits} {name}: != plain")
        ms = _time_ms({name: run for name, run, _, _ in calls}, iters)
        for name, _, _, depth in calls:
            t = ms[name] * 1e-3
            out.append(dict(probe="ladder", bits=bits, M=mk, K=mk, N=n, row=name, us=t * 1e6, depth=depth,
                            us_per_step=t * 1e6 / (mk // depth) if depth else None,
                            tflops=flops_convention(mk, n, mk) / t / 1e12))
    return out


def ladder_step(r: Dict) -> str:
    """A ladder row's time per K step, with the step's depth."""
    if r["depth"] is None:
        return "no K step"
    return f"{r['us_per_step']:.3f} us per {r['depth']}-deep K step"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--csv", type=str, default=None)
    p.add_argument("--iters", type=int, default=20)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("exp_packmm times the card's kernels and needs a CUDA device")
    from qgtc_ppopp22_tpu_torch.benchmarks.gemm_times import card_line

    print(f"card: {card_line()}", flush=True)
    rng = np.random.default_rng(0)
    rows = []
    for M, K, N, bits, tm, tk, group in PACKEDOUT_ROWS:
        r = run_packedout(M, K, N, bits, tm, tk, rng, group, args.iters)
        print(f"PACKEDOUT bits={bits} M=K={M} N={N} tm={tm} tk={tk} g={r['g']}: "
              f"{r['us']:.2f} us, {r['tflops']:.2f} TFLOPs exact={r['exact']}", flush=True)
        rows.append(r)
    for r in ladder(iters=args.iters):
        print(f"ladder bits={r['bits']} M=K={r['M']} N={r['N']} {r['row']}: {r['us']:.2f} us, "
              f"{ladder_step(r)}, {r['tflops']:.3f} TFLOP/s", flush=True)
        rows.append(r)
    if args.csv:
        from qgtc_ppopp22_tpu_torch.utils.metrics import write_csv

        write_csv(args.csv, rows, sorted({k for r in rows for k in r}))
        print(f"wrote {args.csv}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
