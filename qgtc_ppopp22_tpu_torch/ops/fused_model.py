"""Whole-model kernels: a bucket's full model chain in one launch.

Counterpart of ``qgtc_ppopp22_tpu/ops/fused_model.py``: the quantized
``fused_model_epoch`` (K1) and the full-precision baseline
``fused_baseline_epoch`` (K5, at the end of this module).

K1: every stacked batch of a shape bucket runs its
whole 3-layer chain of integer GEMMs, with the requantize step between
layers, inside one launch of the kernel in ``csrc/fused_model.cu``:

  GCN: XW1 -> A(.) -> (.)W2 -> A(.) -> (.)W3 -> A(.) [f32 out]
  GIN: AX -> (.)W1 -> A(.) -> (.)W2 -> A(.) -> (.)W3 [f32 out]

Operands are the JAX package's: the M-packed 1-bit adjacency words
``int32[B, pn/32, pn]``, feature digits ``int8[B, nd_x, pn, xp]`` and
weight ``DigitTensor``s with 1 or 2 base-16 digit planes. Weight digits
must be zero outside each weight's ``shape`` (``digit_pack`` makes them
so): the kernel multiplies only the real widths, rounded up to 32.

``blk_sched`` is the occupancy-compacted block schedule of the JAX
kernel (``runtime.mega_block_sched``): per (batch, row chunk)
``[count, j_0, ..]``, and each aggregation of that chunk multiplies only
the ``count`` listed column blocks. With a real occupancy schedule the
result equals the dense one. ``chunk_occ``, the JAX kernel's predicated
occupancy map (one flag per row chunk, or per row chunk and column
block), is compacted on its device into that schedule
(:func:`chunk_occ_sched`) and runs the same launch. ``resident_a`` names
a TPU residency tier: on the card A is read from device memory (or L2)
either way, so ``False`` is the same launch.

Levels-form X (``x_levels_bits``, 1-8): ``x_stack`` int8[B, 1, pn, xp]
holds each feature's whole level in one byte, as the JAX engine stages
5-8-bit features (JAX takes 1-4 bits too: the split form then has one
digit, masked to the bits). When every weight has a free padded lane (real width
below its padded width, JAX's test) the kernel runs the offset-signed
single-plane chain: every operand one int8 plane of level - 128, one
int8 pass per GEMM, exact rank-1 corrections (``csrc/fused_model_k1.cuh``),
with the weights' planes and correction rows built by
:func:`signed_weights`; an engine builds the weights' operands once
(:func:`pack_mega_weights`) and passes them to every launch. Otherwise it splits the bytes into base-16
digits as it loads them and runs the digit chain. ``MegaPlan.form`` says which ("signed", "split" or
"digits"). JAX's signed kernel also stores its ones-lane bookkeeping in
the last padded logit column (``out_cols`` past ``cp - 8``); here every
padded column is the product's 0.

Dispatch: tensors on the CPU run :func:`fused_model_epoch_plain`;
tensors on a CUDA device launch the kernel or raise, on the launch that
:func:`fused_model_plan` chooses (rows per CTA, CTAs per batch, the
ring's depth and its stages' depth). Not ported:
``unpack_once``, a TPU VMEM tier.

K5 (``csrc/fused_baseline.cu``): the dense bf16 chain of
``models/baselines.sage_forward`` over ``int8[B, pn, pn]`` 0/1 adjacency
stacks and float features, one launch per bucket, dispatched the same
way to :func:`fused_baseline_epoch_plain` on the CPU, on the launch that
:func:`fused_baseline_plan` chooses (batches in flight, CTAs per
batch).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, Optional, Sequence

import numpy as np
import torch

from qgtc_ppopp22_tpu_torch.models.baselines import sage_forward
from qgtc_ppopp22_tpu_torch.models.qmodels import qgcn_forward, qgin_forward
from qgtc_ppopp22_tpu_torch.ops import _gemm
from qgtc_ppopp22_tpu_torch.ops._build import check, library
from qgtc_ppopp22_tpu_torch.ops.bitpack import DIGIT_BITS, num_digits, round_up
from qgtc_ppopp22_tpu_torch.ops.digits import DigitTensor, digit_levels, split_digits
from qgtc_ppopp22_tpu_torch.ops.packmm import PackedTensor

LAUNCHES = 0  # fused_model launches since the count was last reset to 0
LEVELS_LAUNCHES = 0  # those of them with levels-form X (signed or split)
BASELINE_LAUNCHES = 0  # fused_baseline launches, likewise

_RPW = 32  # adjacency rows per packed word (1-bit)
_OFFSET = 128  # the signed chain's operands hold level - 128
_PAD = 32  # padded operand widths are multiples of it
_WIDTH = 16  # the kernel's column granule: real widths round up to it
MAX_LAYERS = 8  # csrc/fused_model_k1.cuh MAX_LAYERS


def mega_colblock(pn: int) -> int:
    """Column-block width of the 2-D zero-block schedule: the smallest
    divisor of ``pn`` that is a multiple of 256 and >= 512, else 256,
    else ``pn`` (one block per chunk). Copy of the JAX function."""
    for w in range(512, pn, 256):
        if pn % w == 0:
            return w
    if pn % 256 == 0 and pn > 256:
        return 256
    return pn


def _round8(n: int) -> int:
    return (n + 7) // 8 * 8


@dataclasses.dataclass(frozen=True)
class MegaPlan:
    """Geometry of one launch, checked against the JAX contract."""

    B: int
    pn: int
    nd_x: int  # X's digit planes (levels form: the digits of x_bits)
    xp: int
    nd_w: int
    nd_h: int
    chunk: int
    nj: int  # column blocks of blk_sched; 0 = dense
    oc: int  # stored logit columns
    widths: List[int]  # per layer: output columns the kernel computes
    form: str = "digits"  # X's form and the chain: "digits", "split", "signed"
    x_bits: int = 0  # levels form: x_levels_bits


def plan(
    a_shape, x_shape, ws: Sequence[DigitTensor], out_bits: int, model: str,
    shifts, out_cols: Optional[int], sched_shape=None, x_levels_bits: Optional[int] = None,
) -> MegaPlan:
    """Check the operands' shapes and return the launch geometry; raises
    ``ValueError`` on what the kernel (and the JAX kernel) refuses."""
    B, pnw, pn = a_shape
    Bx, nd_x, pnx, xp = x_shape
    if pnw * _RPW != pn or pn != pnx or B != Bx:
        raise ValueError(f"bad stacked shapes {tuple(a_shape)} {tuple(x_shape)}")
    form, x_bits = "digits", 0
    if x_levels_bits is not None:
        if nd_x != 1:
            raise ValueError(f"x_levels_bits given but x_stack has {nd_x} planes")
        if not 1 <= x_levels_bits <= 8:
            raise ValueError(f"x_levels_bits must be in [1, 8], got {x_levels_bits}")
        x_bits = int(x_levels_bits)
        nd_x = num_digits(x_bits)  # the int32 guard counts the levels' digits
        # JAX's choice (ops/fused_model.py:442-444): a free padded lane on
        # every weight. Not prepare_rhs's test (round8(N) < np): real widths
        # 121-127 take the signed chain here.
        form = "signed" if all(w.shape[1] < w.padded_cols for w in ws) else "split"
    if model not in ("gcn", "gin"):
        raise ValueError(model)
    if not 1 <= out_bits <= 8:
        raise ValueError(f"out_bits must be in [1, 8], got {out_bits}")
    chunk = next((c for c in (512, 256) if c <= pn and pn % c == 0), None)
    if chunk is None:
        raise ValueError(
            f"pn={pn} has no chunk divisor in (512, 256); packed adjacency "
            "rows come in 256-row groups"
        )
    n = len(ws)
    if not 1 <= n <= MAX_LAYERS:
        raise ValueError(f"{n} layers; the kernel takes 1..{MAX_LAYERS}")
    nd_w = ws[0].ndigits
    if any(w.ndigits != nd_w for w in ws) or nd_w > 2 or nd_x > 2:
        raise ValueError("every weight needs the same 1 or 2 digit planes, X 1 or 2")
    if xp % _PAD or any(w.padded_cols % _PAD for w in ws):
        raise ValueError(f"padded widths must be multiples of {_PAD}")
    if ws[0].padded_rows != xp:
        raise ValueError(f"x width {xp} != first weight's padded rows {ws[0].padded_rows}")
    for prev, w in zip(ws, ws[1:]):
        if w.padded_rows != prev.padded_cols:
            raise ValueError("consecutive weights' padded widths do not chain")
    if shifts is not None and len(shifts) != 2 * n - 1:
        raise ValueError(f"{len(shifts)} shifts for {2 * n - 1} requantizing GEMMs")
    if shifts is not None and any(not 0 <= s <= 31 for s in shifts):
        raise ValueError(f"shifts must lie in [0, 31]: {list(shifts)}")
    cp = ws[-1].padded_cols
    oc = cp if out_cols is None else min(_round8(out_cols), cp)
    widths = [min(round_up(max(w.shape[1], 1), _WIDTH), w.padded_cols) for w in ws]
    widths[-1] = max(widths[-1], round_up(oc, _WIDTH))
    # the int32 guard of every GEMM of the chain
    nd_h = num_digits(out_bits)
    rhs_nd = [nd_x] + [nd_h] * (n - 1) if model == "gin" else [nd_h] * n
    for nd in rhs_nd:  # aggregations: 1-bit A x H over pn
        _gemm.check_accumulator(1, nd, pn)
    lhs_nd = [nd_x] + [nd_h] * (n - 1) if model == "gcn" else [nd_h] * n
    for nd, w in zip(lhs_nd, ws):  # updates: H x W over the padded rows
        _gemm.check_accumulator(nd, nd_w, w.padded_rows)
    nj = 0
    if sched_shape is not None:
        nch = pn // chunk
        if len(sched_shape) != 3 or tuple(sched_shape[:2]) != (B, nch):
            raise ValueError(f"blk_sched shape {tuple(sched_shape)} incompatible with B={B} nch={nch}")
        nj = sched_shape[2] - 1
        if nj < 1 or pn % nj or (pn // nj) % 128:
            raise ValueError(f"blk_sched nj={nj} incompatible with pn={pn}")
    return MegaPlan(B, pn, nd_x, xp, nd_w, nd_h, chunk, nj, oc, widths, form, x_bits)


# -- K1's launch plan (csrc/fused_model_k1.cuh) -------------------------------

K1_ROWS = (128, 64)  # rows per CTA tile (8 or 4 warps of 16 rows): 64 only where 128 does not fit
K1_MAX_CLUSTER = 8  # CTAs per batch: a portable cluster
K1_STAGES = (4, 3)  # depths of the cp.async ring
K1_DEPTHS = (256, 128, 64)  # columns of the contraction a ring stage holds
_XCHUNK = 128  # GCN's first update reads X in column chunks of at most this


@dataclasses.dataclass(frozen=True)
class K1Plan:
    """One launch of K1: ``grid`` = B * ``cl`` CTAs of ``rows // 16`` warps
    in clusters of ``cl`` (one per batch); CTA r of a cluster owns row tiles
    r, r + cl, ... Every aggregation streams its B operand (X or the hidden
    plane) through the ring beside A. ``smem``: dynamic shared memory in
    bytes (``_k1_smem``). ``depth``: the contraction columns of one ring
    stage (one barrier each)."""

    rows: int
    cl: int
    stages: int
    smem: int
    grid: int
    depth: int


def _k1_dims(p: MegaPlan, model: str) -> tuple:
    """(nd_h, nd_w, nd_xm, nd_xd, planes, qws, kins): the planes of H,
    W, X in memory and X as digits after the load (the signed chain has one
    of each); the widths of the hidden planes each aggregation reads, the
    widths the aggregations leave in Q, and each update's contraction."""
    sg = p.form == "signed"
    nd_h, nd_w = (1, 1) if sg else (p.nd_h, p.nd_w)
    nd_xm = 1 if p.form != "digits" else p.nd_x
    nd_xd = 1 if sg else p.nd_x
    w, n, gin = p.widths, len(p.widths), model == "gin"
    planes = w[:n - 1] if gin else w[:n]
    qws = ([p.xp] if gin else []) + w[:n - 1]
    kins = [p.xp] + w[:n - 1]
    return nd_h, nd_w, nd_xm, nd_xd, planes, qws, kins


def _k1_smem(p: MegaPlan, model: str, rows: int, stages: int, depth: int) -> int:
    """K1's dynamic shared memory for one launch (csrc/fused_model_k1.cuh
    ``layout``, the same sums): the aggregation phase (the ring of
    ``depth``-column stages, their word rows padded by 64 bytes and B's rows,
    GIN's transposed X tile) or GCN's first update (X's rows), whichever is
    larger; then Q, the layer's weights, each warp's staging of the hidden
    plane and each ring slot's step (eight ints)."""
    nd_h, nd_w, nd_xm, nd_xd, planes, qws, kins = _k1_dims(p, model)
    gin, lda = model == "gin", depth + 16
    slot_b = max(nd_xm * depth * 64 if gin else 0, nd_h * 64 * lda if planes else 0)
    agg = stages * (8 * (4 * depth + 64) + slot_b) + (2 * nd_xd * 64 * lda if gin else 0)
    front = max(agg, 0 if gin else nd_xd * rows * (min(p.xp, _XCHUNK) + 16))
    q = nd_h * rows * (round_up(max(qws), 32) + 16) if qws else 0
    wt = nd_w * max(nw * (round_up(k, 32) + 16) for nw, k in zip(p.widths, kins))
    return front + q + wt + (rows // 16) * nd_h * 64 * 16 + 8 * 4 * max(K1_STAGES)


def fused_model_plan(p: MegaPlan, model: str, rows: Optional[int] = None, cl: Optional[int] = None,
                     stages: Optional[int] = None, depth: Optional[int] = None) -> K1Plan:
    """K1's launch for the geometry ``p`` (from :func:`plan`) of ``model``,
    cached per shape. Each argument given forces that choice; raises
    ``ValueError`` on a plan the kernel cannot run (the C entry refuses
    the same). Defaults: the first tile height of ``K1_ROWS`` (128 rows,
    else 64) at which some plan fits the shared memory; the cluster that
    gives each CTA the fewest row tiles, the smallest such; the deepest
    stage (256, 128, 64 columns), then 4 stages or 3, that fit."""
    return _cached_k1_plan(p.B, p.pn, p.xp, p.form, p.nd_x, p.nd_w, p.nd_h, tuple(p.widths), model,
                           rows, cl, stages, depth)


@functools.lru_cache(maxsize=None)
def _cached_k1_plan(B, pn, xp, form, nd_x, nd_w, nd_h, widths, model, rows, cl, stages, depth) -> K1Plan:
    p = MegaPlan(B, pn, nd_x, xp, nd_w, nd_h, 512, 0, 8, list(widths), form)
    if model not in ("gcn", "gin"):
        raise ValueError(model)
    if rows is not None and (rows not in K1_ROWS or pn % rows):
        raise ValueError(f"rows per CTA {rows}: the kernel takes {K1_ROWS} dividing pn={pn}")
    if stages is not None and stages not in K1_STAGES:
        raise ValueError(f"ring depth {stages}: the kernel takes {K1_STAGES}")
    if depth is not None and depth not in K1_DEPTHS:
        raise ValueError(f"stage depth {depth}: the kernel takes {K1_DEPTHS}")
    tries = [(r, d, s) for r in ([rows] if rows else K1_ROWS)
             for d in ([depth] if depth else K1_DEPTHS) for s in ([stages] if stages else K1_STAGES)]
    fit = next((t for t in tries if _k1_smem(p, model, t[0], t[2], t[1]) <= _SMEM_LIMIT), None)
    if fit is None:
        r, d, s = tries[-1]
        raise ValueError(f"K1 needs {_k1_smem(p, model, r, s, d)} bytes of shared memory at rows {r}, "
                         f"stages {s}, depth {d}; a block has {_SMEM_LIMIT}")
    rows, depth, stages = fit
    tiles = pn // rows
    if cl is None:
        cl = min(range(1, min(K1_MAX_CLUSTER, tiles) + 1), key=lambda c: (-(-tiles // c), c))
    if not 1 <= cl <= min(K1_MAX_CLUSTER, tiles):
        raise ValueError(f"{cl} CTAs per batch: the kernel takes 1..{min(K1_MAX_CLUSTER, tiles)} "
                         f"over {tiles} row tiles")
    return K1Plan(rows, cl, stages, _k1_smem(p, model, rows, stages, depth), B * cl, depth)


def _refuse_unported(unpack_once) -> None:
    if unpack_once:
        raise NotImplementedError(
            "fused_model_epoch(unpack_once=True) is not yet ported: the TPU's "
            "unpack-once VMEM tier")


def signed_weights(ws: Sequence[DigitTensor]) -> tuple:
    """The signed chain's weight operands -> (planes, corrs): per weight
    its offset-signed plane int8[kp, np] (level - 128) and its correction
    row int32[np], ``128 * colsum + 128^2 * kp`` (JAX's row without its
    ones lane), wrapped to int32 as the kernel's sums are. A level-0 row
    adds ``128 * -128 + 128^2 = 0``, so the row holds for every
    contraction that covers the real rows: the kernel's cover the real
    widths rounded to 32."""
    planes, corrs = [], []
    for w in ws:
        s = digit_levels(w) - _OFFSET
        c = (s.to(torch.int64).sum(dim=0) << 7) + _OFFSET * _OFFSET * s.shape[0]
        corrs.append(((c + (1 << 31)) % (1 << 32) - (1 << 31)).to(torch.int32))
        planes.append(s.to(torch.int8))
    return planes, corrs


def levels_to_digits(x_stack: torch.Tensor, p: MegaPlan) -> torch.Tensor:
    """Levels-form X int8[B, 1, pn, xp] -> the digit planes the chain
    multiplies, int8[B, nd, pn, xp]: the split form masks each digit to
    ``x_bits`` (JAX's x_split); the signed form takes the whole byte
    (level - 128 + 128), as the JAX signed kernel does."""
    levels = x_stack[:, 0].to(torch.int32) & 255
    bits = p.x_bits if p.form == "split" else 8
    return split_digits(levels, bits).transpose(0, 1).contiguous()


def chunk_occ_sched(chunk_occ: torch.Tensor, B: int, pn: int, chunk: int) -> torch.Tensor:
    """The JAX kernel's occupancy map -> the compacted block schedule
    int32[B, nch, nj + 1] (``runtime.mega_block_sched``'s format) on the
    map's device. ``[B, nch]``: a row chunk flagged 0 aggregates nothing,
    one flagged otherwise multiplies its whole row (one block of width
    pn); ``[B, nch, nj]``: each flagged (chunk, column block) is
    multiplied. Both are exactly what the JAX kernel computes. Raises the
    JAX kernel's shape ``ValueError`` s."""
    nch = pn // chunk
    if chunk_occ.ndim == 3:
        nj = chunk_occ.shape[2]
        if tuple(chunk_occ.shape[:2]) != (B, nch) or nj < 1 or pn % nj or (pn // nj) % 128:
            raise ValueError(f"chunk_occ shape {tuple(chunk_occ.shape)} incompatible with "
                             f"B={B} nch={nch} pn={pn}")
        flags = chunk_occ != 0
    else:
        if tuple(chunk_occ.shape) != (B, nch):
            raise ValueError(f"chunk_occ shape {tuple(chunk_occ.shape)} != {(B, nch)}")
        flags = (chunk_occ != 0)[:, :, None]
    cnt = flags.sum(dim=2, keepdim=True)
    # the flagged blocks first, in order; the slots past the count hold 0
    order = torch.argsort((~flags).to(torch.int32), dim=2, stable=True)
    slots = torch.arange(flags.shape[2], device=flags.device)
    listed = torch.where(slots < cnt, order, torch.zeros_like(order))
    return torch.cat([cnt, listed], dim=2).to(torch.int32)


def _block_mask(occ: torch.Tensor, chunk: int, pn: int) -> torch.Tensor:
    """One batch's (row chunk x column block) flags [nch, nj] -> int32
    mask over its packed words [pn/32, pn]: 1 on the flagged blocks."""
    occ = occ.to(torch.int32)
    return occ.repeat_interleave(chunk // _RPW, dim=0).repeat_interleave(pn // occ.shape[1], dim=1)


def _sched_occ(sched: torch.Tensor) -> torch.Tensor:
    """One batch's schedule [nch, nj + 1] -> its listed blocks as flags
    [nch, nj]; raises on a row that is not a schedule."""
    s = sched.cpu().numpy()
    nch, nj = s.shape[0], s.shape[1] - 1
    occ = np.zeros((nch, nj), np.int32)
    for c in range(nch):
        cnt = int(s[c, 0])
        js = s[c, 1:1 + cnt]
        if not 0 <= cnt <= nj or ((js < 0) | (js >= nj)).any() or len(set(js.tolist())) != cnt:
            raise ValueError(f"blk_sched row chunk {c} is not a schedule: {s[c].tolist()}")
        occ[c, js] = 1
    return torch.from_numpy(occ).to(sched.device)


def _exclusive(blk_sched, chunk_occ, resident_a) -> None:
    """The JAX kernel's refusals of combinations (``fused_model.py:579-582``)."""
    if blk_sched is not None and chunk_occ is not None:
        raise ValueError("blk_sched and chunk_occ are exclusive")
    if blk_sched is not None and resident_a is False:
        raise ValueError("blk_sched requires the resident kernel")


def fused_model_epoch_plain(
    a_stack: torch.Tensor,
    x_stack: torch.Tensor,
    ws: Sequence[DigitTensor],
    out_bits: int,
    model: str = "gcn",
    shifts: Optional[Sequence[int]] = None,
    out_cols: Optional[int] = None,
    blk_sched: Optional[torch.Tensor] = None,
    x_cols: Optional[int] = None,
    chunk_occ: Optional[torch.Tensor] = None,
    x_levels_bits: Optional[int] = None,
    packed: Optional[MegaWeights] = None,
) -> torch.Tensor:
    """Plain PyTorch version on any device: each batch's chain through
    ``packmm_plain`` / ``digitmm_plain``, with the blocks that a schedule
    leaves out, or that ``chunk_occ`` flags 0, zeroed in the adjacency
    (the flags are read directly, not through the compacted schedule).
    Levels-form X is split into digit planes first
    (:func:`levels_to_digits`): the integer chain is the same in every
    form. ``packed`` is checked as a launch checks it, then unused: the
    chain reads ``ws``. Returns float32[B, pn, oc]."""
    _exclusive(blk_sched, chunk_occ, None)
    p = plan(a_stack.shape, x_stack.shape, ws, out_bits, model, shifts, out_cols,
             None if blk_sched is None else blk_sched.shape, x_levels_bits)
    if packed is not None:
        _check_packed(packed, ws, p.form, a_stack.device)
    if p.form != "digits":
        x_stack = levels_to_digits(x_stack, p)
    occ = None
    if chunk_occ is not None:
        chunk_occ_sched(chunk_occ, p.B, p.pn, p.chunk)  # the JAX shape checks
        occ = (chunk_occ != 0).reshape(p.B, p.pn // p.chunk, -1).to(a_stack.device)
    fwd = qgcn_forward if model == "gcn" else qgin_forward
    out = torch.zeros((p.B, p.pn, p.oc), dtype=torch.float32, device=a_stack.device)
    for b in range(p.B):
        words = a_stack[b]
        if blk_sched is not None:
            words = words * _block_mask(_sched_occ(blk_sched[b]), p.chunk, p.pn)
        if occ is not None:
            words = words * _block_mask(occ[b], p.chunk, p.pn)
        a = PackedTensor(words=words[None], shape=(p.pn, p.pn), bits=1)
        x = DigitTensor(digits=x_stack[b], shape=(p.pn, ws[0].shape[0]),
                        bits=DIGIT_BITS * x_stack.shape[1])
        logits = fwd(a, x, ws, out_bits, shifts=shifts, plain=True)
        n = min(p.oc, logits.shape[1])
        out[b, :, :n] = logits[:, :n]
    return out


def _weights_blob(planes: Sequence[torch.Tensor]) -> tuple:
    """The weights' int8 planes in one buffer -> (buffer, byte offset of
    each weight); every size is a multiple of 32 (``plan``)."""
    flats = [t.reshape(-1) for t in planes]
    offs = np.cumsum([0] + [f.numel() for f in flats[:-1]]).tolist()
    return torch.cat(flats), offs


@dataclasses.dataclass(frozen=True)
class MegaWeights:
    """K1's weight operands, built once by :func:`pack_mega_weights`: every
    weight's digit planes (``form`` ``"digits"``, which the split chain
    reads too) or its offset-signed plane (``"signed"``) in one int8
    buffer at byte offsets ``offs``; for the signed form also every
    weight's correction row in one int32 buffer at element offsets
    ``c_offs``. ``widths``: per weight (rows, cols, padded rows, padded
    cols, digit planes), which a launch checks."""

    form: str
    blob: torch.Tensor
    offs: List[int]
    corr: Optional[torch.Tensor]
    c_offs: List[int]
    widths: List[tuple]


def _weight_widths(ws: Sequence[DigitTensor]) -> List[tuple]:
    return [(*w.shape, w.padded_rows, w.padded_cols, w.ndigits) for w in ws]


def pack_mega_weights(ws: Sequence[DigitTensor], form: str) -> MegaWeights:
    """K1's weight operands for launches of ``form`` (``MegaPlan.form``:
    ``"digits"``, ``"split"`` or ``"signed"``), on the weights' device.
    Weights do not change between epochs, so an engine builds this once and
    passes it to every launch as ``packed=``: the JAX kernel's host-side
    weight prep, amortized like the reference's out-of-loop weight packing
    (JAX ``ops/fused_model.py:490-516``, ``main_qgtc.py:108-110``)."""
    if form == "signed":  # one plane per operand
        planes, corrs = signed_weights(ws)
        blob, offs = _weights_blob(planes)
        c_offs = np.cumsum([0] + [c.numel() for c in corrs[:-1]]).tolist()
        return MegaWeights("signed", blob, offs, torch.cat(corrs), c_offs, _weight_widths(ws))
    blob, offs = _weights_blob([w.digits for w in ws])
    return MegaWeights("digits", blob, offs, None, [0] * len(ws), _weight_widths(ws))


def _check_packed(packed: MegaWeights, ws: Sequence[DigitTensor], form: str, device: torch.device) -> None:
    """``packed`` must be the operands of ``ws`` for a launch of ``form`` on
    ``device``: its form, every weight's widths and its device."""
    want = "signed" if form == "signed" else "digits"
    if (packed.form, packed.widths, packed.blob.device) != (want, _weight_widths(ws), device):
        raise ValueError(f"packed weights of form {packed.form!r}, widths {packed.widths} on "
                         f"{packed.blob.device}; this launch needs {want!r}, {_weight_widths(ws)} on {device}")


def fused_model_epoch(
    a_stack: torch.Tensor,  # int32[B, pn/32, pn] M-packed 1-bit adjacency
    x_stack: torch.Tensor,  # int8[B, nd_x, pn, xp] digits, or [B, 1, pn, xp] levels
    ws: Sequence[DigitTensor],
    out_bits: int,
    model: str = "gcn",
    shifts: Optional[Sequence[int]] = None,
    out_cols: Optional[int] = None,
    blk_sched: Optional[torch.Tensor] = None,  # int32[B, nch, nj+1]
    x_cols: Optional[int] = None,
    x_levels_bits: Optional[int] = None,
    chunk_occ: Optional[torch.Tensor] = None,
    resident_a: Optional[bool] = None,
    unpack_once: Optional[bool] = None,
    packed: Optional[MegaWeights] = None,
    _plan: Optional[K1Plan] = None,
) -> torch.Tensor:
    """The whole model over every stacked batch in one kernel launch.

    Returns float32 logits [B, pn, oc] with ``oc`` the last weight's
    padded class width, or ``round8(out_cols)`` when given (slices the
    store only). ``shifts``: optional per-GEMM requantize shifts in
    ``qgcn_forward`` / ``qgin_forward`` order. ``x_cols`` is accepted for
    parity with the JAX signature: the JAX kernel uses it only to place
    its ones lane. ``x_levels_bits``: X holds byte levels of that many
    bits (the module's docstring). ``chunk_occ`` (int32[B, nch] or
    [B, nch, nj]) is compacted on the device into a ``blk_sched``
    (:func:`chunk_occ_sched`), exclusive with one.
    ``resident_a`` (None, True or False) is the same launch: on this card
    A is read from device memory or L2 either way; ``blk_sched`` with
    ``False`` is refused, as JAX refuses it. ``packed``: the weights'
    operands from :func:`pack_mega_weights`, built here when absent; one
    of another form, other widths or another device raises ``ValueError``.
    ``_plan`` forces a launch (:func:`fused_model_plan`'s record; tests
    only); on the CPU it is checked against the shape and the plain version
    runs."""
    global LAUNCHES, LEVELS_LAUNCHES
    _refuse_unported(unpack_once)
    _exclusive(blk_sched, chunk_occ, resident_a)
    if not a_stack.is_cuda:
        if _plan is not None:
            _check_forced(_plan, plan(a_stack.shape, x_stack.shape, ws, out_bits, model, shifts, out_cols,
                                      None if blk_sched is None else blk_sched.shape, x_levels_bits), model)
        return fused_model_epoch_plain(a_stack, x_stack, ws, out_bits, model, shifts,
                                       out_cols, blk_sched, x_cols, chunk_occ, x_levels_bits, packed)
    p = plan(a_stack.shape, x_stack.shape, ws, out_bits, model, shifts, out_cols,
             None if blk_sched is None else blk_sched.shape, x_levels_bits)
    kp = fused_model_plan(p, model) if _plan is None else _check_forced(_plan, p, model)
    dev = a_stack.device
    if packed is None:
        packed = pack_mega_weights(ws, p.form)
    else:
        _check_packed(packed, ws, p.form, dev)
    if chunk_occ is not None:  # compacted on the card, into the launch's schedule
        blk_sched = chunk_occ_sched(chunk_occ.to(dev), p.B, p.pn, p.chunk)
        p = dataclasses.replace(p, nj=blk_sched.shape[2] - 1)
    for t, name in ((x_stack, "x_stack"), *((w.digits, "weight") for w in ws),
                    *(((blk_sched, "blk_sched"),) if blk_sched is not None else ())):
        if t.device != dev:
            raise ValueError(f"operands on {dev} and {t.device} ({name})")
    n = len(ws)
    nd_w, nd_h = (1, 1) if p.form == "signed" else (p.nd_w, p.nd_h)  # the signed chain: one plane each
    hw = max(p.widths)
    # the hidden planes P0 / P1, transposed: [B][2][nd_h][hw][pn]
    scratch = torch.empty((p.B, 2, nd_h, hw, p.pn), dtype=torch.int8, device=dev)
    out = torch.empty((p.B, p.pn, p.oc), dtype=torch.float32, device=dev)
    sh = list(shifts) if shifts is not None else [0] * (2 * n - 1)
    x_form = {"digits": 0, "split": 1, "signed": 2}[p.form]  # csrc XForm
    meta = [p.B, p.pn, p.nd_x if p.form != "signed" else 1, p.xp, nd_w, nd_h, n,
            int(model == "gin"), out_bits, p.oc, p.chunk, p.nj, hw, x_form, p.x_bits,
            kp.rows, kp.cl, kp.stages, kp.smem, kp.depth]
    for l, w in enumerate(ws):
        meta += [w.padded_rows, w.padded_cols, p.widths[l], packed.offs[l], packed.c_offs[l]]
    meta += sh
    meta_c = (ctypes.c_int * len(meta))(*meta)
    sched = None
    if blk_sched is not None:
        sched = blk_sched.to(torch.int32).contiguous()
    a = _gemm._operand(a_stack, torch.int32, "a_stack")
    x = _gemm._operand(x_stack, torch.int8, "x_stack")
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.qgtc_fused_model(
            out.data_ptr(), a, x, packed.blob.data_ptr(), None if packed.corr is None else packed.corr.data_ptr(),
            None if sched is None else sched.data_ptr(), scratch.data_ptr(),
            meta_c, len(meta), stream,
        )
    check(err, "qgtc_fused_model")
    LAUNCHES += 1
    LEVELS_LAUNCHES += p.form != "digits"
    return out


def _check_forced(kp: K1Plan, p: MegaPlan, model: str) -> K1Plan:
    """A forced launch must be the plan its own choices give at this
    shape (the C entry checks the same sums); returns it."""
    want = fused_model_plan(p, model, rows=kp.rows, cl=kp.cl, stages=kp.stages, depth=kp.depth)
    if want != kp:
        raise ValueError(f"forced plan {kp} is not the kernel's at this shape: {want}")
    return kp


# -- K5: the full-precision baseline in one launch --------------------------

BASELINE_MAX_LAYERS = 8  # csrc/fused_baseline_k5.cuh MAX_LAYERS
_BF16_WIDTH = 16  # the bf16 MMA's column granule: widths round up to it
_BASELINE_MAX_COLS = 128  # widest padded layer output the kernel takes
_SMEM_LIMIT = 227 * 1024
K5_ROWS = 128  # rows per CTA: two consumer warpgroups of 64
K5_STAGES = 3  # TMA ring slots (4 read 778.8 against 777 us at C1-baseline: PERF.md §6)
_K5_NC = 128  # aggregation columns of a layer in one pass
_K5_KW = 64  # columns of a pass in a layer wider than _K5_NC


@dataclasses.dataclass(frozen=True)
class BaselinePlan:
    """Geometry of one baseline launch."""

    B: int
    pn: int
    xp: int
    cp: int  # stored logit columns: the last weight's width
    hw: int  # hidden planes' width: the widest layer output but the last
    kp: List[int]  # per layer: padded input width
    np: List[int]  # per layer: padded output width


@dataclasses.dataclass(frozen=True)
class K5Plan:
    """One launch of K5: ``grid`` = ``groups`` x ``ctas`` co-resident CTAs
    of ``K5_ROWS`` rows; group g takes batches g, g + groups, ... and CTA r
    of a group its row tiles r, r + ctas, ... ``K5_STAGES`` ring slots of
    ``slot`` bytes; ``kd``: each layer's stage depth; ``smem``: dynamic
    shared memory in bytes (:func:`_k5_layout`)."""

    groups: int
    ctas: int
    kd: tuple
    slot: int
    smem: int
    grid: int


_K5_ALIGN = 1024  # the 128-byte swizzle's atom: slots and the base align to it


def _k5_stage(kd: int, kn: int) -> int:
    return kd * kn * 2 + K5_ROWS * kd


def _k5_layout(kp: Sequence[int], np_: Sequence[int]) -> tuple:
    """(slot, kd, smem) of K5 (csrc/fused_baseline_k5.cuh ``layout``, the
    same sums): a layer's passes take all its input columns up to 128, else
    64 at a time; its stage is 256 columns deep for a pass of <= 32
    columns and 128 for a wider one; ``K5_STAGES`` slots of the largest
    stage, in 1024-byte multiples; then W^T of the widest layer's pass (a
    multi-pass layer stages each pass's columns), the slots' mbarriers and
    1024 bytes to align the base. At most 183,344 bytes at any width the
    kernel takes."""
    kn = [k if k <= _K5_NC else _K5_KW for k in kp]
    kd = tuple(256 if c <= 32 else 128 for c in kn)
    slot = round_up(max(_k5_stage(d, c) for d, c in zip(kd, kn)), _K5_ALIGN)
    wmax = max(n * (c + 8) * 2 for c, n in zip(kn, np_))
    return slot, kd, round_up(K5_STAGES * slot + wmax, 8) + 2 * K5_STAGES * 8 + _K5_ALIGN


def fused_baseline_plan(a_shape, x_shape, w_shapes, *, g: Optional[int] = None, sms: int = _gemm.SMS) -> K5Plan:
    """K5's launch for these operand shapes (after :func:`baseline_plan`'s
    checks) on a card of ``sms`` SMs, cached per shape and card. ``g``
    given forces the batches in flight; raises ``ValueError`` on a plan the
    card cannot hold at once (the C entry refuses the same).

    Default: a batch's row tiles on as many CTAs (one tile each), and as
    many batches in flight as the card holds such groups (one CTA an SM:
    the kernel's 384 threads take 168 registers each; C1: 6 groups of 20
    CTAs). Whether A then stays in L2 across a batch's layers is not shown
    (PERF.md §7)."""
    p = baseline_plan(a_shape, x_shape, w_shapes)
    return _cached_k5_plan(p.B, p.pn, tuple(p.kp), tuple(p.np), g, sms)


@functools.lru_cache(maxsize=None)
def _cached_k5_plan(B, pn, kp, np_, g, sms) -> K5Plan:
    ctas = min(pn // K5_ROWS, sms)
    if g is None:
        g = max(1, min(B, sms // ctas))
    if not 1 <= g <= B or g * ctas > sms:
        raise ValueError(f"{g} groups of {ctas} CTAs: the card holds {sms} of these CTAs at once "
                         f"and the launch has {B} batches")
    slot, kd, smem = _k5_layout(kp, np_)
    return K5Plan(g, ctas, kd, slot, smem, g * ctas)


def _check_forced_k5(kp: K5Plan, a_shape, x_shape, w_shapes, sms: int) -> None:
    """A forced launch must be the plan its own choices give at this shape
    (the C entry checks the same sums)."""
    want = fused_baseline_plan(a_shape, x_shape, w_shapes, g=kp.groups, sms=sms)
    if want != kp:
        raise ValueError(f"forced plan {kp} is not the kernel's at this shape: {want}")


def baseline_plan(a_shape, x_shape, w_shapes) -> BaselinePlan:
    """Check the operands' shapes and return the launch geometry; raises
    ``ValueError`` on what the kernel refuses (the CPU path refuses the
    same, so an engine makes one choice on every device)."""
    B, pn, pn2 = a_shape
    Bx, pnx, xp = x_shape
    if pn != pn2 or pn != pnx or B != Bx:
        raise ValueError(f"bad stacked shapes {tuple(a_shape)} {tuple(x_shape)}")
    if pn % 256:
        raise ValueError(f"pn={pn} has no chunk divisor in (512, 256)")
    if w_shapes and w_shapes[0][0] != xp:
        raise ValueError(f"x width {xp} != first weight's rows {w_shapes[0][0]}")
    kp, np_ = _baseline_widths(w_shapes)
    return BaselinePlan(B, pn, xp, int(w_shapes[-1][1]), max(np_[:-1], default=0), kp, np_)


def _baseline_widths(w_shapes) -> tuple:
    """Padded (input, output) widths of each layer -> (kp, np); raises
    ``ValueError`` on weights the kernel refuses. Every width fits K5's
    shared memory: it stages W^T 128 input columns at a time."""
    n = len(w_shapes)
    if not 1 <= n <= BASELINE_MAX_LAYERS:
        raise ValueError(f"{n} layers; the kernel takes 1..{BASELINE_MAX_LAYERS}")
    for prev, cur in zip(w_shapes, w_shapes[1:]):
        if cur[0] != prev[1]:
            raise ValueError(f"weights {tuple(prev)} and {tuple(cur)} do not chain")
    kp = [round_up(s[0], _BF16_WIDTH) for s in w_shapes]
    np_ = [round_up(s[1], _BF16_WIDTH) for s in w_shapes]
    if max(np_) > _BASELINE_MAX_COLS:
        raise ValueError(f"padded layer widths {np_}: the kernel takes at most "
                         f"{_BASELINE_MAX_COLS} output columns per layer")
    return kp, np_


def fused_baseline_epoch_plain(
    a_stack: torch.Tensor, x_stack: torch.Tensor, ws: Sequence[torch.Tensor]
) -> torch.Tensor:
    """Plain PyTorch version on any device: each batch's
    ``sage_forward`` chain. Returns float32[B, pn, cp]."""
    p = baseline_plan(a_stack.shape, x_stack.shape, [tuple(w.shape) for w in ws])
    out = torch.empty((p.B, p.pn, p.cp), dtype=torch.float32, device=a_stack.device)
    for b in range(p.B):
        out[b] = sage_forward(a_stack[b], x_stack[b].float(), ws)
    return out


@dataclasses.dataclass(frozen=True)
class BaselineWeights:
    """The kernel's weight operand: each weight rounded to bf16 (to
    nearest even), transposed and zero-padded to [np, kp], in one buffer
    at element offsets ``offs``."""

    buf: torch.Tensor
    offs: List[int]
    kp: List[int]
    np: List[int]


def pack_baseline_weights(ws: Sequence[torch.Tensor]) -> BaselineWeights:
    """Build the kernel's weight operand once; weights do not change
    between epochs, so an engine passes the result to every launch."""
    kps, nps = _baseline_widths([tuple(w.shape) for w in ws])
    parts = []
    for w, kp, np_ in zip(ws, kps, nps):
        t = torch.zeros((np_, kp), dtype=torch.bfloat16, device=w.device)
        t[: w.shape[1], : w.shape[0]] = w.t().to(torch.bfloat16)
        parts.append(t.reshape(-1))
    offs = np.cumsum([0] + [t.numel() for t in parts[:-1]]).tolist()
    return BaselineWeights(torch.cat(parts), offs, kps, nps)


def fused_baseline_epoch(
    a_stack: torch.Tensor,  # int8[B, pn, pn] dense 0/1 adjacency
    x_stack: torch.Tensor,  # float32 or bf16 [B, pn, xp] features
    ws: Sequence[torch.Tensor],  # float weights [K, N], chained
    resident_a: Optional[bool] = None,
    packed: Optional[BaselineWeights] = None,
    _plan: Optional[K5Plan] = None,
) -> torch.Tensor:
    """The full-precision model over every stacked batch in one kernel
    launch: per layer ``h = relu((A @ h) @ W)`` with bf16 operands and
    float32 sums, no relu after the last layer. Returns float32 logits
    [B, pn, cp], ``cp = ws[-1].shape[1]``.

    ``packed``: ``pack_baseline_weights(ws)``, built here when absent.
    ``resident_a`` is kept for the JAX package's signature: ``None``,
    ``True`` and ``False`` (the TPU's streamed form) are all the
    kernel's one form. ``_plan`` replaces :func:`fused_baseline_plan`'s
    choice on the card (the CUDA tests and ``chip_smoke.py`` force each
    plan with it); the kernel refuses a plan it cannot run."""
    global BASELINE_LAUNCHES
    w_shapes = [tuple(w.shape) for w in ws]
    dev = a_stack.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count if a_stack.is_cuda else _gemm.SMS
    if _plan is not None:
        _check_forced_k5(_plan, a_stack.shape, x_stack.shape, w_shapes, sms)
    if not a_stack.is_cuda:
        return fused_baseline_epoch_plain(a_stack, x_stack, ws)
    p = baseline_plan(a_stack.shape, x_stack.shape, w_shapes)
    kp5 = _plan or fused_baseline_plan(a_stack.shape, x_stack.shape, w_shapes, sms=sms)
    for t, name in ((x_stack, "x_stack"), *((w, "weight") for w in ws)):
        if t.device != dev:
            raise ValueError(f"operands on {dev} and {t.device} ({name})")
    if x_stack.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x_stack: expected float32 or bfloat16, got {x_stack.dtype}")
    if packed is None:
        packed = pack_baseline_weights(ws)
    elif (packed.kp, packed.np) != (p.kp, p.np) or packed.buf.device != dev:
        raise ValueError(f"packed weights of widths {list(zip(packed.kp, packed.np))} on "
                         f"{packed.buf.device}; this launch needs {list(zip(p.kp, p.np))} on {dev}")
    x = x_stack.float()  # as the JAX kernel's input; exact for bf16
    scratch = torch.empty((p.B * p.pn * (p.kp[0] + 2 * p.hw),), dtype=torch.bfloat16, device=dev)
    bar = torch.zeros((kp5.groups,), dtype=torch.int32, device=dev)
    out = torch.empty((p.B, p.pn, p.cp), dtype=torch.float32, device=dev)
    meta = [p.B, p.pn, p.xp, p.cp, p.kp[0], p.hw, len(ws), kp5.groups, kp5.ctas, kp5.smem]
    for kp, np_, off in zip(p.kp, p.np, packed.offs):
        meta += [kp, np_, off]
    meta_c = (ctypes.c_int * len(meta))(*meta)
    a = _gemm._operand(a_stack, torch.int8, "a_stack")
    xptr = _gemm._operand(x, torch.float32, "x_stack")
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.qgtc_fused_baseline(out.data_ptr(), a, xptr, packed.buf.data_ptr(), scratch.data_ptr(),
                                      bar.data_ptr(), meta_c, len(meta), stream)
    check(err, "qgtc_fused_baseline")
    BASELINE_LAUNCHES += 1
    return out
