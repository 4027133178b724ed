"""Fixed-cost decomposition of the mega kernel, on the card (port of
``benchmarks/grid_overhead_study.py``).

``fused_model`` (K1) runs one thread-block cluster per batch, its CTAs of
128 rows (64 where 128 do not divide pn), and as many CTAs as give each
the fewest row tiles, the smallest such cluster (``fused_model_plan``'s
default rule; :func:`kdot_plan` restates it). This ladder splits what a
batch costs K1 without a profiler of the SMs, both probes on that
geometry:

1. **zero-body** (:func:`zero_body`): K1's geometry, one cluster per ``G``
   batches, reading each batch's X into shared memory and writing zeros:
   the launch, cluster and traffic cost per batch, for G in {1, 5}.
2. **K-dot** (:func:`kdot`): K1's aggregation loop (a ``cp.async`` ring,
   one barrier a 64-deep K step) over S's row tiles and x's K rows, with K
   passes of int8 MMAs on each staged step, ``out[b] = (sum over k < K of
   S . roll(x[b], k))[:, :oc]``; the roll is ``jnp.roll``'s along the 128
   columns (column j moves to j + k), read as an address (pass k reads
   column ``(j - k) mod 128`` for output column j, :func:`roll_column`).
   S is an operand here (the TPU kernel used uninitialised scratch, and
   its x was zero, so its output was zero). Here S and x are random, so
   every pass does real products and the roll's direction shows. K in
   {0, 1, 2} at oc 48, and oc in {8, 48, 120} at K = 0: a step's fixed
   cost, the cost per pass and of the output width.
3. **layer scaling**: K1 itself (``ops.fused_model.fused_model_epoch``)
   at 1, 3 and 5 layers on JAX's ``mega`` inputs (2-bit GCN, hidden 16,
   47 classes, 100 features, 1% dense adjacency, drawn with numpy from
   ``default_rng(0)``), and the layer fit: per-layer slope and intercept.
4. **tiers**: ``resident_a`` True and False (one launch on this card);
   ``unpack_once=True`` is a TPU VMEM tier the port does not have.

Sections 1 and 2 check each call against its plain version once before
they time it (``AssertionError`` if not equal). Section 1 reads each
timed call's X from HBM: the calls take turns over enough copies of X
that a copy has left the L2 before it comes round again. Times are
device times per batch (``utils/timing.device_times_ms``). CPU
tensors run the plain versions of the two probe kernels
(``csrc/grid_overhead.cu``); CUDA tensors launch them
(``ZERO_BODY_LAUNCHES``, ``KDOT_LAUNCHES``) or raise.

Usage (needs a CUDA device)::

    python -m qgtc_ppopp22_tpu_torch.benchmarks.grid_overhead_study [--csv out.csv]
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import itertools
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from qgtc_ppopp22_tpu_torch.ops import _gemm
from qgtc_ppopp22_tpu_torch.ops._build import check, library
from qgtc_ppopp22_tpu_torch.ops.bitpack import u32_to_i32

XCOLS = 128  # kdot's x width, the roll's period
MAX_CLUSTER = 8  # csrc/fused_model_k1.cuh MAX_CLUSTER
ROWS = (128, 64)  # rows per CTA (8 or 4 warps of 16 rows), K1_ROWS: 64 only where 128 do not fit
STAGES = (4, 3)  # depths of kdot's cp.async ring, K1_STAGES
K_STEP = 64  # kdot's K step (csrc/grid_overhead.cu KD)
_TLD = K_STEP + 16  # a row's stride in S's tile and in the transposed x
ZERO_BODY_SHAPES = ((1024, 75), (2048, 50))  # (pn, B)
KDOT_SHAPE = (2048, 50)
KDOT_ROWS = ((0, 8), (0, 48), (0, 120), (1, 48), (2, 48))  # (K, oc)
LAYER_SHAPES = ((512, 75), (2048, 50))
TIER_SHAPES = ((512, 75), (1024, 75), (2048, 50), (2560, 50))
L2_BYTES = 50 * 2 ** 20  # an H100's L2

ZERO_BODY_LAUNCHES = 0  # csrc/grid_overhead.cu zero_body launches since the count was last reset to 0
KDOT_LAUNCHES = 0  # its kdot launches, likewise


def cluster_size(pn: int, rows: int = 64) -> int:
    """K1's default CTAs per batch over ``rows``-row tiles: the fewest row
    tiles a CTA, then the smallest such cluster, at most 8."""
    tiles = pn // rows
    return min(range(1, min(MAX_CLUSTER, tiles) + 1), key=lambda c: (-(-tiles // c), c))


@dataclasses.dataclass(frozen=True)
class KdotPlan:
    """One launch of the probes: ``cl`` CTAs of ``rows`` rows a cluster
    (``rows // 16`` warps of 16 rows), one cluster per batch (per G batches
    for the zero body); kdot's CTAs run a ring of ``stages`` slots,
    ``smem`` bytes of dynamic shared memory."""

    rows: int
    cl: int
    stages: int
    smem: int


def kdot_smem(rows: int, stages: int) -> int:
    """kdot's shared memory: ``stages`` slots of S's [rows][64] tile and
    x's 64 K rows (144 bytes apart), then two transposed x tiles
    (``KdotLayout``)."""
    return stages * (rows * _TLD + K_STEP * (XCOLS + 16)) + 2 * XCOLS * _TLD


def kdot_plan(pn: int, oc: int, K: int, rows: Optional[int] = None, cl: Optional[int] = None,
              stages: Optional[int] = None) -> KdotPlan:
    """K1's geometry for the probes at ``pn`` (``fused_model_plan``'s
    default rule): 128 rows a CTA where they divide pn, else 64 (the shared
    memory holds either: at most 96 KB); the cluster that gives each CTA
    the fewest row tiles, the smallest such; 4 ring slots; K1's warps of 16
    rows. Each argument given forces that choice; raises ``ValueError`` on
    a plan the kernels cannot run (the C entries refuse the same). At pn
    2048: 8 CTAs of 128 rows, 2 row tiles each.

    Measured (``benchmarks/gemm_times.py --probes-only --plans``, one H100
    80GB HBM3 at 700 W, pn 2048 x 50 batches, oc 48): K 0 / 1 / 2 took
    90.8 / 116.7 / 153.4 us on 128-row CTAs (cl 8, 4 slots; K 2 over
    clusters of 4 or 8 and 3 or 4 slots: 151.7-154.1), 128.1 / 174.0 /
    218.0 on 64-row CTAs (x read again by twice the row tiles)."""
    return _cached_kdot_plan(pn, oc, K, rows, cl, stages)


@functools.lru_cache(maxsize=None)
def _cached_kdot_plan(pn, oc, K, rows, cl, stages) -> KdotPlan:
    if not 0 < oc <= XCOLS or K < 0:
        raise ValueError(f"need 0 < oc <= {XCOLS} and K >= 0, got oc={oc} K={K}")
    if stages is not None and stages not in STAGES:
        raise ValueError(f"ring depth {stages}: kdot takes {STAGES}")
    rows, cl = _geometry(pn, rows, cl)
    stages = stages or STAGES[0]
    return KdotPlan(rows, cl, stages, kdot_smem(rows, stages))


def _geometry(pn: int, rows: Optional[int], cl: Optional[int]) -> tuple:
    """(rows a CTA, CTAs a cluster): K1's default rule, or the forced ones."""
    if pn <= 0 or pn % K_STEP:
        raise ValueError(f"pn={pn}: the probes need a positive multiple of {K_STEP}")
    if rows is None:
        rows = ROWS[0] if pn % ROWS[0] == 0 else ROWS[1]
    if rows not in ROWS or pn % rows:
        raise ValueError(f"rows per CTA {rows}: the kernels take {ROWS} dividing pn={pn}")
    tiles = pn // rows
    if cl is None:
        cl = cluster_size(pn, rows)
    if not 1 <= cl <= min(MAX_CLUSTER, tiles):
        raise ValueError(f"{cl} CTAs per batch: the kernels take 1..{min(MAX_CLUSTER, tiles)} over {tiles} "
                         f"row tiles")
    return rows, cl


def roll_column(j, k):
    """The column of x that pass k reads for output column j: ``roll(x,
    k)[:, j] == x[:, (j - k) mod 128]`` (the kernel's per-lane row address
    into the transposed x)."""
    return (j - k) % XCOLS


def xt_window(oc: int, K: int) -> tuple:
    """(first block, blocks): the 4-column blocks of x, taken mod 32 from
    the first, that kdot stages and transposes each step (the C entry
    computes them, ``window`` in csrc/grid_overhead.cu; this mirrors it
    for the tests): output columns
    [0, round_up(oc, 8)) of passes k < K read columns ``j - k`` mod 128, so
    the window runs from column -(K - 1) to round_up(oc, 8) - 1 (all 32
    blocks where that is 128 columns or more). At K = 0 it is one pass's,
    so that a step's fixed cost is the same at every K."""
    first, last = -((max(K, 1) - 1 + 3) // 4), (-(-oc // 8) * 8 - 1) // 4
    n = last - first + 1
    return (0, XCOLS // 4) if n >= XCOLS // 4 else (first % (XCOLS // 4), n)


def _x_shape(x: torch.Tensor, width=None) -> None:
    if x.dtype != torch.int8 or x.dim() != 3:
        raise TypeError(f"x: expected int8 [B, pn, xp], got {x.dtype} {tuple(x.shape)}")
    if width is not None and x.shape[2] != width:
        raise ValueError(f"x: expected {width} columns, got {x.shape[2]}")


def zero_body_plain(x: torch.Tensor, oc: int, G: int = 1) -> torch.Tensor:
    """float32 zeros [B, pn, oc] (the kernel reads X first)."""
    _x_shape(x)
    if G <= 0 or x.shape[0] % G:
        raise ValueError(f"G={G} must divide B={x.shape[0]}")
    return torch.zeros((x.shape[0], x.shape[1], oc), dtype=torch.float32, device=x.device)


def zero_body(x: torch.Tensor, oc: int, G: int = 1, rows: Optional[int] = None,
              cl: Optional[int] = None) -> torch.Tensor:
    """X int8 [B, pn, xp] read in clusters of G batches -> zeros [B, pn, oc],
    on :func:`kdot_plan`'s rows and cluster (``rows`` and ``cl`` force them)."""
    global ZERO_BODY_LAUNCHES
    if not x.is_cuda:
        return zero_body_plain(x, oc, G)
    _x_shape(x)
    B, pn, xp = x.shape
    if G <= 0 or B % G or pn % 64 or xp % 16 or xp > XCOLS or oc <= 0:
        raise ValueError(f"zero_body needs G | B, pn % 64 == 0, xp a multiple of 16 up to {XCOLS} and oc > 0")
    rows, cl = _geometry(pn, rows, cl)
    out = torch.empty((B, pn, oc), dtype=torch.float32, device=x.device)  # written whole
    with torch.cuda.device(x.device):
        err = library().qgtc_zero_body(out.data_ptr(), _gemm._operand(x, torch.int8, "x"), B, pn, xp,
                                       oc, G, rows, cl, torch.cuda.current_stream(x.device).cuda_stream)
    check(err, "qgtc_zero_body")
    ZERO_BODY_LAUNCHES += 1
    return out


def _kdot_shapes(x: torch.Tensor, s: torch.Tensor, oc: int, K: int) -> None:
    _x_shape(x, XCOLS)
    pn = x.shape[1]
    if s.dtype != torch.int8 or tuple(s.shape) != (pn, pn):
        raise ValueError(f"s: expected int8 [{pn}, {pn}], got {s.dtype} {tuple(s.shape)}")
    if not 0 < oc <= XCOLS or K < 0:
        raise ValueError(f"need 0 < oc <= {XCOLS} and K >= 0, got oc={oc} K={K}")
    if s.device != x.device:
        raise ValueError(f"operands on {x.device} and {s.device}")


def kdot_plain(x: torch.Tensor, s: torch.Tensor, oc: int, K: int) -> torch.Tensor:
    """out[b] = (sum over k < K of s . roll(x[b], k, columns))[:, :oc],
    exact in int32, as float32 [B, pn, oc]."""
    _kdot_shapes(x, s, oc, K)
    acc = torch.zeros((x.shape[0], x.shape[1], XCOLS), dtype=torch.int64, device=x.device)
    for k in range(K):  # one batched product a pass
        acc += _gemm.plain_product(s, torch.roll(x, shifts=k, dims=2))
    return u32_to_i32(acc[:, :, :oc] & 0xFFFFFFFF).to(torch.float32)


def kdot(x: torch.Tensor, s: torch.Tensor, oc: int, K: int, _plan: Optional[KdotPlan] = None) -> torch.Tensor:
    """x int8 [B, pn, 128], s int8 [pn, pn] -> :func:`kdot_plain`'s float32
    [B, pn, oc], one cluster per batch on :func:`kdot_plan` (``_plan``
    forces one)."""
    global KDOT_LAUNCHES
    if not x.is_cuda:
        return kdot_plain(x, s, oc, K)
    _kdot_shapes(x, s, oc, K)
    B, pn, _ = x.shape
    plan = _plan or kdot_plan(pn, oc, K)
    out = torch.empty((B, pn, oc), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = library().qgtc_kdot(out.data_ptr(), _gemm._operand(x, torch.int8, "x"),
                                  _gemm._operand(s, torch.int8, "s"), B, pn, oc, K, plan.rows, plan.cl,
                                  plan.stages, torch.cuda.current_stream(x.device).cuda_stream)
    check(err, "qgtc_kdot")
    KDOT_LAUNCHES += 1
    return out


# -- the study (CUDA) ------------------------------------------------------

def mega_inputs(pn: int, B: int, nl: int, rng, device, bits: int = 2, hid: int = 16, cls: int = 47,
                xdim: int = 100):
    """JAX's ``mega`` builder (:145-172), the same draws: (a_stack int32
    [B, pn/32, pn], x_stack int8 [B, 1, pn, 128], weights)."""
    from qgtc_ppopp22_tpu_torch.ops.digits import digit_pack
    from qgtc_ppopp22_tpu_torch.ops.packmm import pack_rows_np

    xp = 128
    qa = (rng.random((pn, pn)) < 0.01).astype(np.int32)
    aw = np.broadcast_to(pack_rows_np(qa, 1)[0], (B, pn // 32, pn)).copy()
    qx = rng.integers(0, 1 << bits, (pn, xdim)).astype(np.int32)
    shapes = [(xdim, cls)] if nl == 1 else [(xdim, hid)] + [(hid, hid)] * (nl - 2) + [(hid, cls)]
    ws = [digit_pack(torch.from_numpy(rng.integers(0, 1 << bits, s).astype(np.int32)).to(device), bits)
          for s in shapes]
    xd = digit_pack(torch.from_numpy(np.pad(qx, ((0, 0), (0, xp - xdim)))).to(device), bits).digits
    xs = xd[0][None, None].expand(B, 1, pn, xp).contiguous()
    return torch.from_numpy(aw).to(device), xs, ws


def layer_epoch(a: torch.Tensor, xs: torch.Tensor, ws, resident_a: bool = True) -> torch.Tensor:
    """The study's K1 call (2-bit GCN, 47 stored columns, 100 features)."""
    from qgtc_ppopp22_tpu_torch.ops.fused_model import fused_model_epoch

    return fused_model_epoch(a, xs, ws, 2, model="gcn", resident_a=resident_a, unpack_once=False,
                             out_cols=47, x_cols=100)


def random_x(B: int, pn: int, gen: torch.Generator, device) -> torch.Tensor:
    """int8 [B, pn, 128], uniform over the int8 range, drawn on the device."""
    return torch.randint(-128, 128, (B, pn, XCOLS), dtype=torch.int8, device=device, generator=gen)


def l2_copies(nbytes: int) -> int:
    """How many operands of ``nbytes`` a call must take turns over for
    each to have left the L2 (twice its size read in between) before it
    comes round again."""
    return 1 + -(-2 * L2_BYTES // nbytes)


def in_turns(fn, operands):
    """A call of ``fn`` on the next of ``operands``, round and round."""
    it = itertools.cycle(operands)
    return lambda: fn(next(it))


def _checked(what: str, run, plain) -> None:
    """``run()`` must equal ``plain()``; its output's block is first
    filled with NaN, so an element the kernel leaves unwritten shows."""
    want = plain()
    torch.full_like(want, float("nan"))  # freed: run's output may take its block
    if not torch.equal(run(), want):
        raise AssertionError(f"{what}: kernel != plain")


def _per_batch_us(fns: Dict, batches: Dict, iters: int) -> Dict:
    from qgtc_ppopp22_tpu_torch.utils.timing import device_times_ms

    ms = device_times_ms(fns, iters=iters)
    return {k: ms[k] * 1e3 / batches[k] for k in fns}


def zero_body_rows(iters: int = 20, device="cuda", seed: int = 0) -> List[Dict]:
    """Section 1 on the card: random X, each call checked first, each
    timed call on the next of :func:`l2_copies` copies of X."""
    gen = torch.Generator(device=device).manual_seed(seed)
    fns, bs = {}, {}
    for pn, B in ZERO_BODY_SHAPES:
        xs = [random_x(B, pn, gen, device) for _ in range(l2_copies(B * pn * XCOLS))]
        for G in (1, 5):
            _checked(f"zero_body pn={pn} B={B} G={G}", lambda G=G: zero_body(xs[0], 48, G),
                     lambda G=G: zero_body_plain(xs[0], 48, G))
            fns[(pn, G)] = in_turns(lambda x, G=G: zero_body(x, 48, G), xs)
            bs[(pn, G)] = B
    us = _per_batch_us(fns, bs, iters)
    return [dict(probe="zero_body", pn=pn, G=G, us_per_batch=us[(pn, G)]) for pn, G in fns]


def kdot_rows(iters: int = 5, device="cuda", seed: int = 0) -> List[Dict]:
    """Section 2 on the card: random S and x, each (K, oc) checked first."""
    pn, B = KDOT_SHAPE
    gen = torch.Generator(device=device).manual_seed(seed)
    x = random_x(B, pn, gen, device)
    s = torch.randint(-128, 128, (pn, pn), dtype=torch.int8, device=device, generator=gen)
    fns = {(K, oc): (lambda K=K, oc=oc: kdot(x, s, oc, K)) for K, oc in KDOT_ROWS}
    for K, oc in KDOT_ROWS:
        _checked(f"kdot pn={pn} B={B} K={K} oc={oc}", fns[(K, oc)], lambda K=K, oc=oc: kdot_plain(x, s, oc, K))
    us = _per_batch_us(fns, dict.fromkeys(fns, B), iters)
    return [dict(probe="kdot", pn=pn, K=K, oc=oc, us_per_batch=us[(K, oc)]) for K, oc in KDOT_ROWS]


def layer_rows(rng, iters: int = 10, device="cuda") -> List[Dict]:
    """Section 3 on the card: K1 at 1/3/5 layers and the layer fit."""
    rows = []
    for pn, B in LAYER_SHAPES:
        fns = {}
        for nl in (1, 3, 5):
            a, xs, ws = mega_inputs(pn, B, nl, rng, device)
            fns[nl] = lambda a=a, xs=xs, ws=ws: layer_epoch(a, xs, ws)
        ts = _per_batch_us(fns, dict.fromkeys(fns, B), iters)
        rows += [dict(probe="layer_scaling", pn=pn, layers=nl, us_per_batch=ts[nl]) for nl in fns]
        slope = (ts[5] - ts[1]) / 4
        rows.append(dict(probe="layer_fit", pn=pn, us_per_layer=slope, intercept_us=ts[1] - slope))
    return rows


def tier_rows(rng, iters: int = 10, device="cuda") -> List[Dict]:
    """Section 4 on the card: the tiers the port has."""
    rows = []
    for pn, B in TIER_SHAPES:
        a, xs, ws = mega_inputs(pn, B, 3, rng, device)
        fns = {ra: (lambda ra=ra: layer_epoch(a, xs, ws, ra)) for ra in (True, False)}
        us = _per_batch_us(fns, dict.fromkeys(fns, B), iters)
        rows.append(dict(probe="tier", pn=pn, resident=True, unpack_once=True,
                         us_per_batch="not ported (a TPU VMEM tier)"))
        rows += [dict(probe="tier", pn=pn, resident=ra, unpack_once=False, us_per_batch=us[ra])
                 for ra in (True, False)]
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--csv", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("grid_overhead_study times the card's kernels and needs a CUDA device")
    from qgtc_ppopp22_tpu_torch.benchmarks.gemm_times import card_line

    print(f"card: {card_line()}", flush=True)
    rng = np.random.default_rng(0)
    rows = []
    for section in (zero_body_rows(), kdot_rows(), layer_rows(rng), tier_rows(rng)):
        for r in section:
            print(r, flush=True)
        rows += section
    if args.csv:
        from qgtc_ppopp22_tpu_torch.utils.metrics import write_csv

        write_csv(args.csv, rows, sorted({k for r in rows for k in r}))
        print(f"wrote {args.csv}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
