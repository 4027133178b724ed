"""Fixed-cost decomposition of the mega kernel, on the card (port of
``benchmarks/grid_overhead_study.py``).

``fused_model`` (K1) runs one thread-block cluster of ``min(pn / 64, 8)``
CTAs per batch. This ladder splits what a batch costs it without a
profiler of the SMs:

1. **zero-body** (:func:`zero_body`): K1's geometry, one cluster per ``G``
   batches, reading each batch's X into shared memory and writing zeros:
   the launch, cluster and traffic cost per batch, for G in {1, 5}.
2. **K-dot** (:func:`kdot`): the same read, then K passes of a
   single-stage int8 K loop built from ``gemm_core.cuh``'s pieces,
   ``out[b] = (sum over k < K of S . roll(x[b], k))[:, :oc]``; the roll is
   ``jnp.roll``'s along the 128 columns (column j moves to j + k). S is an
   operand here (the TPU kernel used uninitialised scratch, and its x was
   zero, so its output was zero). Here S and x are random, so every pass
   does real products and the roll's direction shows. K in {0, 1, 2} at oc 48, and oc in
   {8, 48, 120} at K = 0: the cost per pass and of the output width.
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
import itertools
import sys
from typing import Dict, List

import numpy as np
import torch

from qgtc_ppopp22_tpu_torch.ops import _gemm
from qgtc_ppopp22_tpu_torch.ops._build import check, library
from qgtc_ppopp22_tpu_torch.ops.bitpack import u32_to_i32

XCOLS = 128  # kdot's x width, the roll's period
MAX_CLUSTER = 8  # csrc/fused_model_k1.cuh MAX_CLUSTER
ZERO_BODY_SHAPES = ((1024, 75), (2048, 50))  # (pn, B)
KDOT_SHAPE = (2048, 50)
KDOT_ROWS = ((0, 8), (0, 48), (0, 120), (1, 48), (2, 48))  # (K, oc)
LAYER_SHAPES = ((512, 75), (2048, 50))
TIER_SHAPES = ((512, 75), (1024, 75), (2048, 50), (2560, 50))
L2_BYTES = 50 * 2 ** 20  # an H100's L2

ZERO_BODY_LAUNCHES = 0  # csrc/grid_overhead.cu zero_body launches since the count was last reset to 0
KDOT_LAUNCHES = 0  # its kdot launches, likewise


def cluster_size(pn: int) -> int:
    """The CTAs per batch of K1's first design: one per 64-row tile, at most 8."""
    return min(pn // 64, MAX_CLUSTER)


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


def zero_body(x: torch.Tensor, oc: int, G: int = 1) -> torch.Tensor:
    """X int8 [B, pn, xp] read in clusters of G batches -> zeros [B, pn, oc]."""
    global ZERO_BODY_LAUNCHES
    if not x.is_cuda:
        return zero_body_plain(x, oc, G)
    _x_shape(x)
    B, pn, xp = x.shape
    if G <= 0 or B % G or pn % 64 or xp % 16 or xp > XCOLS:
        raise ValueError(f"zero_body needs G | B, pn % 64 == 0 and xp a multiple of 16 up to {XCOLS}")
    out = torch.empty((B, pn, oc), dtype=torch.float32, device=x.device)  # written whole
    with torch.cuda.device(x.device):
        err = library().qgtc_zero_body(out.data_ptr(), _gemm._operand(x, torch.int8, "x"), B, pn, xp,
                                       oc, G, torch.cuda.current_stream(x.device).cuda_stream)
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


def kdot(x: torch.Tensor, s: torch.Tensor, oc: int, K: int) -> torch.Tensor:
    """x int8 [B, pn, 128], s int8 [pn, pn] -> :func:`kdot_plain`'s float32
    [B, pn, oc], one cluster per batch."""
    global KDOT_LAUNCHES
    if not x.is_cuda:
        return kdot_plain(x, s, oc, K)
    _kdot_shapes(x, s, oc, K)
    B, pn, _ = x.shape
    if pn % 64:
        raise ValueError(f"kdot needs pn % 64 == 0, got {pn}")
    out = torch.empty((B, pn, oc), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = library().qgtc_kdot(out.data_ptr(), _gemm._operand(x, torch.int8, "x"),
                                  _gemm._operand(s, torch.int8, "s"), B, pn, oc, K,
                                  torch.cuda.current_stream(x.device).cuda_stream)
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
