"""Device time of the integer GEMM kernels K2 ``packmm``, K3
``digitmm`` and K6 ``bitmm`` at the step engines' C1 shapes (pn = 2560,
2-bit GCN, hidden 16, 40 classes), K2 at C1 with a real adjacency's
zero-tile map (batch 0 of the arxiv stand-in, psize 1500, batch 20, with
its pack-time map), every row of the kernel sweep's Fig. 8a (K2
packed out at 1, 2 and 4 bits, K4 ``packmm_signed`` at 8 bits), K2's 8-bit
plane (8-bit A[4096²] x 8-bit B[4096 x 64], two digit planes, to the
signed plane and to f32 at ``out_cols`` 64, dense and over a blocky A
with its map), and the
whole-model kernel K1 ``fused_model_epoch`` over C1's 75 batches: 2-bit
with the compacted block schedule and dense (C1), and 8-bit levels (C1-8,
``shifts=[6, 2, 11, 2, 11]``: the signed chain) dense and with C1's
schedule; K3 at C1's three updates (X x W0, H x W1, H x W2); the bf16
baseline's K5 ``fused_baseline_epoch`` over the same 75 batches as the
baseline mega engine stages them (C1-baseline: sage, 128 -> 16 -> 16 ->
40), its first layer alone (128 -> 40) and the gin widths (hidden 64);
and the kernel-study probes at their studies' rows (P3b ``kdot``, P3a's
zero body, P1b's packed output on JAX's ten rows) beside K2's packed
route at P1b's 4096² x 16 and x 64 (``--probes-only``: these alone;
with ``--plans``, P1b and P3b also on each of their plans).

The script calls only what the port has offered since zero-tile jumping
(``packmm_to_digits`` with and without a map, ``packmm_to_f32``,
``digitmm_to_digits``, ``bitmm_to_bits``, ``bitmm_to_int``,
``kernel_sweep.figure_cases``, a batch's ``a_words`` and ``tile_kidx`` /
``tile_kcnt``, ``QGTCEngine(fmt="bits")``, ``fused_model_epoch``,
``run_epochs_mega``, ``BaselineEngine._stage_mega`` and
``fused_baseline_epoch``; the probes' ``kdot``, ``zero_body`` and
``packmm_exp_packedout``), so two checkouts can be
timed on one card in one command: copy it into the other checkout's
``benchmarks/`` folder and run it from each checkout's root in turns (A,
B, B, A), each run on the kernels that its checkout builds. Operands come
from ``np.random.default_rng(--seed)`` (the dense K loop does not depend
on the data), the sweep's ``default_rng(0)`` and the batcher's seed 3.

Prints the card's name and power limit, then one JSON line per row
(``{"tag", "row", "us"}``): the device time per call, the lesser of two
rounds of ``--iters`` calls in one profiler session. Then the step
engines' E1, E1z and E4 on the same 75 batches (``QGTCEngine.run_epochs``,
resident: digits dense, digits with ``zerotile_jump=True``, and
``fmt="bits"``): one line each (``{"tag", "row", "ms"}``) with the
host-clock ms/epoch of ``--epoch-runs`` runs of 5 epochs, taken in turns,
then E3 and E3-8 (``run_epochs_mega``, 2-bit and 8-bit, 20 epochs a run)
and B3 (``BaselineEngine.run_epochs_mega``, sage, 20 epochs a run).
``--plans`` (``packmm_plan(..., bnt=)``, ``bitmm_plan(..., bnt=)``,
``fused_model_plan``, ``digitmm_plan`` and ``fused_baseline_plan``, this
checkout only) adds K2 at C1's rows and at 4096² on each column tile it
can take, K4 (``packmm_signed_plan``) at the sweep's nine 8-bit rows on
each split (at 4096² x 64 on each column tile too) and K2's dense 8-bit
plane to the signed plane on each column tile and split, K6 at C1's aggregations on each column tile and split, K1 at C1
and C1-8 on each of its plans' rows per CTA, stage depths and ring depths,
K3 at C1's updates on each column tile and tile height, and K5 at
C1-baseline on each count of batches in flight, each line with its plan.
``--scaling`` adds K1 at C1 dense over the first 1, 8, 16, 32 and 75
batches, on one batch on clusters of 1 and 2 CTAs, and on all 75 on
clusters of 2, 4, 5 and 8. Needs a CUDA device.

Usage::

    python -m qgtc_ppopp22_tpu_torch.benchmarks.gemm_times [--tag NAME] [--iters 20] [--epoch-runs 3] \
        [--mega-runs 3] [--plans] [--scaling] [--probes-only]
"""

from __future__ import annotations

import argparse
import itertools
import json
import subprocess
import sys

import numpy as np
import torch

from qgtc_ppopp22_tpu_torch.benchmarks import kernel_sweep
from qgtc_ppopp22_tpu_torch.ops import bitgemm, digitmm, packmm
from qgtc_ppopp22_tpu_torch.ops.bitpack import pack_bits
from qgtc_ppopp22_tpu_torch.ops.digits import digit_pack
from qgtc_ppopp22_tpu_torch.ops.packmm import PackedTensor, pack_rows

PN, FEAT, HIDDEN, CLASSES, BITS = 2560, 128, 16, 40, 2
C1_8_SHIFTS = (6, 2, 11, 2, 11)  # C1-8's requantize shifts (torch_cases.chain_shifts on batch 0)


def c1_calls(seed: int, device) -> dict:
    """The step engine's dense GEMMs at C1's shapes: the aggregation
    A x H (1-bit A, 2-bit H, to digits and, for the last layer, to f32)
    and the update X x W."""
    rng = np.random.default_rng(seed)

    def levels(rows, cols, bits):
        return torch.from_numpy(rng.integers(0, 1 << bits, (rows, cols)).astype(np.int32)).to(device)

    qa, qh16, qh40 = levels(PN, PN, 1), levels(PN, HIDDEN, BITS), levels(PN, CLASSES, BITS)
    qx, qw, qw2 = levels(PN, FEAT, BITS), levels(FEAT, HIDDEN, BITS), levels(HIDDEN, HIDDEN, BITS)
    qw3 = levels(HIDDEN, CLASSES, BITS)
    a = pack_rows(qa, 1)
    h16, h40, x, w, w2, w3 = (digit_pack(q, BITS) for q in (qh16, qh40, qx, qw, qw2, qw3))
    ab = pack_bits(qa, 1)
    hb16, hb40, xb, wb, wb2 = (pack_bits(q, BITS) for q in (qh16, qh40, qx, qw, qw2))
    return {
        f"packmm_to_digits A[{PN}x{PN}] 1-bit x H[{PN}x{HIDDEN}] 2-bit":
            lambda: packmm.packmm_to_digits(a, h16, BITS),
        f"packmm_to_f32 A[{PN}x{PN}] 1-bit x H[{PN}x{CLASSES}] 2-bit":
            lambda: packmm.packmm_to_f32(a, h40),
        f"digitmm_to_digits X[{PN}x{FEAT}] x W[{FEAT}x{HIDDEN}] 2-bit":
            lambda: digitmm.digitmm_to_digits(x, w, BITS),
        f"digitmm_to_digits H[{PN}x{HIDDEN}] x W[{HIDDEN}x{HIDDEN}] 2-bit":
            lambda: digitmm.digitmm_to_digits(h16, w2, BITS),
        f"digitmm_to_digits H[{PN}x{HIDDEN}] x W[{HIDDEN}x{CLASSES}] 2-bit":
            lambda: digitmm.digitmm_to_digits(h16, w3, BITS),
        f"bitmm_to_bits A[{PN}x{PN}] 1-bit x H[{PN}x{HIDDEN}] 2-bit":
            lambda: bitgemm.bitmm_to_bits(ab, hb16, BITS),
        f"bitmm_to_int A[{PN}x{PN}] 1-bit x H[{PN}x{CLASSES}] 2-bit":
            lambda: bitgemm.bitmm_to_int(ab, hb40),
        f"bitmm_to_bits X[{PN}x{FEAT}] x W[{FEAT}x{HIDDEN}] 2-bit":
            lambda: bitgemm.bitmm_to_bits(xb, wb, BITS),
        f"bitmm_to_bits H[{PN}x{HIDDEN}] x W[{HIDDEN}x{HIDDEN}] 2-bit":
            lambda: bitgemm.bitmm_to_bits(hb16, wb2, BITS),
    }


def c1_batches():
    """The arxiv stand-in and C1's 75 cluster batches (psize 1500, batch
    20, seed 3)."""
    from qgtc_ppopp22_tpu_torch.graph import ClusterBatcher, load_dataset

    ds = load_dataset("ogbn-arxiv", data_dir="qgtc_graphs")
    return ds, ClusterBatcher(ds, psize=1500, batch_size=20, bit_width=BITS, seed=3, cache_dir="./datasets")


def c1_map_calls(seed: int, device, batcher) -> dict:
    """K2 at C1 on batch 0's adjacency with its pack-time map (256 x 256
    tiles), beside the same call without it."""
    from qgtc_ppopp22_tpu_torch.ops.bitgemm import TileMap

    b0 = batcher.batches[0]
    pn = b0.padded_nodes
    a = PackedTensor(words=b0.a_words.to(device), shape=(pn, pn), bits=1)
    tm = TileMap(kidx=b0.tile_kidx.to(device), kcnt=b0.tile_kcnt.to(device), tile_m=256, tile_k=256)
    rng = np.random.default_rng(seed)
    h16 = digit_pack(torch.from_numpy(rng.integers(0, 1 << BITS, (pn, HIDDEN)).astype(np.int32)).to(device), BITS)
    return {
        f"packmm_to_digits A(batch 0)[{pn}x{pn}] with its map x H[{pn}x{HIDDEN}]":
            lambda: packmm.packmm_to_digits(a, h16, BITS, tm),
        f"packmm_to_digits A(batch 0)[{pn}x{pn}] x H[{pn}x{HIDDEN}], no map":
            lambda: packmm.packmm_to_digits(a, h16, BITS),
    }


def plane8_operands(seed: int, device):
    """K2's 8-bit plane at 4096²: an 8-bit A, dense and blocky (every third
    256 x 256 tile occupied, 30% inside) with its pack-time map, and an
    8-bit B[4096 x 64] (two digit planes)."""
    rng = np.random.default_rng(seed)
    m, n = 4096, 64
    q = rng.integers(0, 256, (m, m))
    blocky = q * (rng.random((m, m)) < 0.3)
    i, j = np.meshgrid(np.arange(m) // 256, np.arange(m) // 256, indexing="ij")
    blocky[(i + j) % 3 != 0] = 0
    a = pack_rows(torch.from_numpy(q).to(device), 8)
    am = pack_rows(torch.from_numpy(blocky).to(device), 8)
    b = digit_pack(torch.from_numpy(rng.integers(0, 256, (m, n))).to(device), 8)
    return a, am, packmm.build_tile_map_packed(am), b


def plane8_calls(a, am, tm, b) -> dict:
    """K2's 8-bit plane, dense and over the blocky A with its map, to the
    signed plane and to f32 (``out_cols`` 64)."""
    shape = f"A[{a.shape[0]}x{a.shape[1]}] 8-bit x B[{b.shape[0]}x{b.shape[1]}] 8-bit"
    return {f"packmm 8-bit plane {shape} to the signed plane": lambda: packmm.packmm_to_packed(a, b, 8, out_cols=64),
            f"packmm 8-bit plane {shape} to f32": lambda: packmm.packmm_to_f32(a, b, out_cols=64),
            f"packmm 8-bit plane blocky {shape} with its map to the signed plane":
                lambda: packmm.packmm_to_packed(am, b, 8, tm, out_cols=64),
            f"packmm 8-bit plane blocky {shape} with its map to f32": lambda: packmm.packmm_to_f32(am, b, tm, out_cols=64)}


def signed_plan_calls(a, b, sweep) -> dict:
    """K4 (``packmm_signed_plan``) at each of the sweep's nine 8-bit rows on
    each split on its chosen column tile, at 4096² x 64 also on each other
    column tile, and K2's dense 8-bit plane (to the signed plane,
    ``out_cols`` 64) on each column tile and split; the default plan is
    marked."""
    import dataclasses

    def rows_of(name, a_, b_, np_, n, oc, tiles):
        chosen = packmm.packmm_signed_plan(a_.padded_rows, a_.padded_cols, np_, n, "plane", oc)
        out = {}
        for bnt in tiles:
            tile = packmm.packmm_signed_plan(a_.padded_rows, a_.padded_cols, np_, n, "plane", oc, bnt=bnt)
            for s in range(1, packmm.MAX_SPLIT + 1):
                plan = dataclasses.replace(tile, splits=s, cluster=(1, 1, s), grid=(*tile.grid[:2], s))
                mark = ", chosen" if plan == chosen else ""
                out[f"plan {name}: {dataclasses.astuple(plan)}{mark}"] = (
                    lambda a_=a_, b_=b_, p=plan: packmm._packmm(a_, b_, 8, "packed", 0, False, oc, _plan=p))
        return out

    rows = {}
    for c in sweep:
        if c.bits != 8:
            continue
        np_ = c.b.plane.shape[1]
        tiles = (16, 32, 64) if (c.M, c.N) == (4096, 64) else (None,)
        rows.update(rows_of(f"K4 sweep {c.M}² x {c.N}", c.a, c.b, np_, np_, c.N, tiles))
    rows.update(rows_of("K2 8-bit plane 4096² x 64", a, b, b.padded_cols, b.shape[1], 64, (16, 32, 64)))
    return rows


def probe_calls(seed: int, device) -> dict:
    """The kernel-study probes at their studies' rows: P3b ``kdot`` at pn
    2048 x 50 batches on each (K, oc) of ``KDOT_ROWS``, P3a's zero body
    (G 1, oc 48, in turns over enough copies of X that each call reads
    HBM), P1b's packed output on each of JAX's ten ``PACKEDOUT_ROWS``, and
    K2's packed route (``packmm_to_packed`` to 1-bit words) at P1b's
    4096² x 16 and x 64 shapes."""
    from qgtc_ppopp22_tpu_torch.benchmarks import exp_packmm as ep
    from qgtc_ppopp22_tpu_torch.benchmarks import grid_overhead_study as go

    rows = {}
    pn, B = go.KDOT_SHAPE
    gen = torch.Generator(device=device).manual_seed(seed)
    x = go.random_x(B, pn, gen, device)
    s = torch.randint(-128, 128, (pn, pn), dtype=torch.int8, device=device, generator=gen)
    for K, oc in go.KDOT_ROWS:
        rows[f"P3b kdot X[{B}x{pn}x128] x S[{pn}x{pn}] K {K} oc {oc}"] = (
            lambda K=K, oc=oc: go.kdot(x, s, oc, K))
    xs = [go.random_x(B, pn, gen, device) for _ in range(go.l2_copies(B * pn * 128))]
    rows[f"P3a zero_body X[{B}x{pn}x128] G 1 oc 48 (in turns over {len(xs)} copies)"] = go.in_turns(
        lambda xx: go.zero_body(xx, 48, 1), xs)
    rng = np.random.default_rng(seed)
    for M, K, N, bits, tm, tk, group in ep.PACKEDOUT_ROWS:
        qa, _, b = ep.operands(M, K, N, bits, rng, device)
        words = torch.from_numpy(ep.pack_rows_np(qa, bits, group or tm)[None]).to(device)
        rows[f"P1b packedout {bits}-bit A[{M}x{K}] x B[{K}x{N}] tm {tm} group {group}"] = (
            lambda w=words, b=b, bits=bits, tm=tm, group=group: ep.packmm_exp_packedout(w, b, bits, tm, group))
    for n in (16, 64):
        qa, qb = rng.integers(0, 2, (4096, 4096)), rng.integers(0, 2, (4096, n))
        a = pack_rows(torch.from_numpy(qa.astype(np.int32)).to(device), 1)
        bd = digit_pack(torch.from_numpy(qb.astype(np.int32)).to(device), 1)
        rows[f"K2 packmm_to_packed 1-bit A[4096x4096] x B[4096x{n}] to 1-bit words"] = (
            lambda a=a, bd=bd: packmm.packmm_to_packed(a, bd, 1))
    return rows


def probe_plan_calls(seed: int, device) -> dict:
    """P1b at 1-bit 4096² x 16 (tm 4096) and x 64 (group 256) on each column
    tile, K step, split of 1, 2, 4 or 8 and ring depth that
    ``packedout_plan`` can take, and P3b at pn 2048 x 50 batches, K 0-2, oc
    48 on each rows a CTA, ring depth and a cluster of 8 or 4
    (``kdot_plan``); this checkout only."""
    from qgtc_ppopp22_tpu_torch.benchmarks import exp_packmm as ep
    from qgtc_ppopp22_tpu_torch.benchmarks import grid_overhead_study as go

    rows = {}
    rng = np.random.default_rng(seed)
    for M, K, N, bits, g in ((4096, 4096, 16, 1, 4096), (4096, 4096, 64, 1, 256)):
        qa, _, b = ep.operands(M, K, N, bits, rng, device)
        words = torch.from_numpy(ep.pack_rows_np(qa, bits, g)[None]).to(device)
        for bnt, splits, stages, depth in itertools.product(ep.PACKEDOUT_TILES, (1, 2, 4, 8), ep.PACKEDOUT_STAGES,
                                                            ep.PACKEDOUT_DEPTHS):
            try:
                plan = ep.packedout_plan(M, K, N, bits, g, bnt, splits, stages, depth)
            except ValueError:
                continue
            rows[f"plan P1b {bits}-bit A[{M}x{K}] x B[{K}x{N}] g {g}: bnt {bnt} S {splits} stages {stages} "
                 f"depth {depth}"] = (
                lambda w=words, b=b, bits=bits, g=g, pl=plan: ep.packmm_exp_packedout(w, b, bits, g, _plan=pl))
    pn, B = go.KDOT_SHAPE
    gen = torch.Generator(device=device).manual_seed(seed)
    x = go.random_x(B, pn, gen, device)
    s = torch.randint(-128, 128, (pn, pn), dtype=torch.int8, device=device, generator=gen)
    for K, r, stages, cl in itertools.product((0, 1, 2), go.ROWS, go.STAGES, (8, 4)):
        plan = go.kdot_plan(pn, 48, K, r, cl, stages)
        rows[f"plan P3b kdot pn {pn} B {B} K {K} oc 48: rows {r} cl {cl} stages {stages}"] = (
            lambda K=K, pl=plan: go.kdot(x, s, 48, K, _plan=pl))
    return rows


def plan_calls(seed: int, device) -> dict:
    """K2 on every column tile its plan can take for 24-64 real columns:
    at C1's 40 row tiles to digits and to f32 (``out_cols`` N), and
    1-bit 4096² to words; the split is the plan's for that tile. Then C1's
    aggregation to digits (N 16) at every split."""
    import dataclasses

    rng = np.random.default_rng(seed)

    def levels(rows, cols, bits):
        return torch.from_numpy(rng.integers(0, 1 << bits, (rows, cols)).astype(np.int32)).to(device)

    rows = {}
    for m, form, ns in ((PN, "digits", (40, 64)), (PN, "f32", (24, 40, 48, 64)), (4096, "packed", (40, 64))):
        a = pack_rows(levels(m, m, 1), 1)
        for n in ns:
            b = digit_pack(levels(m, n, BITS), BITS)
            out_cols = None if form == "digits" else n
            ocp = packmm._stored_cols(form, out_cols, b.padded_cols)
            pform = "words" if form == "packed" else form
            chosen = packmm.packmm_plan(a.padded_rows, a.padded_cols, b.padded_cols, n, pform, ocp)
            for bnt in (16, 32, 64):
                plan = packmm.packmm_plan(a.padded_rows, a.padded_cols, b.padded_cols, n, pform, ocp, bnt=bnt)
                ob = None if form == "f32" else (1 if form == "packed" else BITS)
                mark = ", chosen" if plan == chosen else ""
                rows[f"plan {form} A[{m}x{m}] 1-bit x B[{m}x{n}]: {dataclasses.astuple(plan)}{mark}"] = (
                    lambda a=a, b=b, ob=ob, f=form, c=out_cols, p=plan:
                    packmm._packmm(a, b, ob, f, 0, False, c, _plan=p))
    # C1's aggregation to digits at every split
    a, b = pack_rows(levels(PN, PN, 1), 1), digit_pack(levels(PN, HIDDEN, BITS), BITS)
    chosen = packmm.packmm_plan(a.padded_rows, a.padded_cols, b.padded_cols, HIDDEN, "digits", b.padded_cols)
    for s in range(1, packmm.MAX_SPLIT + 1):
        plan = dataclasses.replace(chosen, splits=s, cluster=(1, 1, s), grid=(*chosen.grid[:2], s))
        mark = ", chosen" if plan == chosen else ""
        rows[f"plan digits A[{PN}x{PN}] 1-bit x H[{PN}x{HIDDEN}]: {dataclasses.astuple(plan)}{mark}"] = (
            lambda p=plan: packmm._packmm(a, b, BITS, "digits", 0, False, _plan=p))
    # K6 at C1's aggregations (to bits at N 16, to f32 at N 40 and 64) on
    # each column tile and split
    ab = pack_bits(levels(PN, PN, 1), 1)
    for n, ob in ((HIDDEN, BITS), (CLASSES, None), (64, None)):
        hb = pack_bits(levels(PN, n, BITS), BITS)
        form = "bits" if ob else "f32"
        chosen = bitgemm.bitmm_plan(ab.padded_rows, ab.padded_cols, hb.padded_cols, n, form)
        for bnt in (16, 32, 64):
            tile = bitgemm.bitmm_plan(ab.padded_rows, ab.padded_cols, hb.padded_cols, n, form, bnt=bnt)
            for s in range(1, bitgemm.MAX_SPLIT + 1):
                plan = dataclasses.replace(tile, splits=s, cluster=(1, 1, s), grid=(*tile.grid[:2], s))
                mark = ", chosen" if plan == chosen else ""
                rows[f"plan bitmm {form} A[{PN}x{PN}] 1-bit x H[{PN}x{n}]: {dataclasses.astuple(plan)}{mark}"] = (
                    lambda hb=hb, ob=ob, p=plan: bitgemm._bitmm(ab, hb, ob, None, _plan=p))
    return rows


def k3_plan_calls(seed: int, device) -> dict:
    """K3 at C1's three updates on each column tile and tile height
    ``digitmm_plan`` can take; the default plan is marked."""
    import dataclasses

    rng = np.random.default_rng(seed)

    def dt(rows, cols):
        return digit_pack(torch.from_numpy(rng.integers(0, 1 << BITS, (rows, cols)).astype(np.int32)).to(device), BITS)

    rows = {}
    h16 = dt(PN, HIDDEN)
    for a, b in ((dt(PN, FEAT), dt(FEAT, HIDDEN)), (h16, dt(HIDDEN, HIDDEN)), (h16, dt(HIDDEN, CLASSES))):
        args = (a.ndigits, b.ndigits, a.padded_rows, a.padded_cols, b.digits.shape[2], a.shape[1], b.shape[1])
        chosen = digitmm.digitmm_plan(*args)
        for bnt in digitmm.K3_BNTS:
            for r in digitmm.K3_ROWS:
                plan = digitmm.digitmm_plan(*args, bnt=bnt, rows=r)
                mark = ", chosen" if plan == chosen else ""
                rows[f"plan K3 X[{a.shape[0]}x{a.shape[1]}] x W[{b.shape[0]}x{b.shape[1]}]: "
                     f"{dataclasses.astuple(plan)}{mark}"] = (
                    lambda a=a, b=b, p=plan: digitmm._digitmm(a, b, BITS, 0, False, None, _plan=p))
    return rows


def k5_operands(ds, batcher, device):
    """K5's operands over C1's 75 batches as the baseline mega engine stages
    them: the stacked int8 adjacency and f32 features, the sage weights
    (C1-baseline), a first layer alone [128 x 40] and the gin weights
    (hidden 64), each with its packed weights."""
    from qgtc_ppopp22_tpu_torch.ops import fused_model
    from qgtc_ppopp22_tpu_torch.runtime import BaselineEngine

    kw = dict(feat_dim=batcher.feat_dim, num_classes=ds.num_classes, seed=3, device=device)
    sage = BaselineEngine(model="sage", **kw)
    staged = sage._stage_mega(batcher, ds)
    if len(staged) != 1:
        raise RuntimeError(f"expected one bucket, got {len(staged)}")
    a, x, ws = staged[0][1].args
    one = [torch.from_numpy(np.random.default_rng(3).standard_normal((batcher.feat_dim, ds.num_classes))
                            .astype(np.float32) * 0.1).to(device)]
    gin = BaselineEngine(model="gin", **kw).weights
    return a, x, {name: (w, fused_model.pack_baseline_weights(w))
                  for name, w in (("C1-baseline", ws), ("first layer [128 -> 40]", one), ("gin widths", gin))}


def k5_calls(a, x, weights: dict) -> dict:
    """K5 over C1's 75 batches through ``fused_baseline_epoch``."""
    from qgtc_ppopp22_tpu_torch.ops import fused_model

    return {f"K5 fused_baseline_epoch {name}": (lambda w=w, pk=pk: fused_model.fused_baseline_epoch(a, x, w, packed=pk))
            for name, (w, pk) in weights.items()}


def k5_plan_calls(a, x, weights: dict) -> dict:
    """K5 at C1-baseline on each count of batches in flight
    ``fused_baseline_plan`` can take on this card; the default plan is
    marked."""
    from qgtc_ppopp22_tpu_torch.ops import fused_model

    w, pk = weights["C1-baseline"]
    shapes = [tuple(t.shape) for t in w]
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    chosen = fused_model.fused_baseline_plan(a.shape, x.shape, shapes, sms=sms)
    rows = {}
    for g in range(1, chosen.groups + 1):
        plan = fused_model.fused_baseline_plan(a.shape, x.shape, shapes, g=g, sms=sms)
        mark = ", chosen" if plan == chosen else ""
        rows[f"plan K5 C1-baseline: groups {plan.groups} ctas {plan.ctas} (layers {plan.kd}) smem {plan.smem}{mark}"] = (
            lambda pl=plan: fused_model.fused_baseline_epoch(a, x, w, packed=pk, _plan=pl))
    return rows


def step_epoch_calls(ds, batcher, device) -> dict:
    """One resident digit step epoch over C1's batches, every kernel and
    torch op of it (the device time E1's host clock hides: K2, K3 and the
    digit conversion)."""
    from qgtc_ppopp22_tpu_torch.runtime import QGTCEngine

    eng = QGTCEngine(feat_dim=batcher.feat_dim, num_classes=ds.num_classes, model="gcn", bit_width=BITS, seed=3,
                     device=device)
    staged = [eng.put_batch(b) for b in batcher.batches]
    return {"digits step epoch (E1's device work), all its kernels": lambda: [eng._step(*t) for t in staged]}


def baseline_rows(ds, batcher, device, runs: int) -> dict:
    """B3: the baseline mega engine's host-clock ms/epoch over C1's batches
    (sage, one ``fused_baseline`` launch an epoch), ``runs`` runs of 20
    epochs."""
    from qgtc_ppopp22_tpu_torch.runtime import BaselineEngine

    eng = BaselineEngine(feat_dim=batcher.feat_dim, num_classes=ds.num_classes, model="sage", seed=3,
                         device=device)
    eng.run_epochs_mega(batcher, ds, n_epochs=2)  # warm: staging, the first launch
    return {"B3 baseline mega engine ms/epoch": [eng.run_epochs_mega(batcher, ds, n_epochs=20).avg_ms
                                                 for _ in range(runs)]}


def _x_stack(batcher, bits: int, device) -> torch.Tensor:
    """The batches' features as the mega engine stages them: digit planes
    int8[B, nd, pn, xp], or at 5-8 bits one plane of byte levels."""
    from qgtc_ppopp22_tpu_torch.ops.digits import planes_stack_to_digits

    bs = batcher.batches
    planes = torch.stack([b.bit_X.planes for b in bs]).to(device)
    d = torch.cat([planes_stack_to_digits(planes[i:i + 16], bs[0].bit_X.shape, bits)
                   for i in range(0, len(bs), 16)])
    if d.shape[1] == 2:
        d = (d[:, :1].to(torch.int32) | (d[:, 1:].to(torch.int32) << 4)).to(torch.uint8).view(torch.int8)
    return d.contiguous()


def k1_operands(ds, batcher, batcher8, device):
    """K1's operands over C1's batches, staged as the mega engine stages
    them (``fused_model_epoch``'s arguments): {name: (args, kwargs)}; C1-8
    is the same batches packed at 8 bits, X one plane of byte levels."""
    from qgtc_ppopp22_tpu_torch.ops import fused_model
    from qgtc_ppopp22_tpu_torch.runtime import QGTCEngine, mega_block_sched

    bs = batcher.batches
    pn = bs[0].padded_nodes
    a = torch.stack([b.a_words for b in bs])[:, 0].to(device).contiguous()
    a8 = torch.stack([b.a_words for b in batcher8.batches])[:, 0].to(device).contiguous()
    sched = torch.from_numpy(np.stack([mega_block_sched(b.a_words.numpy(), 512, fused_model.mega_colblock(pn))
                                       for b in bs])).to(device)
    kw = dict(feat_dim=batcher.feat_dim, num_classes=ds.num_classes, seed=3, device=device)
    w2, w8 = (QGTCEngine(bit_width=bw, **kw).weights for bw in (BITS, 8))
    x2, xl = _x_stack(batcher, BITS, device), _x_stack(batcher8, 8, device)
    base = dict(model="gcn", out_cols=ds.num_classes, x_cols=batcher.feat_dim)
    lv = dict(base, shifts=C1_8_SHIFTS, x_levels_bits=8)
    return {
        "C1 compact": ((a, x2, w2, BITS), dict(base, blk_sched=sched)),
        "C1 dense": ((a, x2, w2, BITS), dict(base)),
        "C1-8 levels dense": ((a8, xl, w8, 8), lv),
        "C1-8 levels with C1's schedule": ((a8, xl, w8, 8), dict(lv, blk_sched=sched)),
    }


def k1_calls(ops: dict) -> dict:
    """K1 over C1's 75 batches at C1 and C1-8, through ``fused_model_epoch``."""
    from qgtc_ppopp22_tpu_torch.ops import fused_model

    return {f"K1 fused_model_epoch {name}": (lambda a=a, k=k: fused_model.fused_model_epoch(*a, **k))
            for name, (a, k) in ops.items()}


def k1_plan_calls(ops: dict) -> dict:
    """K1 at C1 (compact, dense) and C1-8 on each rows per CTA, stage
    depth and ring depth ``fused_model_plan`` can take (the cluster its
    rule gives); the default plan is marked."""
    from qgtc_ppopp22_tpu_torch.ops import fused_model

    rows = {}
    for name, (a, k) in ops.items():
        if name == "C1-8 levels with C1's schedule":
            continue
        p = fused_model.plan(a[0].shape, a[1].shape, a[2], a[3], k["model"], k.get("shifts"), k["out_cols"],
                             None if k.get("blk_sched") is None else k["blk_sched"].shape, k.get("x_levels_bits"))
        chosen = fused_model.fused_model_plan(p, "gcn")
        tries = [dict(rows=r, depth=d, stages=s) for r in fused_model.K1_ROWS for d in fused_model.K1_DEPTHS
                 for s in fused_model.K1_STAGES]
        seen = set()
        for kw_ in tries:
            try:
                plan = fused_model.fused_model_plan(p, "gcn", **kw_)
            except ValueError:
                continue
            if plan in seen:
                continue
            seen.add(plan)
            mark = ", chosen" if plan == chosen else ""
            rows[f"plan K1 {name}: rows {plan.rows} cl {plan.cl} stages {plan.stages} depth {plan.depth} "
                 f"smem {plan.smem}{mark}"] = (
                lambda a=a, k=k, pl=plan: fused_model.fused_model_epoch(*a, **k, _plan=pl))
    return rows


def k1_scaling_calls(ops: dict) -> dict:
    """K1 at C1 dense on the first B of C1's batches, B in 1 .. 75, on the
    plan fused_model_plan gives each; one batch on clusters of 1 and 2
    CTAs, all 75 on clusters of 2, 4, 5 and 8, and on 64-row CTAs small
    enough for two an SM: how a CTA's time per stage scales with the
    batches in flight, the tiles a CTA owns and the CTAs an SM holds."""
    from qgtc_ppopp22_tpu_torch.ops import fused_model

    (a, x, w, ob), k = ops["C1 dense"]
    rows = {}
    for B, cls in ((1, (1, 2, None)), (8, (None,)), (16, (None,)), (32, (None,)), (75, (None, 2, 4, 5, 8))):
        aa, xx = a[:B].contiguous(), x[:B].contiguous()
        p = fused_model.plan(aa.shape, xx.shape, w, ob, "gcn", None, k["out_cols"])
        for cl in cls:
            plan = fused_model.fused_model_plan(p, "gcn", cl=cl)
            stages = -(-p.pn // plan.rows // plan.cl) * (p.pn // plan.depth) * len(w)  # a CTA's, dense
            rows[f"scaling K1 C1 dense B {B}: rows {plan.rows} cl {plan.cl} depth {plan.depth}, "
                 f"{stages} stages a CTA, {plan.grid} CTAs"] = (
                lambda aa=aa, xx=xx, pl=plan: fused_model.fused_model_epoch(aa, xx, w, ob, **k, _plan=pl))
    # 64-row CTAs small enough for two an SM (registers allow two of 128 threads)
    p = fused_model.plan(a.shape, x.shape, w, ob, "gcn", None, k["out_cols"])
    for depth, stages in ((256, 3), (128, 3)):
        plan = fused_model.fused_model_plan(p, "gcn", rows=64, depth=depth, stages=stages)
        rows[f"scaling K1 C1 dense B 75: rows 64 cl {plan.cl} depth {depth} stages {stages}, "
             f"smem {plan.smem}"] = lambda pl=plan: fused_model.fused_model_epoch(a, x, w, ob, **k, _plan=pl)
    return rows


def mega_rows(ds, batcher, batcher8, device, runs: int) -> dict:
    """E3 and E3-8: ``run_epochs_mega`` over C1's batches, 2-bit and 8-bit
    (C1-8's shifts), 20 epochs a run, ``runs`` runs in turns."""
    from qgtc_ppopp22_tpu_torch.runtime import QGTCEngine

    kw = dict(feat_dim=batcher.feat_dim, num_classes=ds.num_classes, model="gcn", seed=3, device=device)
    runs_of = {"E3 mega engine 2-bit ms/epoch": (QGTCEngine(bit_width=BITS, **kw), batcher),
               "E3-8 mega engine 8-bit ms/epoch": (QGTCEngine(bit_width=8, shifts=C1_8_SHIFTS, **kw), batcher8)}
    ms = {name: [] for name in runs_of}
    for _ in range(runs):
        for name, (eng, bt) in runs_of.items():
            ms[name].append(eng.run_epochs_mega(bt, n_epochs=20).avg_ms)
    return ms


def engine_rows(ds, batcher, device, runs: int) -> dict:
    """E1, E1z and E4: the resident step engine's host-clock ms/epoch over
    C1's batches, on digit planes dense and with each batch's map, and on
    bit planes (``fmt="bits"``, every GEMM one ``bitmm``), ``runs`` runs of
    5 epochs each, in turns."""
    from qgtc_ppopp22_tpu_torch.runtime import QGTCEngine

    kw = dict(feat_dim=batcher.feat_dim, num_classes=ds.num_classes, model="gcn", bit_width=BITS, seed=3,
              device=device)
    engines = {"E1 resident step engine ms/epoch": QGTCEngine(**kw),
               "E1z resident step engine with zero-tile jumping ms/epoch": QGTCEngine(zerotile_jump=True, **kw),
               "E4 resident bits step engine ms/epoch": QGTCEngine(fmt="bits", **kw)}
    for eng in engines.values():
        eng.warmup(batcher)
        eng.run_epochs(batcher, n_epochs=2, resident=True)  # warm: staging, first launches
    ms = {name: [] for name in engines}
    for _ in range(runs):
        for name, eng in engines.items():
            ms[name].append(eng.run_epochs(batcher, n_epochs=5, resident=True).avg_ms)
    return ms


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tag", default="", help="label printed on every row")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--seed", type=int, default=3)
    p.add_argument("--epoch-runs", type=int, default=3, help="runs of 5 epochs for E1, E1z and E4 (0: none)")
    p.add_argument("--mega-runs", type=int, default=3, help="runs of 20 epochs for E3, E3-8 and B3 (0: none)")
    p.add_argument("--plans", action="store_true",
                   help="K2, K4 and K6 on each column tile they can take, K1, K3 and K5 on each of their plans "
                        "(with --probes-only: P1b and P3b on theirs)")
    p.add_argument("--scaling", action="store_true",
                   help="K1 at C1 dense over 1 to 75 batches and cluster sizes")
    p.add_argument("--probes-only", action="store_true",
                   help="only the kernel-study probes' rows (no C1 batches, no epochs)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("gemm_times: no CUDA device", file=sys.stderr)
        return 1
    from qgtc_ppopp22_tpu_torch.utils.timing import device_times_ms

    dev = torch.device("cuda")
    if args.probes_only:
        rows = probe_calls(args.seed, dev)
        if args.plans:
            rows.update(probe_plan_calls(args.seed, dev))
        fns = {(name, rep): fn for rep in (0, 1) for name, fn in rows.items()}
        dt = device_times_ms(fns, iters=args.iters)
        print(f"card: {card_line()}")
        for name in rows:
            print(json.dumps({"tag": args.tag, "row": name, "us": round(min(dt[(name, 0)], dt[(name, 1)]) * 1e3, 2)}),
                  flush=True)
        return 0
    ds, batcher = c1_batches()
    rows = c1_calls(args.seed, dev)
    rows.update(c1_map_calls(args.seed, dev, batcher))
    sweep = kernel_sweep.figure_cases("8a", np.random.default_rng(0), dev)
    for c in sweep:
        kind = "packmm_signed" if c.bits == 8 else "packmm packed"
        rows[f"sweep 8a {kind} bits={c.bits} M=K={c.M} N={c.N}"] = c.run
    p8 = plane8_operands(args.seed, dev)
    rows.update(plane8_calls(*p8))
    from qgtc_ppopp22_tpu_torch.graph import ClusterBatcher

    batcher8 = ClusterBatcher(ds, psize=1500, batch_size=20, bit_width=8, seed=3, cache_dir="./datasets")
    k1_ops = k1_operands(ds, batcher, batcher8, dev)
    rows.update(k1_calls(k1_ops))
    k5_a, k5_x, k5_w = k5_operands(ds, batcher, dev)
    rows.update(k5_calls(k5_a, k5_x, k5_w))
    rows.update(step_epoch_calls(ds, batcher, dev))
    rows.update(probe_calls(args.seed, dev))
    if args.plans:
        rows.update(plan_calls(args.seed, dev))
        rows.update(signed_plan_calls(p8[0], p8[3], sweep))
        rows.update(k1_plan_calls(k1_ops))
        rows.update(k3_plan_calls(args.seed, dev))
        rows.update(k5_plan_calls(k5_a, k5_x, k5_w))
    if args.scaling:
        rows.update(k1_scaling_calls(k1_ops))
    fns = {(name, rep): fn for rep in (0, 1) for name, fn in rows.items()}
    # a step epoch runs thousands of small ops: few calls keep the
    # profiler's session within what it records
    dt = device_times_ms(fns, iters={k: 2 if k[0].startswith("digits step epoch") else args.iters for k in fns})
    print(f"card: {card_line()}")
    for name in rows:
        us = min(dt[(name, 0)], dt[(name, 1)]) * 1e3
        print(json.dumps({"tag": args.tag, "row": name, "us": round(us, 2)}), flush=True)
    if args.epoch_runs:
        for name, ms in engine_rows(ds, batcher, dev, args.epoch_runs).items():
            print(json.dumps({"tag": args.tag, "row": name, "ms": [round(v, 3) for v in ms]}), flush=True)
    if args.mega_runs:
        for name, ms in mega_rows(ds, batcher, batcher8, dev, args.mega_runs).items():
            print(json.dumps({"tag": args.tag, "row": name, "ms": [round(v, 3) for v in ms]}), flush=True)
        for name, ms in baseline_rows(ds, batcher, dev, args.mega_runs).items():
            print(json.dumps({"tag": args.tag, "row": name, "ms": [round(v, 3) for v in ms]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
