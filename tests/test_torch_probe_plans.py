"""The launch plans and index maps of the redesigned kernel-study probes
(``qgtc_ppopp22_tpu_torch/benchmarks/``), on the CPU.

P3b's ``kdot`` (``csrc/grid_overhead.cu``) runs K1's geometry
(``kdot_plan``) and reads the roll as an address into x transposed over
a window of 4-column blocks (``roll_column``; ``xt_window`` mirrors the C
entry's window); P1b's packed
output (``csrc/exp_packmm_packed.cu``) gives each CTA whole word rows
(``packedout_plan``, ``word_row_ctas``). The kernels run only on the card,
where ``chip_smoke.py`` holds them to their plain versions under every
forced plan; here NumPy mirrors of their index maps are held to the plain
versions and to the layout's packer. Tolerance: exact equality.
"""

import numpy as np
import pytest
import torch

from qgtc_ppopp22_tpu_torch.benchmarks import exp_packmm as ep
from qgtc_ppopp22_tpu_torch.benchmarks import grid_overhead_study as go


# -- P3b: kdot_plan ---------------------------------------------------------

@pytest.mark.parametrize("pn,want", [
    (2048, (128, 8, 4)),  # the study's row: 16 tiles, 2 a CTA
    (640, (128, 5, 4)),   # 5 tiles, 1 a CTA
    (256, (128, 2, 4)),
    (1024, (128, 8, 4)),
    (576, (64, 5, 4)),    # 128 does not divide pn: 9 tiles of 64, 2 a CTA on 5
])
def test_kdot_plan_default(pn, want):
    for K, oc in ((0, 8), (1, 48), (2, 120)):
        plan = go.kdot_plan(pn, oc, K)
        assert (plan.rows, plan.cl, plan.stages) == want
        assert plan.smem == go.kdot_smem(plan.rows, plan.stages) <= 227 * 1024


def test_kdot_plan_forced_and_refused():
    assert go.kdot_plan(640, 48, 2, rows=64) == go.KdotPlan(64, 5, 4, go.kdot_smem(64, 4))  # 10 tiles
    assert go.kdot_plan(640, 48, 2, rows=64, cl=8).cl == 8  # 10 tiles over 8 CTAs
    assert go.kdot_plan(2048, 48, 2, cl=3, stages=3) == go.KdotPlan(128, 3, 3, go.kdot_smem(128, 3))
    assert go.kdot_smem(128, 4) == 4 * (128 * 80 + 64 * 144) + 2 * 128 * 80
    for kw in (dict(rows=128, pn=576), dict(rows=32), dict(cl=9), dict(cl=0), dict(pn=256, cl=3),
               dict(stages=2), dict(oc=0), dict(oc=129), dict(K=-1), dict(pn=100), dict(stages=5)):
        args = dict(pn=2048, oc=48, K=2)
        args.update(kw)
        with pytest.raises(ValueError):
            go.kdot_plan(**args)
    # the zero body's geometry is kdot's, at 64-row tiles too
    assert go.cluster_size(256) == 4 and go.cluster_size(2048) == 8 and go.cluster_size(2048, 128) == 8
    assert go.cluster_size(640) == 5 and go.cluster_size(576, 64) == 5


# -- P3b: the roll as an address --------------------------------------------

@pytest.mark.parametrize("K", [0, 1, 2, 5, 130])
@pytest.mark.parametrize("oc", [8, 48, 120, 128])
def test_roll_column_is_torch_roll_inside_the_window(K, oc):
    x = torch.from_numpy(np.random.default_rng(K + oc).integers(-128, 128, (16, 128)).astype(np.int8))
    ocp = -(-oc // 8) * 8
    blk0, nblk = go.xt_window(oc, K)
    window = {(blk0 + i) % 32 for i in range(nblk)}
    assert 0 <= blk0 < 32 and 0 < nblk <= 32 and (K > 0 or go.xt_window(oc, 1) == (blk0, nblk))
    j = np.arange(ocp)
    for k in range(K):
        cols = go.roll_column(j, k)
        assert torch.equal(x[:, torch.from_numpy(cols)], torch.roll(x, shifts=k, dims=1)[:, :ocp])
        assert {int(c) // 4 for c in cols} <= window
    # no block that one of max(K, 1) passes does not read
    need = {int(c) // 4 for k in range(max(K, 1)) for c in go.roll_column(j, k)}
    assert len(window) == len(need)


def _kdot_tiled_walk(x, s, oc, K, plan):
    """kdot's kernel in NumPy: per batch the cluster's CTAs, each over its
    row tiles rank, rank + cl, ... in 64-deep K steps; x's K rows of a step
    staged only in the 16-column chunks that hold ``xt_window``'s blocks and
    transposed into Xt only over those blocks (the rest holds sentinels a
    stray read cannot hide), pass k reading output column j from Xt row
    ``roll_column(j, k)``; a tile's sums out after its last step, wrapped
    like int32."""
    B, pn, _ = x.shape
    ocp = -(-oc // 8) * 8
    blk0, nblk = go.xt_window(oc, K)
    cols = np.concatenate([4 * ((blk0 + i) % 32) + np.arange(4) for i in range(nblk)])
    c0, nch = blk0 // 4, min(8, (blk0 + nblk - 1) // 4 - blk0 // 4 + 1)  # the kernel's chunks of x
    staged = np.concatenate([16 * ((c0 + i) % 8) + np.arange(16) for i in range(nch)])
    assert set(cols) <= set(staged)
    out = np.full((B, pn, oc), np.nan, np.float32)
    for b in range(B):
        for rank in range(plan.cl):
            for t in range(rank, pn // plan.rows, plan.cl):
                m0 = t * plan.rows
                acc = np.zeros((plan.rows, ocp), np.int64)
                for k0 in range(0, pn, go.K_STEP):
                    st = s[m0:m0 + plan.rows, k0:k0 + go.K_STEP].astype(np.int64)
                    xs = np.full((go.K_STEP, 128), 1 << 40, np.int64)  # the slot's x rows
                    xs[:, staged] = x[b][k0:k0 + go.K_STEP][:, staged]
                    xt = np.full((128, go.K_STEP), 1 << 41, np.int64)
                    xt[cols] = xs[:, cols].T
                    for k in range(K):
                        acc += st @ xt[go.roll_column(np.arange(ocp), k)].T
                wrapped = (acc + (1 << 31)) % (1 << 32) - (1 << 31)
                out[b, m0:m0 + plan.rows] = wrapped[:, :oc].astype(np.float32)
    return out


@pytest.mark.parametrize("pn,oc,K,forced", [
    (192, 48, 2, {}), (192, 120, 3, {}), (256, 8, 1, dict(rows=64, cl=3)), (256, 48, 0, {}),
    (128, 128, 2, dict(rows=64)), (320, 40, 2, dict(rows=64, cl=4)),
])
def test_kdot_tiled_walk_equals_plain(pn, oc, K, forced):
    rng = np.random.default_rng(pn + oc + K)
    x = rng.integers(-128, 128, (2, pn, 128)).astype(np.int8)
    s = rng.integers(-128, 128, (pn, pn)).astype(np.int8)
    plan = go.kdot_plan(pn, oc, K, **forced)
    want = go.kdot_plain(torch.from_numpy(x), torch.from_numpy(s), oc, K).numpy()
    assert np.array_equal(_kdot_tiled_walk(x, s, oc, K, plan), want)
    before = go.KDOT_LAUNCHES
    assert np.array_equal(go.kdot(torch.from_numpy(x), torch.from_numpy(s), oc, K, _plan=plan).numpy(), want)
    assert go.KDOT_LAUNCHES == before  # the CPU runs the plain version


# -- P1b: packedout_plan and the word-row map -------------------------------

@pytest.mark.parametrize("row", ep.PACKEDOUT_ROWS)
def test_packedout_plan_at_the_study_rows(row):
    M, K, N, bits, tm, _, group = row
    plan = ep.packedout_plan(M, K, N, bits, group or tm)
    assert plan.bnt == min(N, 32) and plan.stages == 4  # 64 columns over at most 64 row CTAs: two tiles of 32
    assert plan.depth == 256 and plan.grid == (N // plan.bnt, M // 64, plan.splits)
    # the split makes two CTAs an SM, at most 8 and the K steps
    assert plan.splits == min(8, 2 * 132 // (N // plan.bnt * M // 64), K // 256)
    assert plan.smem == ep.packedout_smem(ep.field_bits(bits), plan.bnt, 4, 256) < 64 * 1024


def test_packedout_plan_choices_forced_and_refused():
    assert ep.packedout_plan(4096, 4096, 16, 1, 4096) == ep.PackedOutPlan(16, 4, 4, 256, (1, 64, 4), 33792)
    assert ep.packedout_plan(4096, 4096, 64, 1, 256).grid == (2, 64, 2)
    assert ep.packedout_plan(1024, 640, 16, 1, 1024).depth == 128 and ep.packedout_plan(1024, 576, 16, 1, 1024).depth == 64
    assert ep.packedout_plan(1024, 512, 48, 2, 512).bnt == 16  # neither 32 nor 64 divides 48
    assert ep.packedout_plan(1024, 512, 96, 2, 512).bnt == 32
    assert ep.packedout_plan(1024, 512, 128, 4, 1024).bnt == 32  # 16 row CTAs: tiles of 32
    assert ep.packedout_plan(2 * 64 * 132, 512, 128, 4, 256).bnt == 64  # 2 row CTAs an SM
    assert ep.packedout_plan(768, 512, 16, 4, 256).grid == (1, 12, 2)  # 2 K steps of 256
    assert ep.packedout_plan(256, 256, 16, 1, 256).splits == 1
    forced = ep.packedout_plan(4096, 4096, 64, 1, 256, bnt=32, splits=8, stages=3, depth=256)
    assert (forced.bnt, forced.splits, forced.stages, forced.depth, forced.grid) == (32, 8, 3, 256, (2, 64, 8))
    assert forced.smem == ep.packedout_smem(1, 32, 3, 256) == 2 * 32 * 272 + 3 * (2 * 1088 + 256 * 32)
    assert ep.packedout_plan(4096, 4096, 16, 1, 4096, depth=256).splits == 4  # 16 K steps: at least 4 a CTA
    for f in (1, 2, 4):
        for bnt in ep.PACKEDOUT_TILES:
            for st in ep.PACKEDOUT_STAGES:
                assert ep.packedout_smem(f, bnt, st, 256) <= 227 * 1024  # every plan fits
    for kw in (dict(bnt=64, Np=48), dict(bnt=8), dict(splits=9), dict(splits=0), dict(Kp=128, splits=3),
               dict(stages=2), dict(stages=8), dict(g=128), dict(Mp=768, g=512), dict(bits=5), dict(Kp=100),
               dict(depth=32),
               dict(depth=256, Kp=384), dict(depth=128, Kp=256, splits=3)):
        args = dict(Mp=1024, Kp=512, Np=48, bits=2, g=512)
        args.update(kw)
        with pytest.raises(ValueError):
            ep.packedout_plan(**args)


@pytest.mark.parametrize("bits", [1, 2, 4])
@pytest.mark.parametrize("g", [256, 512, 768, 1024, 2048, 4096])
def test_word_row_map_partitions_and_rebuilds_the_words(bits, g):
    Mp = g if g >= 2048 else 2 * g
    rows = ep.word_row_ctas(Mp, bits, g)
    assert rows.shape == (Mp // 64, 64)
    assert np.array_equal(np.sort(rows.ravel()), np.arange(Mp))  # the CTAs' rows partition [0, Mp)
    q = np.random.default_rng(bits + g).integers(0, 1 << bits, (Mp, 8))
    words = ep.pack_rows_np(q, bits, g)
    wr = 64 * ep.field_bits(bits) // 32
    for y in range(Mp // 64):
        # CTA y's rows alone, in its local order, packed as one 64-row tile
        # give exactly its word rows y*WR .. of the whole layout
        assert np.array_equal(ep.pack_rows_np(q[rows[y]], bits, 64), words[y * wr:(y + 1) * wr])


def test_packedout_cpu_dispatch_takes_a_plan():
    rng = np.random.default_rng(0)
    qa, qb = rng.integers(0, 2, (512, 256)), rng.integers(-1, 2, (256, 16))
    words = torch.from_numpy(ep.pack_rows_np(qa, 1, 512)[None])
    b = torch.from_numpy(qb.astype(np.int8)[None])
    plan = ep.packedout_plan(512, 256, 16, 1, 512, splits=2, depth=64)
    before = ep.PACKEDOUT_LAUNCHES
    got = ep.packmm_exp_packedout(words, b, 1, 512, _plan=plan)
    assert ep.PACKEDOUT_LAUNCHES == before
    assert torch.equal(got, ep.packmm_exp_packedout_plain(words, b, 1, 512))
    acc = qa @ qb
    want = np.where(acc > 2, 1, np.where(acc < 0, 1, acc)) & 1
    assert np.array_equal(ep.unpack_rows_np(got[0].numpy(), 1, 512), want)
