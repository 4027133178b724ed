"""The launch plans and index maps of the redesigned kernel-study probes
(``qgtc_ppopp22_tpu_torch/benchmarks/``), on the CPU.

P3b's ``kdot`` (``csrc/grid_overhead.cu``) runs K1's geometry
(``kdot_plan``) and reads the roll as an address into x transposed over
a window of 4-column blocks (``roll_column``; ``xt_window`` mirrors the C
entry's window); P1b's packed
output (``csrc/exp_packmm_packed.cu``) gives each CTA whole word rows
(``packedout_plan``, ``word_row_ctas``), and so does P1a's f32 product
(``csrc/exp_packmm.cuh``, ``exp_packmm_plan``), whose warps unpack the
rows they multiply; P2a's byte transpose (``csrc/exp_bitcast_probe.cu``)
takes four words a thread, and P2b's inverse four columns of a word row a
thread. The kernels run only on the card,
where ``chip_smoke.py`` holds them to their plain versions under every
forced plan; here NumPy mirrors of their index maps are held to the plain
versions and to the layout's packer. Tolerance: exact equality.
"""

import numpy as np
import pytest
import torch

from qgtc_ppopp22_tpu_torch.benchmarks import exp_bitcast_probe as bp
from qgtc_ppopp22_tpu_torch.benchmarks import exp_packmm as ep
from qgtc_ppopp22_tpu_torch.benchmarks import gemm_times
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
        for bnt in ep.TILES:
            for st in ep.STAGES:
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


# -- P1a: exp_packmm_plan and a NumPy walk of the kernel ----------------------

P1A_ALL = ep.VARIANTS + ("int8", "rowrange")


@pytest.mark.parametrize("shape", ep.LADDER_SHAPES)
def test_exp_packmm_plan_at_the_ladder_shapes(shape):
    mk, n, bits = shape
    for v in P1A_ALL:
        plan = ep.exp_packmm_plan(mk, mk, n, bits, 256, v)
        assert plan.variant == v and plan.stages == 4 and plan.depth == 256
        assert plan.bnt == min(n, 32)  # 64 columns over fewer than 2 row CTAs an SM: two tiles of 32
        assert plan.grid == (n // plan.bnt, mk // 64, plan.splits)
        # a cap of two CTAs an SM, at most 8 and the K steps; the fewest CTAs
        # that give each the cap's share
        cap = min(8, 2 * 132 // (n // plan.bnt * mk // 64), mk // 256)
        assert plan.splits == -(-(mk // 256) // -(-(mk // 256) // cap))
        assert plan.splits == (5 if mk == 2560 else cap)
        f = 8 if v == "int8" else ep.field_bits(bits)
        assert plan.smem == ep.exp_packmm_smem(v, f, plan.bnt, 4, 256, -(-mk // 256 // plan.splits)) <= 227 * 1024
    assert ep.bres_fits(mk, mk, n, bits)  # with a split, B's share fits at 4096 x 64 too


def test_exp_packmm_plan_at_c1_forced_and_refused():
    c1 = ep.exp_packmm_plan(2560, 2560, 16, 1, 256, "concat")
    assert c1 == ep.ExpPlan("concat", 16, 5, 4, 256, (1, 40, 5), c1.smem)  # 200 CTAs of 2 steps each
    assert c1.smem == 2 * 64 * 272 + 2 * 16 * 272 + 4 * (2 * 1088 + 256 * 16)
    assert ep.exp_packmm_plan(2560, 2560, 16, 1, 256, "slabs").smem == 2 * 16 * 272 + 4 * (2 * 1088 + 4096)
    assert ep.exp_packmm_plan(2560, 2560, 16, 1, 256, "int8").smem == 2 * 16 * 272 + 4 * (64 * 272 + 4096)
    assert ep.exp_packmm_plan(2560, 2560, 16, 1, 256, "rowrange").smem == \
        2 * 64 * 272 + 2 * 16 * 272 + 4 * (8 * 1088 + 4096)
    assert ep.exp_packmm_plan(2560, 2560, 16, 1, 256, "concat", splits=6).grid == (1, 40, 6)
    assert ep.exp_packmm_plan(2816, 1792, 16, 1, 256, "slabs").splits == 4  # 7 steps, cap 264 // 44 = 6: shares of 2
    # bres: the share of 2 steps a CTA holds whole, [16][512 + 16]
    assert ep.exp_packmm_plan(2560, 2560, 16, 1, 256, "bres").smem == 2 * 64 * 272 + 16 * 528 + 4 * 2 * 1088
    assert ep.exp_packmm_plan(1024, 640, 16, 2, 512, "concat").depth == 128
    assert ep.exp_packmm_plan(1024, 576, 48, 2, 512, "slabs").depth == 64
    assert ep.exp_packmm_plan(1024, 512, 48, 2, 512, "concat").bnt == 16  # neither 32 nor 64 divides 48
    forced = ep.exp_packmm_plan(4096, 4096, 64, 1, 256, "int8", bnt=64, splits=8, stages=3, depth=128)
    assert (forced.bnt, forced.splits, forced.stages, forced.depth, forced.grid) == (64, 8, 3, 128, (1, 64, 8))
    assert forced.smem == ep.exp_packmm_smem("int8", 8, 64, 3, 128, 4) == 2 * 64 * 144 + 3 * (64 * 144 + 128 * 64)
    # bres at 4096 x 64 on one tile of 64: a split of 1 holds all of B's 4096 rows (256 KB)
    with pytest.raises(ValueError, match="shared memory"):
        ep.exp_packmm_plan(4096, 4096, 64, 1, 256, "bres", bnt=64, splits=1)
    assert ep.exp_packmm_plan(4096, 4096, 64, 1, 256, "bres", bnt=64).splits == 4  # 264 // 64 row CTAs
    assert ep.bres_fits(512, 16384, 64, 4)  # 64 K steps over 8 CTAs: 2048 rows x 32 columns each
    assert not ep.bres_fits(512, 65536, 64, 4)  # 8192 rows x 32 columns each: 256 KB
    assert ep.exp_packmm_plan(512, 16384, 64, 4, 256, "bres_chunk", bnt=16).splits == 8
    for kw in (dict(bnt=64, Np=48), dict(bnt=8), dict(splits=9), dict(splits=0), dict(Kp=128, splits=3),
               dict(stages=2), dict(stages=5), dict(tm=128), dict(Mp=768, tm=512), dict(bits=5), dict(bits=0),
               dict(Kp=100), dict(Mp=96, tm=256), dict(depth=32), dict(depth=256, Kp=384),
               dict(depth=128, Kp=256, splits=3), dict(variant="k2loader"), dict(variant="rowrange", tm=512),
               dict(variant="bres", Kp=16384, Np=64, bnt=64, splits=2)):
        args = dict(Mp=1024, Kp=512, Np=48, bits=2, tm=512, variant="concat")
        args.update(kw)
        with pytest.raises(ValueError):
            ep.exp_packmm_plan(**args)
    assert ep.exp_packmm_plan(64, 128, 16, 8, 0, "int8").grid == (1, 1, 1)  # int8 takes any bits and tm


def _staged(variant, f, y):
    """The first row the kernel's CTA y stages and how many (its source's row0, WS)."""
    ws = ep.exp_staged_rows(variant, f)
    if variant == "int8":
        return 64 * y, ws
    if variant == "rowrange":
        h = y & 3
        return (y >> 2) * 8 * f + (16 * (h & 1) if f == 4 else 0), ws
    return y * ws, ws


def _cta_tile(variant, f, staged, y):
    """CTA y's A tile [64, K] as its warps build it from the staged rows
    [WS, K]: rows 16 w + a*4*NWW + 4 b + k hold field q(a) of byte k of
    staged row sw(b) (the kernel's u_src / u_dst / qsh); slabs' fragment
    rows and int8's slot rows as their loads take them."""
    if variant == "int8":
        return staged.astype(np.int64)
    w32 = staged.astype(np.int64) & 0xFFFFFFFF
    tile = np.full((64, staged.shape[1]), -999, np.int64)
    if variant == "slabs":  # frag(): local row r = q*4*WS + 4*(rem >> 2) + (rem & 3)
        r = np.arange(64)
        q, rem = r // (4 * staged.shape[0]), r % (4 * staged.shape[0])
        return (w32[rem >> 2] >> (8 * (rem & 3) + f * q)[:, None]) & ((1 << f) - 1)
    nww = 2 if f == 1 and variant != "rowrange" else 4
    q0 = {1: 2 * (y & 3), 2: y & 3, 4: (y & 3) >> 1}[f] if variant == "rowrange" else 0
    for warp in range(4):
        for b in range(nww):
            if variant == "rowrange":
                sw = 4 * (warp & 1) + b if f == 1 else 4 * warp + b
            else:
                sw = 4 * (warp & 1) + b if f == 4 else b
            for a in range(4 // nww):
                if variant == "rowrange":
                    q = q0 + (warp >> 1 if f == 1 else 0)
                else:
                    q = 2 * warp + a if f == 1 else (warp if f == 2 else warp >> 1)
                for k in range(4):
                    byte = (w32[sw] >> (8 * k)) & 0xFF
                    val = byte - 256 * (byte >= 128) if variant == "noextract" else (byte >> (f * q)) & ((1 << f) - 1)
                    tile[16 * warp + a * 4 * nww + 4 * b + k] = val
    return tile


def _logical_row(variant, f, tm, y, r):
    """The kernel's store: local row r of CTA y -> its logical row."""
    if variant in ("int8", "rowrange"):
        return 64 * y + r
    ws = 2 * f
    ms = tm * f // 32
    t, i0 = y * ws // ms, y * ws % ms
    q, rem = r // (4 * ws), r % (4 * ws)
    return t * tm + q * 4 * ms + 4 * (i0 + (rem >> 2)) + (rem & 3)


def p1a_walk(a, b, bits, tm, variant, plan):
    """A NumPy walk of P1a's kernel under ``plan``: per CTA (y, z) its K
    share of the plan's steps, its staged rows and A tile, the sums over its
    share, rank 0's wrapped sum over the split, stored at each local row's
    logical row. ``a``: int32 words [Mp / rpw, Kp] (int8: int8 [Mp, Kp])."""
    f = 8 if variant == "int8" else ep.field_bits(bits)
    Kp, Np = b.shape
    Mp = a.shape[0] * (1 if variant == "int8" else 32 // f)
    S, d = plan.splits, plan.depth
    steps = Kp // d
    share = -(-steps // S)
    out = np.full((Mp, Np), np.nan)
    r = np.arange(64)
    for y in range(Mp // 64):
        row0, ws = _staged(variant, f, y)
        tile = _cta_tile(variant, f, a[row0:row0 + ws], y)  # the unpack is the same at every step
        assert (tile != -999).all()
        acc = np.zeros((64, Np), np.int64)
        seen = []
        for z in range(S):
            first = min(z * share, steps)
            nst = min(steps - first, share)
            for j in range(nst):  # the ring's steps
                cols = slice((first + j) * d, (first + j + 1) * d)
                seen.append(first + j)
                acc += tile[:, cols] @ b[cols].astype(np.int64)
        assert sorted(seen) == list(range(steps))  # the shares cover every step once
        out[_logical_row(variant, f, tm, y, r)] = (acc + 2**31) % 2**32 - 2**31  # int32 wraps
    assert not np.isnan(out).any()  # every row written
    return out.astype(np.float32)


# every variant at 1, 2 and 4 bits (int8: its one A), tm 256 and 512
# (rowrange: 256), N 16 and 64; the two forced plans alternate
P1A_WALKS = [(v, bits, tm, n, ((64, 2), (128, 3))[i % 2]) for i, (v, bits, tm, n) in enumerate(
    (v, bits, tm, n) for v in P1A_ALL for bits in ((1,) if v == "int8" else (1, 2, 4))
    for tm in ((256,) if v in ("rowrange", "int8") else (256, 512)) for n in (16, 64))]


@pytest.mark.parametrize("variant,bits,tm,n,forced", P1A_WALKS)
def test_p1a_walk_equals_plain(variant, bits, tm, n, forced):
    """K 320 in 5 steps of 64 over a split of 2 (shares 3 and 2: odd), or
    K 384 in 3 steps of 128 over 3 CTAs (shares of 1); two layout tiles."""
    depth, splits = forced
    Mp, Kp = 2 * tm, 5 * depth if depth == 64 else 3 * depth
    rng = np.random.default_rng(bits + tm + n + depth)
    qa = rng.integers(0, 1 << bits, (Mp, Kp))
    qb = rng.integers(-(1 << bits), 1 << bits, (Kp, n))
    b = torch.from_numpy(qb.astype(np.int8)[None])
    plan = ep.exp_packmm_plan(Mp, Kp, n, bits, tm, variant, splits=splits, depth=depth)
    if variant == "int8":
        a = torch.from_numpy(qa.astype(np.int8)[None])
        want = ep.packmm_exp_int8_plain(a, b).numpy()
        got = p1a_walk(qa.astype(np.int8), qb, bits, tm, variant, plan)
    else:
        words = ep.pack_rows_np(qa, bits, tm)
        v = "noextract" if variant == "noextract" else "concat"
        want = ep.packmm_exp_plain(torch.from_numpy(words[None]), b, bits, tm, v).numpy()
        got = p1a_walk(words, qb, bits, tm, variant, plan)
        if variant == "rowrange":
            assert torch.equal(ep.packmm_exp_rowrange(torch.from_numpy(words[None]), b, bits, _plan=plan),
                               torch.from_numpy(want))
        else:
            assert torch.equal(ep.packmm_exp(torch.from_numpy(words[None]), b, bits, tm, variant, _plan=plan),
                               torch.from_numpy(want))  # the CPU takes a plan and runs the plain version
    np.testing.assert_array_equal(got, want)


# -- P2a: four words a thread ---------------------------------------------------

def bitcast32to8_walk(x):
    """The kernel's threads: thread c of grid row i (ceil(n / 4) a row)
    takes words j0 = 4 c .. j0 + 3 of row i; with n % 4 == 0 one 16-byte
    load and row 4i + k's word of byte k of each (bytes_at), else the tail
    path's byte stores."""
    m, n = x.shape
    u = x.view(np.uint32)
    out = np.full((4 * m, n), 99, np.int64)
    vec = n % 4 == 0
    for i, c in np.ndindex(m, -(-n // 4)):
        j0 = 4 * c
        for k in range(4):
            if vec:
                word = 0
                for j in range(4):  # bytes_at: byte k of column j in byte j
                    word |= int((u[i, j0 + j] >> (8 * k)) & 0xFF) << (8 * j)
                out[4 * i + k, j0:j0 + 4] = np.frombuffer(np.uint32(word).tobytes(), np.int8)
            else:
                for j in range(j0, min(j0 + 4, n)):
                    out[4 * i + k, j] = np.frombuffer(u[i, j].tobytes(), np.int8)[k]
    return out


@pytest.mark.parametrize("shape", [(8, 128), (5, 40), (64, 300), (3, 7), (2, 1), (4, 6)])
def test_bitcast32to8_walk_equals_plain(shape):
    x = np.random.default_rng(shape[1]).integers(-2**31, 2**31, shape).astype(np.int32)
    np.testing.assert_array_equal(bitcast32to8_walk(x), bp.bitcast32to8_plain(torch.from_numpy(x)).numpy())


# -- P2b: four columns of a word row a thread ---------------------------------

def bitcast8to32_walk(x):
    """The kernel's threads as the C entry launches them: CTAs of
    min(128, ceil(n / 4) rounded up to a warp) threads, one grid row per
    word row i; thread t of CTA b holds columns j = 4 (b * threads + t) ..
    j + 3. With n % 4 == 0 one 4-byte load
    from each byte row 4i + k and word j' = byte j' of each load (the 4 x 4
    byte transpose, bytes_at), else the tail path's word of four single
    bytes. Every word must be written once."""
    rows, n = x.shape
    m, nc = rows // 4, -(-n // 4)
    threads = min(128, -(-nc // 32) * 32)
    u = x.view(np.uint8)
    out = np.zeros((m, n), np.uint32)
    writes = np.zeros((m, n), np.int64)
    vec = n % 4 == 0
    for i, b, t in np.ndindex(m, -(-nc // threads), threads):
        j = 4 * (b * threads + t)
        if j >= n:
            continue
        if vec:
            loads = [int(np.frombuffer(u[4 * i + k, j:j + 4].tobytes(), "<u4")[0]) for k in range(4)]
            for jj in range(4):  # bytes_at(loads, jj): byte jj of load k in byte k
                out[i, j + jj] = sum(((loads[k] >> (8 * jj)) & 0xFF) << (8 * k) for k in range(4))
                writes[i, j + jj] += 1
        else:
            for jj in range(j, min(j + 4, n)):
                out[i, jj] = sum(int(u[4 * i + k, jj]) << (8 * k) for k in range(4))
                writes[i, jj] += 1
    assert (writes == 1).all()
    return out.view(np.int32)


@pytest.mark.parametrize("shape", [(32, 128), (20, 40), (256, 300), (12, 7), (4, 1), (8, 6), (4, 4)])
def test_bitcast8to32_walk_equals_plain(shape):
    x = np.random.default_rng(shape[1]).integers(-128, 128, shape).astype(np.int8)
    want = bp.bitcast8to32_plain(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(bitcast8to32_walk(x), want)
    assert torch.equal(bp.bitcast8to32(torch.from_numpy(x)), torch.from_numpy(want))  # the CPU runs plain


@pytest.mark.parametrize("shape", [(32, 128), (20, 40), (12, 7), (4, 1)])
def test_p2_strided_copies_equal_plain(shape):
    """The library yardsticks timed beside P2a and P2b (``gemm_times``)
    compute the probes' functions."""
    x = torch.from_numpy(np.random.default_rng(shape[1]).integers(-128, 128, shape).astype(np.int8))
    assert torch.equal(gemm_times.strided_8to32(x), bp.bitcast8to32_plain(x))
    w = torch.from_numpy(np.random.default_rng(1).integers(-2**31, 2**31, (shape[0] // 4, shape[1])).astype(np.int32))
    assert torch.equal(gemm_times.strided_32to8(w), bp.bitcast32to8_plain(w))


def test_p2_calls_take_turns_over_copies_out_of_the_l2(monkeypatch):
    monkeypatch.setattr(gemm_times, "P2_SIZES", (("the probe's shape", 32, 128), ("4 MB", 4096, 1024)))
    monkeypatch.setattr(go, "L2_BYTES", 2 ** 20)  # a small L2 keeps the copies and the evicting read small
    ops = gemm_times.p2_operands(3, "cpu")
    assert [len(bs) for _, bs, _ in ops] == [1, go.l2_copies(4096 * 1024)]
    for label, bs, ws in ops:
        assert all(b.shape == bs[0].shape and b.dtype == torch.int8 for b in bs)
        assert all(w.shape == (bs[0].shape[0] // 4, bs[0].shape[1]) and w.dtype == torch.int32 for w in ws)
    rows = gemm_times.p2_calls(3, "cpu")
    assert len(rows) == 11  # 4 a size, the 4 MB probes also before the read, the read alone
    read = 2 * go.L2_BYTES // 4  # the evicting read's float32 ones
    for name, fn in rows.items():
        out = fn()
        if name.startswith("P2 L2 eviction"):
            assert int(out) == read
            continue
        if name.endswith("read"):
            out, total = out
            assert "4 MB" in name and int(total) == read
        want = (8, 128) if "probe" in name else (1024, 1024)
        assert tuple(out.shape) == (want if "P2b" in name else (4 * want[0], want[1]))
