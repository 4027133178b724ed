"""K2's launch plan (``ops/packmm.packmm_plan``) at the shapes its callers
give it: C1's aggregations (with and without batch 0's kind of map), the
kernel sweep's figures 8a, 8c and profile, and ragged ones. The plan is
host arithmetic, so these run on the CPU; the kernel that runs it is
held against plain by ``tests/test_torch_kernels.py`` on the card."""

import dataclasses

import numpy as np
import pytest
import torch

from qgtc_ppopp22_tpu_torch.ops import packmm
from qgtc_ppopp22_tpu_torch.ops.bitgemm import TileMap
from qgtc_ppopp22_tpu_torch.ops.bitpack import round_up
from qgtc_ppopp22_tpu_torch.ops.digits import digit_pack
from qgtc_ppopp22_tpu_torch.ops.packmm import pack_rows, packmm_plan

# (mp, kp, np, N, out_form, out_cols): the padded extents as the
# containers give them (rows to 256, K and N to 128)
SHAPES = [
    (2560, 2560, 128, 16, "digits", None),  # C1's aggregations
    (2560, 2560, 128, 40, "f32", None),
    (2560, 2560, 128, 40, "f32", 40),
    (512, 640, 128, 40, "digits", None),  # ragged: M 300, K 520
    (512, 640, 128, 40, "plane", 40),
    (256, 512, 256, 200, "words", 200),
    (256, 512, 128, 8, "i32", None),
    (768, 448, 128, 72, "words", 8),
] + [(mk, mk, 128, n, "words", None) for mk in (1024, 2048, 4096) for n in (16, 32, 64)] \
  + [(mk, mk, round_up(n, 128), n, "words", None) for mk in (1024, 4096) for n in (128, 512, 1024)] \
  + [(32768, 32768, 128, n, "words", None) for n in (16, 64)]


def _ocp(np_, form, out_cols):
    return np_ if out_cols is None else min(round_up(out_cols, 8), np_)


def _ids(shapes):
    return [f"{m}x{k}x{n}-N{N}-{f}-oc{oc}" for m, k, n, N, f, oc in shapes]


def _c1_map(rows=2560, k=2560, tile_k=256):
    nm, nk = rows // 256, k // tile_k
    kcnt = torch.tensor([(i % 4) + 2 for i in range(nm)], dtype=torch.int32)
    return TileMap(kidx=torch.zeros((nm, nk), dtype=torch.int32), kcnt=kcnt, tile_m=256, tile_k=tile_k)


@pytest.mark.parametrize("mp,kp,np_,n,form,out_cols", SHAPES, ids=_ids(SHAPES))
def test_plan_column_tiles_cover_the_real_columns(mp, kp, np_, n, form, out_cols):
    ocp = _ocp(np_, form, out_cols)
    p = packmm_plan(mp, kp, np_, n, form, ocp)
    need = min(round_up(n, 8), np_ if form == "digits" else ocp)
    assert p.bnt in (16, 32, 64)
    assert p.grid[0] * p.bnt >= need > (p.grid[0] - 1) * p.bnt  # no tile of padding only
    assert p.grid[0] * p.bnt <= np_  # B's columns exist for every tile
    small = mp // 64 < 2 * packmm.SMS  # few rows: narrower tiles
    if need <= 16 or (small and need <= 48 and form != "words"):
        assert p.bnt == 16
    else:
        assert p.bnt == (32 if need <= 32 or (small and need <= 64) else 64)
    assert p.grid[0] <= 3 or p.bnt == 64  # a wide N takes the widest tile
    assert p.grid[1] * 64 == mp


@pytest.mark.parametrize("mp,kp,np_,n,form,out_cols", SHAPES, ids=_ids(SHAPES))
def test_plan_split_and_cluster(mp, kp, np_, n, form, out_cols):
    p = packmm_plan(mp, kp, np_, n, form, _ocp(np_, form, out_cols))
    assert 1 <= p.splits <= packmm.MAX_SPLIT and p.grid[2] == p.cluster[2] == p.splits
    assert p.cluster[0] == 1 and np.prod(p.cluster) <= 8  # the portable cluster size
    assert all(g % c == 0 for g, c in zip(p.grid, p.cluster))
    if form == "words":  # one cluster row is one 256-row packing group
        assert p.cluster[1] * 64 == packmm.PACK_GROUP and p.splits <= packmm.PACK_SPLIT
    else:
        assert p.cluster[1] == 1
    ctas = p.grid[0] * p.grid[1]
    assert p.splits == 1 or ctas * p.splits <= packmm.RESIDENT  # a split only fills the card
    assert p.splits == min(packmm.PACK_SPLIT if form == "words" else packmm.MAX_SPLIT,
                           max(1, packmm.RESIDENT // ctas), max(1, kp // 256))
    # the kernel's shares: ceil(steps / S) each, the last one the rest;
    # every split has at least 4 of the 64-deep steps
    steps = kp // 64
    share = -(-steps // p.splits)
    shares = [max(0, min(steps - z * share, share)) for z in range(p.splits)]
    assert sum(shares) == steps and min(shares) >= min(4, steps)


@pytest.mark.parametrize("tile_k", [128, 256])
@pytest.mark.parametrize("form", ["digits", "f32", "words"])
def test_plan_with_a_map_keeps_each_cluster_in_one_map_row(form, tile_k):
    tm = _c1_map(tile_k=tile_k)
    p = packmm_plan(2560, 2560, 128, 16, form, 128, tm)
    nk = 2560 // tile_k
    assert 1 <= p.splits <= nk  # each split can hold a listed tile
    rows = p.cluster[1] * 64  # the rows a cluster covers; splits share them
    assert tm.tile_m % rows == 0
    assert p == packmm_plan(2560, 2560, 128, 16, form, 128, dataclasses.replace(tm, kcnt=tm.kcnt * 0))


def test_plan_at_c1_fills_the_card():
    """C1's 40 row tiles: 4 CTAs each on a 16-column tile (three of them
    for the 40 classes); the sweep's 4096² x 64 to words: two 32-column
    tiles, 2 CTAs each."""
    p = packmm_plan(2560, 2560, 128, 16, "digits", 128)
    assert (p.bnt, p.splits, p.cluster, p.grid) == (16, 4, (1, 1, 4), (1, 40, 4))
    p = packmm_plan(2560, 2560, 128, 40, "f32", 40)
    assert (p.bnt, p.splits, p.cluster, p.grid) == (16, 4, (1, 1, 4), (3, 40, 4))
    p = packmm_plan(2560, 2560, 128, 64, "f32", 64)
    assert (p.bnt, p.splits, p.cluster, p.grid) == (32, 4, (1, 1, 4), (2, 40, 4))
    p = packmm_plan(4096, 4096, 128, 64, "words", 128)
    assert (p.bnt, p.splits, p.cluster, p.grid) == (32, 2, (1, 4, 2), (2, 64, 2))
    p = packmm_plan(32768, 32768, 128, 64, "words", 128)
    assert p.splits == 1 and p.grid == (1, 512, 1)


@pytest.mark.parametrize("out_bits,out_form,raw,want", [
    (None, "f32", False, "f32"), (None, "f32", True, "i32"), (2, "digits", False, "digits"),
    (4, "packed", False, "words"), (1, "packed", False, "words"), (8, "packed", False, "plane"),
    (5, "packed", False, "plane"),
])
def test_plan_form_of_the_wrapper_arguments(out_bits, out_form, raw, want):
    assert packmm._plan_form(out_bits, out_form, raw) == want


def test_plan_refuses_an_unknown_form():
    with pytest.raises(ValueError, match="out_form"):
        packmm_plan(256, 256, 128, 16, "packed", 128)


def test_forced_plan_on_cpu_runs_plain():
    """``_plan`` only picks the card's launch: on the CPU the wrapper runs
    the plain version whatever plan it is given."""
    rng = np.random.default_rng(0)
    a = pack_rows(torch.from_numpy(rng.integers(0, 2, (300, 200)).astype(np.int32)), 1)
    b = digit_pack(torch.from_numpy(rng.integers(0, 4, (200, 24)).astype(np.int32)), 2)
    plan = packmm_plan(a.padded_rows, a.padded_cols, b.padded_cols, 24, "digits", b.padded_cols)
    forced = dataclasses.replace(plan, splits=4, cluster=(1, 1, 4), grid=(*plan.grid[:2], 4))
    got = packmm._packmm(a, b, 2, "digits", 0, False, _plan=forced)
    assert torch.equal(got.digits, packmm.packmm_plain(a, b, 2).digits)


@pytest.mark.parametrize("bnt", [16, 32, 64])
def test_plan_takes_a_forced_column_tile(bnt):
    """``bnt=`` (the benchmark's comparison of tiles) keeps the rest of the
    plan's rules: the tiles cover the columns, the split fills the card."""
    p = packmm_plan(2560, 2560, 128, 40, "f32", 40, bnt=bnt)
    tiles = -(-40 // bnt)
    assert p.bnt == bnt and p.grid == (tiles, 40, p.splits)
    assert p.splits == min(packmm.MAX_SPLIT, packmm.RESIDENT // (tiles * 40))


def test_plan_is_computed_once_per_shape():
    """The wrapper asks for the plan at every launch: the same integers
    (and the same map tile depth, whatever the map's entries) give the same
    object back."""
    assert packmm_plan(2560, 2560, 128, 16, "digits", 128) is packmm_plan(2560, 2560, 128, 16, "digits", 128)
    tm = _c1_map()
    again = dataclasses.replace(tm, kcnt=tm.kcnt + 1)
    assert packmm_plan(2560, 2560, 128, 16, "digits", 128, tm) is packmm_plan(2560, 2560, 128, 16, "digits",
                                                                              128, again)
