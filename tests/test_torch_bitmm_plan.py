"""K6's launch plan (``ops/bitgemm.bitmm_plan``) at the shapes its callers
give it: C1's six GEMMs (with and without a map), GIN's hidden 64, ragged
and wide ones. The plan is host arithmetic, so these run on the CPU; the
kernel that runs it is held against plain by ``tests/test_torch_kernels.py``
on the card."""

import dataclasses

import numpy as np
import pytest
import torch

from qgtc_ppopp22_tpu_torch.ops import bitgemm
from qgtc_ppopp22_tpu_torch.ops.bitgemm import TileMap, bitmm_plan
from qgtc_ppopp22_tpu_torch.ops.bitpack import pack_bits, round_up

# (mp, kp, np, N, out_form): the padded extents as BitTensors give them
# (rows, K and N to 256)
SHAPES = [
    (2560, 256, 256, 16, "bits"),  # C1: X[2560x128] x W[128x16]
    (2560, 2560, 256, 16, "bits"),  # A x H[2560x16]
    (2560, 256, 256, 16, "bits"),  # H[2560x16] x W[16x16]
    (2560, 256, 256, 40, "bits"),  # H[2560x16] x W[16x40]
    (2560, 2560, 256, 40, "f32"),  # A x H[2560x40]
    (2560, 2560, 256, 64, "bits"),  # GIN hidden 64
    (2560, 256, 256, 64, "bits"),
    (512, 768, 256, 40, "bits"),  # ragged: M 300, K 520
    (512, 768, 256, 40, "f32"),
    (256, 512, 256, 200, "f32"),
    (256, 512, 256, 256, "bits"),
    (1024, 1024, 512, 300, "bits"),
    (256, 33280, 256, 16, "bits"),
    (4096, 4096, 256, 64, "bits"),
    (32768, 32768, 256, 16, "bits"),
]


def _ids(shapes):
    return [f"{m}x{k}x{n}-N{N}-{f}" for m, k, n, N, f in shapes]


def _c1_map(tile_k=512):
    nm, nk = 2560 // 512, 2560 // tile_k
    kcnt = torch.tensor([(i % 3) + 1 for i in range(nm)], dtype=torch.int32)
    return TileMap(kidx=torch.zeros((nm, nk), dtype=torch.int32), kcnt=kcnt, tile_m=512, tile_k=tile_k)


@pytest.mark.parametrize("mp,kp,np_,n,form", SHAPES, ids=_ids(SHAPES))
def test_plan_column_tiles_cover_the_real_columns(mp, kp, np_, n, form):
    p = bitmm_plan(mp, kp, np_, n, form)
    need = min(round_up(n, 8), np_)
    assert p.bnt in (16, 32, 64)
    assert p.grid[0] * p.bnt >= need > (p.grid[0] - 1) * p.bnt  # no tile of padding only
    assert p.grid[0] * p.bnt <= np_  # B's columns exist for every tile
    assert p.bnt == next((t for t in (16, 32) if need <= t), 64)  # the narrowest that holds them
    assert p.grid[1] * 64 == mp


@pytest.mark.parametrize("mp,kp,np_,n,form", SHAPES, ids=_ids(SHAPES))
def test_plan_split_and_cluster(mp, kp, np_, n, form):
    p = bitmm_plan(mp, kp, np_, n, form)
    steps = kp // bitgemm.K_STEP
    assert 1 <= p.splits <= bitgemm.MAX_SPLIT
    assert p.grid[2] == p.cluster[2] == p.splits and p.cluster[:2] == (1, 1)
    ctas = p.grid[0] * p.grid[1]
    assert p.splits == 1 or ctas * p.splits <= bitgemm.RESIDENT  # a split only fills the card
    assert p.splits == max(1, min(bitgemm.MAX_SPLIT, bitgemm.RESIDENT // ctas, steps // bitgemm.MIN_STEPS))
    # the kernel's shares: floor((z + 1) steps / S) - floor(z steps / S),
    # all the steps once; a split's CTAs hold MIN_STEPS steps or more
    shares = [(z + 1) * steps // p.splits - z * steps // p.splits for z in range(p.splits)]
    assert sum(shares) == steps and (p.splits == 1 or min(shares) >= bitgemm.MIN_STEPS)


@pytest.mark.parametrize("tile_k", [256, 512])
@pytest.mark.parametrize("form", ["bits", "f32"])
def test_plan_with_a_map_keeps_each_cluster_in_one_map_row(form, tile_k):
    tm = _c1_map(tile_k)
    p = bitmm_plan(2560, 2560, 256, 16, form, tm)
    nk = 2560 // tile_k
    assert 1 <= p.splits <= min(nk, bitgemm.MAX_SPLIT)  # each split can hold a listed tile
    rows = p.cluster[1] * 64  # the rows a cluster covers; its splits share them
    assert rows == 64 and tm.tile_m % rows == 0
    assert p == bitmm_plan(2560, 2560, 256, 16, form, dataclasses.replace(tm, kcnt=tm.kcnt * 0))


def test_plan_at_c1():
    """C1's aggregations: 40 row tiles of one column tile, split in 2 (5 K
    steps a CTA; 3 and 4 splits measured slower); the updates' single K
    step runs unsplit, one CTA a row tile; a deep K fills the card with
    4 splits; a 512-row-tile grid is not split."""
    for n, form in ((16, "bits"), (40, "f32")):
        p = bitmm_plan(2560, 2560, 256, n, form)
        assert (p.bnt, p.splits, p.cluster, p.grid) == (16 if n == 16 else 64, 2, (1, 1, 2), (1, 40, 2))
    for n in (16, 40):
        p = bitmm_plan(2560, 256, 256, n, "bits")
        assert p.splits == 1 and p.grid == (1, 40, 1)
    p = bitmm_plan(4096, 4096, 256, 64, "bits")
    assert p.splits == 4 and p.grid[0] * p.grid[1] * p.splits >= bitgemm.SMS
    assert bitmm_plan(32768, 32768, 256, 16, "bits").grid == (1, 512, 1)


def test_forced_plan_on_cpu_runs_plain():
    """``_plan`` only picks the card's launch: on the CPU the wrapper runs
    the plain version whatever plan it is given."""
    rng = np.random.default_rng(0)
    a = pack_bits(torch.from_numpy(rng.integers(0, 2, (300, 520)).astype(np.int32)), 1)
    b = pack_bits(torch.from_numpy(rng.integers(0, 4, (520, 40)).astype(np.int32)), 2)
    plan = bitmm_plan(a.padded_rows, a.padded_cols, b.padded_cols, 40, "bits", bnt=16)
    forced = dataclasses.replace(plan, splits=4, cluster=(1, 1, 4), grid=(*plan.grid[:2], 4))
    before = bitgemm.LAUNCHES
    got = bitgemm._bitmm(a, b, 2, None, _plan=forced)
    assert torch.equal(got.planes, bitgemm.bitmm_plain(a, b, 2).planes)
    assert torch.equal(bitgemm._bitmm(a, b, None, None, _plan=forced), bitgemm.bitmm_plain(a, b, None))
    assert bitgemm.LAUNCHES == before  # no kernel ran


def test_plan_refuses_an_unknown_form():
    with pytest.raises(ValueError, match="out_form"):
        bitmm_plan(256, 256, 256, 16, "digits")


@pytest.mark.parametrize("bnt", [16, 32, 64])
def test_plan_takes_a_forced_column_tile(bnt):
    """``bnt=`` (the benchmark's comparison of tiles) keeps the rest of the
    plan's rules: the tiles cover the columns, the split fills the card."""
    p = bitmm_plan(2560, 2560, 256, 40, "f32", bnt=bnt)
    tiles = -(-40 // bnt)
    assert p.bnt == bnt and p.grid == (tiles, 40, p.splits)
    assert p.splits == min(bitgemm.MAX_SPLIT, bitgemm.RESIDENT // (tiles * 40), 10 // bitgemm.MIN_STEPS)


def test_plan_is_computed_once_per_shape():
    """The wrapper asks for the plan at every launch: the same integers
    (and the same map tile depth, whatever the map's entries) give the same
    object back."""
    assert bitmm_plan(2560, 2560, 256, 16, "bits") is bitmm_plan(2560, 2560, 256, 16, "bits")
    tm = _c1_map()
    again = dataclasses.replace(tm, kcnt=tm.kcnt + 1)
    assert bitmm_plan(2560, 2560, 256, 16, "bits", tm) is bitmm_plan(2560, 2560, 256, 16, "bits", again)
