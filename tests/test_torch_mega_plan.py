"""K1's launch plan (``ops/fused_model.fused_model_plan``) at the shapes
its callers give it: C1 and C1-8 (pn 2560, hidden 16), GIN's hidden 64,
feature width 100, 128 and 602, a 2-digit hidden plane, odd remainders
(pn 768, B 3), 1-layer chains, and GIN over features too wide for a
128-row tile (64 rows) or for either tile (refused). The plan is host arithmetic, so these run on the
CPU; the kernel that runs it is held against plain under every plan by
``tests/test_torch_kernels.py`` (``torch_cases.k1_groups``) on the card."""

import dataclasses

import numpy as np
import pytest
import torch

from qgtc_ppopp22_tpu_torch.ops import digits, fused_model
from qgtc_ppopp22_tpu_torch.ops.fused_model import K1Plan, fused_model_plan
from torch_cases import levels_plane, mega_case
from torch_threads import one_thread  # noqa: F401  (an autouse fixture: one torch thread)

LIMIT = 227 * 1024

# (model, B, pn, feat, hidden, bits, levels, layers)
SHAPES = [
    ("gcn", 75, 2560, 128, 16, 2, False, 3),  # C1
    ("gcn", 75, 2560, 128, 16, 8, True, 3),  # C1-8: the signed chain
    ("gin", 4, 2560, 128, 64, 2, False, 3),
    ("gin", 4, 2560, 128, 64, 8, True, 3),
    ("gcn", 2, 512, 100, 48, 8, True, 3),
    ("gcn", 3, 768, 128, 48, 8, False, 3),  # 2 digit planes of H
    ("gin", 3, 768, 100, 64, 4, False, 3),
    ("gcn", 2, 2560, 128, 64, 8, False, 3),  # a 2-digit width-64 plane
    ("gin", 2, 2560, 602, 64, 8, True, 3),  # reddit's features: the signed chain, 128 rows fit
    ("gin", 2, 2560, 602, 64, 4, False, 3),
    ("gin", 2, 512, 128, 16, 2, False, 1),
    ("gcn", 2, 256, 128, 128, 5, True, 2),  # the split form (no free lane)
]


def _ids(shapes):
    return [f"{m}-B{b}-pn{pn}-f{f}-h{h}-b{bits}{'-lv' if lv else ''}-L{n}" for m, b, pn, f, h, bits, lv, n in shapes]


def _geometry(model, B, pn, feat, hidden, bits, levels, layers):
    rng = np.random.default_rng(pn + hidden)
    dims = [feat] + [hidden] * (layers - 1) + [40]
    ws = [digits.digit_pack(torch.from_numpy(rng.integers(0, 2, (k, n)).astype(np.int32)), bits)
          for k, n in zip(dims, dims[1:])]
    xp = -(-feat // 128) * 128
    nd_x = 1 if levels else -(-bits // 4)
    return fused_model.plan((B, pn // 32, pn), (B, nd_x, pn, xp), ws, bits, model, None, 40,
                            x_levels_bits=bits if levels else None), ws


@pytest.mark.parametrize("shape", SHAPES, ids=_ids(SHAPES))
def test_plan_tiles_cover_pn(shape):
    p, _ = _geometry(*shape)
    kp = fused_model_plan(p, shape[0])
    tiles = p.pn // kp.rows
    assert kp.rows in fused_model.K1_ROWS and tiles * kp.rows == p.pn
    assert 1 <= kp.cl <= min(fused_model.K1_MAX_CLUSTER, tiles) and kp.grid == p.B * kp.cl
    owned = sorted(t for r in range(kp.cl) for t in range(r, tiles, kp.cl))
    assert owned == list(range(tiles))  # every row tile, once
    # the fewest tiles a CTA, then the smallest cluster that gives them
    assert -(-tiles // kp.cl) == min(-(-tiles // c) for c in range(1, min(8, tiles) + 1))
    assert kp.stages in fused_model.K1_STAGES and kp.smem <= LIMIT


@pytest.mark.parametrize("shape", SHAPES, ids=_ids(SHAPES))
def test_64_rows_only_where_128_do_not_fit(shape):
    """128-row CTAs wherever some plan of them fits the shared memory;
    then the deepest stage, then 4 stages or 3, that fit at those rows."""
    p, _ = _geometry(*shape)
    model = shape[0]

    def fits(rows, stages, depth):
        return fused_model._k1_smem(p, model, rows, stages, depth) <= LIMIT

    chosen = fused_model_plan(p, model)
    any128 = any(fits(128, s, d) for s in fused_model.K1_STAGES for d in fused_model.K1_DEPTHS)
    assert chosen.rows == (128 if any128 else 64)
    assert chosen.depth == max(d for d in fused_model.K1_DEPTHS
                               if any(fits(chosen.rows, s, d) for s in fused_model.K1_STAGES))
    assert chosen.stages == max(s for s in fused_model.K1_STAGES if fits(chosen.rows, s, chosen.depth))
    assert chosen.smem == fused_model._k1_smem(p, model, chosen.rows, chosen.stages, chosen.depth) <= LIMIT
    for rows in fused_model.K1_ROWS:  # a forced height: its own plan, or refused for shared memory
        try:
            kp = fused_model_plan(p, model, rows=rows)
        except ValueError as e:
            assert "shared memory" in str(e) and not fits(rows, 3, 64)
            continue
        assert kp.rows == rows and kp.smem == fused_model._k1_smem(p, model, rows, kp.stages, kp.depth)


def _wide_gin(feat, bits=8):
    """GIN with 128 classes (no free lane: the split form at 8 bits, 2
    digit planes of X, W and H) over ``feat`` features."""
    rng = np.random.default_rng(feat)
    dims = [feat, 64, 64, 128]
    ws = [digits.digit_pack(torch.from_numpy(rng.integers(0, 2, (k, n)).astype(np.int32)), bits)
          for k, n in zip(dims, dims[1:])]
    xp = -(-feat // 128) * 128
    return fused_model.plan((2, 2560 // 32, 2560), (2, 1, 2560, xp), ws, bits, "gin", None, 128,
                            x_levels_bits=bits)


def test_wide_x_falls_back_to_64_rows():
    """GIN's Q holds X's width: at xp 512 with 2-digit planes no 128-row
    plan fits, a 64-row one does."""
    p = _wide_gin(500)
    assert (p.form, p.xp, p.nd_h) == ("split", 512, 2)
    with pytest.raises(ValueError, match="shared memory"):
        fused_model_plan(p, "gin", rows=128)
    kp = fused_model_plan(p, "gin")
    assert kp.rows == 64 and kp.smem <= LIMIT and kp.cl == 8


def test_a_bucket_too_wide_for_either_tile_is_refused():
    """At xp 640 (reddit's 602 features) with 2-digit planes even 64 rows
    need 235136 bytes; the plan refuses, so the mega engine runs such a
    bucket through the step engine (one launch per GEMM), where the
    previous K1, with Q in device memory, ran it in one launch."""
    p = _wide_gin(602)
    assert (p.form, p.xp) == ("split", 640)
    with pytest.raises(ValueError, match="K1 needs 235136 bytes of shared memory at rows 64"):
        fused_model_plan(p, "gin")


def test_c1_plan_and_layout():
    """C1's launch and the layout's sums (csrc/fused_model_k1.cuh layout):
    128-row CTAs, 7 a batch (3 tiles each, the last 2); forced to 3 stages
    of 64 columns, each slot the step's padded word rows and the hidden
    plane's 64 rows. The default takes 4 stages of 256 columns."""
    p, _ = _geometry(*SHAPES[0])
    assert p.widths == [16, 16, 48]
    kp = fused_model_plan(p, "gcn", rows=128, stages=3, depth=64)
    assert (kp.rows, kp.cl, kp.stages, kp.grid, kp.depth) == (128, 7, 3, 525, 64)
    ring = 3 * (8 * (256 + 64) + 64 * 80)  # padded word rows + a streamed plane's 64 rows a slot
    front = max(ring, 128 * (128 + 16))  # or GCN's first update: X's rows
    q = 128 * (32 + 16)
    wt = max(16 * (128 + 16), 16 * (32 + 16), 48 * (32 + 16))
    assert kp.smem == front + q + wt + 8 * 64 * 16 + 8 * 4 * 4
    chosen = fused_model_plan(p, "gcn")
    assert (chosen.rows, chosen.cl, chosen.stages, chosen.depth) == (128, 7, 4, 256) and chosen.smem <= LIMIT


def test_plan_is_cached_per_shape():
    p, _ = _geometry(*SHAPES[0])
    before = fused_model._cached_k1_plan.cache_info().hits
    a, b = fused_model_plan(p, "gcn"), fused_model_plan(dataclasses.replace(p, nj=5, chunk=256), "gcn")
    assert a is b and fused_model._cached_k1_plan.cache_info().hits >= before + 1
    other = fused_model_plan(dataclasses.replace(p, B=3), "gcn")
    assert other is not a and other.grid == 3 * other.cl


@pytest.mark.parametrize("forced", [dict(rows=64), dict(rows=128, cl=3), dict(stages=3), dict(stages=4),
                                    dict(rows=128, depth=128, stages=4), dict(rows=64, cl=1, stages=3),
                                    dict(depth=64), dict(depth=128, stages=3), dict(rows=64, depth=256)])
def test_forced_plan_runs_plain_on_the_cpu(forced):
    _, _, qws, aw, xd = mega_case(3, 2, 512, 2, 16)
    ws = [digits.digit_pack(torch.from_numpy(w), 2) for w in qws]
    a, x = torch.from_numpy(aw), torch.from_numpy(xd)
    p = fused_model.plan(a.shape, x.shape, ws, 2, "gcn", None, None)
    kp = fused_model_plan(p, "gcn", **forced)
    assert all(getattr(kp, k) == v for k, v in forced.items())
    got = fused_model.fused_model_epoch(a, x, ws, 2, _plan=kp)
    assert torch.equal(got, fused_model.fused_model_epoch_plain(a, x, ws, 2))


@pytest.mark.parametrize("bad,msg", [
    (dict(rows=96), "rows per CTA"), (dict(rows=32), "rows per CTA"), (dict(cl=9), "CTAs per batch"),
    (dict(rows=128, cl=5), "CTAs per batch"), (dict(cl=0), "CTAs per batch"), (dict(stages=2), "ring depth"),
    (dict(stages=7), "ring depth"), (dict(stages=17), "ring depth"), (dict(stages=16), "ring depth"),
    (dict(depth=32), "stage depth"), (dict(depth=512), "stage depth"),
    (dict(rows=256), "rows per CTA"),
])
def test_impossible_plan_is_refused(bad, msg):
    """pn 512: 8 tiles of 64 rows, 4 of 128."""
    _, _, qws, aw, xd = mega_case(4, 1, 512, 2, 16)
    ws = [digits.digit_pack(torch.from_numpy(w), 2) for w in qws]
    p = fused_model.plan(aw.shape, xd.shape, ws, 2, "gcn", None, None)
    with pytest.raises(ValueError, match=msg):
        fused_model_plan(p, "gcn", **bad)


def test_a_plan_of_another_shape_is_refused():
    _, _, qws, aw, xd = mega_case(5, 2, 512, 2, 16)
    ws = [digits.digit_pack(torch.from_numpy(w), 2) for w in qws]
    a, x = torch.from_numpy(aw), torch.from_numpy(xd)
    p = fused_model.plan(a.shape, x.shape, ws, 2, "gcn", None, None)
    wrong = dataclasses.replace(fused_model_plan(p, "gcn"), grid=3 * fused_model_plan(p, "gcn").cl)
    with pytest.raises(ValueError, match="not the kernel's"):
        fused_model.fused_model_epoch(a, x, ws, 2, _plan=wrong)
    gin_plan = fused_model_plan(p, "gin")
    with pytest.raises(ValueError, match="not the kernel's"):
        fused_model.fused_model_epoch(a, x, ws, 2, _plan=dataclasses.replace(gin_plan, smem=gin_plan.smem + 16))
    assert isinstance(gin_plan, K1Plan)


def test_levels_plan_at_low_bits():
    """The 1-4-bit levels form plans as the other forms do: one X plane."""
    _, _, qws, aw, xd = mega_case(6, 2, 512, 4, 16)
    ws = [digits.digit_pack(torch.from_numpy(w), 4) for w in qws]
    xl = levels_plane(xd)
    p = fused_model.plan(aw.shape, xl.shape, ws, 4, "gin", None, 40, x_levels_bits=4)
    assert (p.form, p.nd_x) == ("signed", 1)
    kp = fused_model_plan(p, "gin")
    assert kp.smem == fused_model._k1_smem(p, "gin", kp.rows, kp.stages, kp.depth)
