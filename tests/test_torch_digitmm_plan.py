"""K3's launch plan (``ops/digitmm.digitmm_plan``) at the shapes its callers
give it, and ``digitmm_plain`` against JAX's ``_digitmm`` (Pallas interpret
mode) at real widths that are not multiples of 128: the real extents the
kernel now computes, with everything past them zero. The plan is host
arithmetic, so these run on the CPU; the kernel that runs it is held
against plain by ``tests/test_torch_kernels.py`` and ``chip_smoke.py`` on
the card.

Tolerance: exact equality (integer arithmetic; float32 outputs are
integers below 2^24)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgtc_ppopp22_tpu.ops import digitmm as jdigitmm
from qgtc_ppopp22_tpu.ops import digits as jdigits
from qgtc_ppopp22_tpu_torch.ops import digitmm, digits
from qgtc_ppopp22_tpu_torch.ops.digitmm import K3Plan, digitmm_plan
from qgtc_ppopp22_tpu_torch.ops.bitpack import round_up
from torch_cases import blocky_levels, k3_groups, k3_plans, operands
from torch_threads import one_thread  # noqa: F401  (an autouse fixture: one torch thread)

# (nd_a, nd_b, mp, kp, np, K, N, tile_k): the padded extents as DigitTensors
# give them (128 multiples)
SHAPES = [
    (2, 2, 2560, 128, 128, 128, 16, None),  # C1: X[2560x128] x W[128x16]
    (2, 2, 2560, 128, 128, 16, 16, None),  # H[2560x16] x W[16x16]
    (2, 2, 2560, 128, 128, 16, 40, None),  # H[2560x16] x W[16x40]
    (2, 2, 2560, 128, 128, 64, 64, None),  # GIN hidden 64
    (1, 2, 1024, 256, 128, 256, 128, None),
    (2, 1, 384, 128, 128, 16, 128, None),
    (1, 1, 1024, 768, 256, 700, 200, None),
    (1, 2, 2560, 2560, 128, 2560, 16, 256),  # the K skip: A[2560²] digit plane with its map
    (2, 2, 2304, 640, 128, 520, 40, 128),
]


def _ids(shapes):
    return [f"{a}x{b}-{m}x{k}x{n}-K{K}-N{N}-map{t}" for a, b, m, k, n, K, N, t in shapes]


def _smem(nd_a, nd_b, rows, bnt, ks):
    """csrc/digitmm_k3.cuh layout's sums, written out again: 3 slots."""
    ld = ks + 16
    slot = -(-(nd_a * rows * ld + nd_b * ks * bnt) // 128) * 128
    return 3 * slot + nd_b * bnt * ld


@pytest.mark.parametrize("nd_a,nd_b,mp,kp,np_,k,n,tk", SHAPES, ids=_ids(SHAPES))
def test_plan_covers_the_real_extents(nd_a, nd_b, mp, kp, np_, k, n, tk):
    p = digitmm_plan(nd_a, nd_b, mp, kp, np_, k, n, tk)
    assert p.kr == min(round_up(k, 32), kp) and p.nr == min(round_up(n, 8), np_)
    assert p.bnt == (16 if p.nr <= 64 else 32)
    ct = -(-p.nr // p.bnt)  # column tiles over the real columns; no tile of padding only
    assert ct * p.bnt <= np_ and p.grid[1] * p.rows == mp
    assert p.grid[0] == ct + (ct * p.bnt < np_)  # one more column of CTAs stores the padding


@pytest.mark.parametrize("nd_a,nd_b,mp,kp,np_,k,n,tk", SHAPES, ids=_ids(SHAPES))
def test_plan_rows_ring_and_shared_memory(nd_a, nd_b, mp, kp, np_, k, n, tk):
    """Rows: the most of 64, 32, 16 that still give K3_MIN_CTAS CTAs,
    else 16. The stage: the whole real contraction up to 128 columns, a
    map's tile at most. Shared memory: the C entry's sums."""
    p = digitmm_plan(nd_a, nd_b, mp, kp, np_, k, n, tk)
    ct = -(-p.nr // p.bnt)
    assert p.rows == next((r for r in (64, 32, 16) if ct * (mp // r) >= digitmm.K3_MIN_CTAS), 16)
    assert p.ks == (min(p.kr, 128) if tk is None else min(128, tk)) and p.ks % 32 == 0
    assert tk is None or tk % p.ks == 0
    assert p.smem == _smem(nd_a, nd_b, p.rows, p.bnt, p.ks) <= 227 * 1024


@pytest.mark.parametrize("rows", [16, 32, 64])
@pytest.mark.parametrize("bnt", [16, 32])
def test_every_forced_tile_fits_shared_memory(bnt, rows):
    """The deepest stage (128 columns) at two digit planes each side: each
    column tile and tile height the kernel takes fits a block's shared
    memory, as the C entry's sums give it."""
    p = digitmm_plan(2, 2, 2560, 256, 128, 256, 128, bnt=bnt, rows=rows)
    assert (p.bnt, p.rows, p.ks) == (bnt, rows, 128)
    assert p.smem == _smem(2, 2, rows, bnt, 128) <= 227 * 1024
    assert p.grid == (-(-128 // bnt), 2560 // rows)  # 128 real columns: no column of padding CTAs


def test_c1_updates_compute_their_real_extents():
    """C1's three updates: column tiles of 16 (three for N 40) on 40 CTAs
    of 64 rows each, over the real contraction, and one column of CTAs that
    stores the padded columns (the first kernel: two 64-column tiles over
    the 128 padded columns and the whole padded contraction, 80 CTAs)."""
    for k, n, bnt, kr, ct in ((128, 16, 16, 128, 1), (16, 16, 16, 32, 1), (16, 40, 16, 32, 3)):
        p = digitmm_plan(2, 2, 2560, 128, 128, k, n)
        assert (p.bnt, p.kr, p.rows, p.grid, p.ks) == (bnt, kr, 64, (ct + 1, 40), kr)


def test_plan_is_cached_per_shape():
    before = digitmm._cached_k3_plan.cache_info().hits
    a, b = digitmm_plan(2, 2, 2560, 128, 128, 128, 16), digitmm_plan(2, 2, 2560, 128, 128, 128, 16)
    assert a is b and digitmm._cached_k3_plan.cache_info().hits >= before + 1
    assert digitmm_plan(2, 2, 2560, 128, 128, 100, 16) == a  # the same launch: K rounds up to 128


@pytest.mark.parametrize("forced", [dict(bnt=16), dict(bnt=32), dict(rows=64), dict(rows=32), dict(rows=16),
                                    dict(bnt=32, rows=16), dict(bnt=16, rows=64)])
def test_forced_plan_runs_plain_on_the_cpu(forced):
    qa, qb = operands(7, 300, 100, 40, 2, 2, 2, 1)
    a, b = digits.digit_pack(torch.from_numpy(qa), 2), digits.digit_pack(torch.from_numpy(qb), 2)
    p = digitmm_plan(a.ndigits, b.ndigits, 384, 128, 128, 100, 40, **forced)
    assert all(getattr(p, k) == v for k, v in forced.items())
    got = digitmm._digitmm(a, b, 2, 1, False, None, _plan=p)
    assert torch.equal(got.digits, digitmm.digitmm_plain(a, b, 2, 1).digits)
    assert torch.equal(digitmm._digitmm(a, b, None, 0, True, None, _plan=p), digitmm.digitmm_to_i32(a, b))


@pytest.mark.parametrize("bad,msg", [
    (dict(bnt=8), "column tile"), (dict(bnt=64), "column tile"), (dict(bnt=128), "column tile"),
    (dict(rows=8), "rows per CTA"), (dict(rows=128), "rows per CTA"), (dict(rows=48), "rows per CTA"),
])
def test_impossible_plan_is_refused(bad, msg):
    with pytest.raises(ValueError, match=msg):
        digitmm_plan(2, 2, 2560, 128, 128, 128, 16, **bad)


def test_a_plan_of_another_shape_is_refused():
    qa, qb = operands(8, 300, 100, 40, 2, 2, 2, 1)
    a, b = digits.digit_pack(torch.from_numpy(qa), 2), digits.digit_pack(torch.from_numpy(qb), 2)
    chosen = digitmm_plan(2, 2, 384, 128, 128, 100, 40)
    for wrong in (dataclasses.replace(chosen, kr=128), dataclasses.replace(chosen, grid=(2, 24)),
                  dataclasses.replace(chosen, smem=chosen.smem + 16), dataclasses.replace(chosen, ks=64)):
        with pytest.raises(ValueError, match="not the kernel's"):
            digitmm._digitmm(a, b, 2, 1, False, None, _plan=wrong)
    assert isinstance(chosen, K3Plan)


def test_k3_groups_cover_every_plan_choice():
    """chip_smoke.py's and the CUDA tests' K3 cases: every column tile,
    and tile height, maps included."""
    seen = {"bnt": set(), "rows": set()}
    mapped = 0
    for _, kw in k3_groups():
        qa = blocky_levels(kw["seed"], kw["m"], kw["k"], kw["a_bits"], 0.05)
        a = digits.digit_pack(torch.from_numpy(qa), kw["a_bits"])
        b = digits.digit_pack(torch.zeros((kw["k"], kw["n"]), dtype=torch.int32), kw["b_bits"])
        tm = digitmm.build_tile_map_digits(a) if kw["tile_map"] else None
        mapped += tm is not None
        for p in k3_plans(a, b, tm):
            for key in seen:
                seen[key].add(getattr(p, key))
    assert seen == {"bnt": {16, 32}, "rows": {16, 32, 64}} and mapped == 4


# -- digitmm_plain against JAX at real widths below the 128-lane padding ------


def _jdt(q, bits):
    return jdigits.digit_pack(jnp.asarray(q), bits)


@pytest.mark.parametrize("m,k,n", [(300, 128, 16), (300, 16, 16), (300, 16, 40), (260, 100, 40)])
@pytest.mark.parametrize("bits", [2, 8])
def test_digitmm_plain_matches_jax_at_real_widths(m, k, n, bits):
    """Digits out over the whole padded container: the port's and JAX's
    agree element for element, and every column past N and row past M is
    level 0; f32 and i32 compared over the real extents, as the graft's
    check cuts the reference to the port's shape."""
    qa, qb = operands(m + 3 * k + n + bits, m, k, n, bits, bits, bits, 1)
    a, b = digits.digit_pack(torch.from_numpy(qa), bits), digits.digit_pack(torch.from_numpy(qb), bits)
    got = digitmm.digitmm_plain(a, b, bits, 1)
    ref = jdigitmm.digitmm_to_digits(_jdt(qa, bits), _jdt(qb, bits), bits, shift=1)
    assert got.digits.shape == tuple(ref.digits.shape)
    np.testing.assert_array_equal(got.digits.numpy(), np.asarray(ref.digits))
    assert not got.digits[:, :, n:].any() and not got.digits[:, m:, :].any()
    assert got.digits[:, :m, :n].any()
    for raw, jfn in ((False, jdigitmm.digitmm_to_f32), (True, jdigitmm.digitmm_to_i32)):
        g = digitmm.digitmm_plain(a, b, raw_i32=raw).numpy()
        r = np.asarray(jfn(_jdt(qa, bits), _jdt(qb, bits)))
        np.testing.assert_array_equal(g, r[: g.shape[0], : g.shape[1]])
        assert g.shape == (m, n)
