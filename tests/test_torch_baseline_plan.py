"""K5's launch plan (``ops/fused_model.fused_baseline_plan``) at the shapes
its callers give it: C1-baseline (75 batches at pn 2560, sage widths
128 -> 16 -> 16 -> 40), the gin widths, small buckets and wide features.
The plan is host arithmetic, so these run on the CPU; the kernel that runs
it is held against plain by ``tests/test_torch_kernels.py`` and
``chip_smoke.py`` on the card."""

import dataclasses

import pytest
import torch

from qgtc_ppopp22_tpu_torch.ops import fused_model
from qgtc_ppopp22_tpu_torch.ops.fused_model import K5Plan, fused_baseline_plan
from torch_cases import baseline_case, k5_groups, k5_plans

SMS = 132
LIMIT = 227 * 1024
SAGE = [(128, 16), (16, 16), (16, 40)]
GIN = [(128, 64), (64, 64), (64, 40)]
# (B, pn, x width, weight shapes)
SHAPES = [
    (75, 2560, 128, SAGE),  # C1-baseline
    (75, 2560, 128, [(128, 40)]),  # its first layer alone
    (75, 2560, 128, GIN),
    (4, 2560, 128, GIN),
    (2, 512, 128, SAGE),
    (3, 256, 200, [(200, 24), (24, 10)]),  # X wider than one 128-column pass
    (5, 768, 602, [(602, 64), (64, 64), (64, 41)]),  # reddit's features at gin widths
    (1, 4096, 100, [(100, 128)] + [(128, 128)] * 7),  # 8 layers at the widest output
]


def _ids(shapes):
    return [f"B{b}-pn{pn}-x{x}-{len(ws)}l-h{ws[0][1]}" for b, pn, x, ws in shapes]


def _plan(B, pn, xp, ws, **kw):
    return fused_baseline_plan((B, pn, pn), (B, pn, xp), ws, **kw)


def _layout(kp, np_):
    """csrc/fused_baseline_k5.cuh layout's sums, written out again: each
    layer's passes all its columns up to 128, else 64 at a time; its stage
    256 columns deep at passes of <= 32 columns, 128 wider; 3 slots of
    the largest stage (h^T's rows in bf16, then A's 128 rows) in 1024-byte
    multiples; then W^T of the widest pass, 2 x 3 mbarriers and 1024 bytes
    to align the base."""
    kn = [k if k <= 128 else 64 for k in kp]
    kd = tuple(256 if c <= 32 else 128 for c in kn)
    slot = max(d * c * 2 + 128 * d for d, c in zip(kd, kn))
    slot = -(-slot // 1024) * 1024
    w = 3 * slot + max(n * (c + 8) * 2 for c, n in zip(kn, np_))
    return slot, kd, -(-w // 8) * 8 + 48 + 1024


@pytest.mark.parametrize("B,pn,xp,ws", SHAPES, ids=_ids(SHAPES))
def test_plan_fits_the_card(B, pn, xp, ws):
    p = _plan(B, pn, xp, ws)
    bp = fused_model.baseline_plan((B, pn, pn), (B, pn, xp), ws)
    assert (p.slot, p.kd, p.smem) == _layout(bp.kp, bp.np)
    assert p.smem <= LIMIT and p.slot % 1024 == 0
    assert p.grid == p.groups * p.ctas <= SMS  # one CTA an SM, every one resident: the barrier cannot hang
    assert 1 <= p.ctas <= pn // 128 and 1 <= p.groups <= B


@pytest.mark.parametrize("B,pn,xp,ws", SHAPES, ids=_ids(SHAPES))
def test_layer_depths_fit_the_slot(B, pn, xp, ws):
    """Each layer's stage: 256 columns for a pass of 16 or 32 columns, 128
    for a wider one (a layer wider than 128 runs passes of 64), every stage
    inside the slot; a stage divides pn, so no
    step is ragged."""
    p = _plan(B, pn, xp, ws)
    bp = fused_model.baseline_plan((B, pn, pn), (B, pn, xp), ws)
    for kd, k in zip(p.kd, bp.kp):
        kn = k if k <= 128 else 64
        assert kd == (256 if kn <= 32 else 128) and pn % kd == 0
        assert fused_model._k5_stage(kd, kn) <= p.slot


@pytest.mark.parametrize("B,pn,xp,ws", SHAPES, ids=_ids(SHAPES))
def test_batches_in_flight_fill_the_card(B, pn, xp, ws):
    """The default gives each batch's row tiles a CTA each where the card
    holds them, and as many groups as the card holds at one CTA an SM."""
    p = _plan(B, pn, xp, ws)
    assert p.ctas == min(pn // 128, SMS)
    assert p.groups == max(1, min(B, SMS // p.ctas))


@pytest.mark.parametrize("sms", [114, 78, 20, 16])
@pytest.mark.parametrize("B,pn,xp,ws", SHAPES[:4], ids=_ids(SHAPES[:4]))
def test_plan_follows_the_card(B, pn, xp, ws, sms):
    """On a card of fewer SMs (an H100 PCIe has 114; a context may see
    fewer) the plan holds no more CTAs than it has: the launch is
    cooperative, and the C entry refuses a grid the card cannot hold."""
    p = _plan(B, pn, xp, ws, sms=sms)
    assert p.ctas == min(pn // 128, sms) and p.groups == max(1, min(B, sms // p.ctas))
    assert p.grid <= sms and p.smem == _plan(B, pn, xp, ws).smem
    with pytest.raises(ValueError, match=f"holds {sms}"):
        _plan(B, pn, xp, ws, sms=sms, g=p.groups + 1)


def test_c1_plan():
    """C1-baseline: 6 groups of 20 CTAs (one row tile each); the first
    layer 128 deep at its 128 columns (the largest stage), the narrow ones
    256."""
    p = _plan(75, 2560, 128, SAGE)
    assert (p.groups, p.ctas, p.kd, p.grid) == (6, 20, (128, 256, 256), 120)
    slot = 128 * 128 * 2 + 128 * 128
    assert p.slot == slot and p.smem == 3 * slot + 16 * (128 + 8) * 2 + 48 + 1024
    assert _plan(75, 2560, 128, SAGE, sms=114).groups == 5


def test_plan_is_cached_per_shape():
    before = fused_model._cached_k5_plan.cache_info().hits
    a, b = _plan(75, 2560, 128, SAGE), _plan(75, 2560, 128, SAGE)
    assert a is b and fused_model._cached_k5_plan.cache_info().hits >= before + 1
    assert _plan(74, 2560, 128, SAGE) == a  # the same launch: B only bounds the groups
    assert _plan(3, 2560, 128, SAGE).groups == 3
    assert _plan(75, 2560, 128, SAGE, sms=100) != a  # the card is part of the key


def test_wide_weights_are_not_refused():
    """W^T is staged 128 input columns at a time, so no width of X or of a
    layer's output up to 128 runs out of shared memory (the first kernel
    refused W^T above ~182 KB, e.g. 700 x 128); the widest layout is
    183,344 bytes."""
    for ws in ([(700, 128), (128, 40)], [(3703, 64), (64, 40)], [(1456, 64), (64, 64), (64, 40)]):
        p = _plan(2, 512, ws[0][0], ws)
        assert p.smem <= LIMIT and p.kd[0] == 128
    assert fused_model._k5_layout([128] * 8, [128] * 8)[2] == 183344 <= LIMIT


@pytest.mark.parametrize("forced", [dict(g=1), dict(g=2)])
def test_forced_plan_runs_plain_on_the_cpu(forced):
    a, x, ws = baseline_case(3, 2, 512, [128, 16, 16, 40])
    a, x, ws = torch.from_numpy(a), torch.from_numpy(x), [torch.from_numpy(w) for w in ws]
    kp = fused_baseline_plan(a.shape, x.shape, [tuple(w.shape) for w in ws], **forced)
    assert kp.groups == forced["g"]
    got = fused_model.fused_baseline_epoch(a, x, ws, _plan=kp)
    assert torch.equal(got, fused_model.fused_baseline_epoch_plain(a, x, ws))


@pytest.mark.parametrize("bad,msg", [(dict(g=0), "groups"), (dict(g=3), "groups"), (dict(g=-1), "groups")])
def test_impossible_plan_is_refused(bad, msg):
    """2 batches at pn 512."""
    with pytest.raises(ValueError, match=msg):
        _plan(2, 512, 128, SAGE, **bad)


def test_groups_past_the_card_are_refused():
    """C1 at 7 groups of 20 one-CTA-an-SM CTAs: 140 > 132 resident."""
    with pytest.raises(ValueError, match="holds 132"):
        _plan(75, 2560, 128, SAGE, g=7)
    assert _plan(75, 2560, 128, SAGE, g=6).grid == 120


def test_a_plan_of_another_shape_is_refused():
    a, x, ws = baseline_case(5, 2, 512, [128, 16, 40])
    a, x, ws = torch.from_numpy(a), torch.from_numpy(x), [torch.from_numpy(w) for w in ws]
    chosen = fused_baseline_plan(a.shape, x.shape, [tuple(w.shape) for w in ws])
    for wrong in (dataclasses.replace(chosen, ctas=chosen.ctas - 1), dataclasses.replace(chosen, smem=chosen.smem + 16),
                  dataclasses.replace(chosen, kd=(128, 128)),
                  fused_baseline_plan(a.shape, x.shape, [tuple(w.shape) for w in ws], sms=3)):
        with pytest.raises(ValueError, match="not the kernel's"):
            fused_model.fused_baseline_epoch(a, x, ws, _plan=wrong)
    assert isinstance(chosen, K5Plan)


def test_k5_groups_cover_every_plan_choice():
    """chip_smoke.py's and the CUDA tests' K5 cases: one to several
    groups, both stage depths, at pn 512 and 2560, sage and gin, 1, 3 and 8
    layers and an odd batch count."""
    groups = k5_groups()
    seen = {"groups": set(), "kd": set(), "pn": set(), "layers": set(), "model": set(), "B": set()}
    for _, kw in groups:
        for p in k5_plans(kw["B"], kw["pn"], kw["dims"]):
            seen["groups"].add(p.groups)
            seen["kd"].update(p.kd)
        seen["pn"].add(kw["pn"])
        seen["layers"].add(len(kw["dims"]) - 1)
        seen["model"].add(kw["model"])
        seen["B"].add(kw["B"])
    assert seen["kd"] == {128, 256} and {1, 2, 3} <= seen["groups"]
    assert {512, 2560} <= seen["pn"] and {1, 3, 8} <= seen["layers"]
    assert seen["model"] == {"sage", "gin"} and any(b % 2 for b in seen["B"])
