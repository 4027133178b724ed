"""The CUDA kernels against their plain PyTorch versions, on the card.

A CUDA kernel has no CPU mode, so every test here needs a CUDA device
and skips without one. On a GPU machine (which has no jax; the
environment variable keeps ``tests/conftest.py`` from importing it)::

    QGTC_TEST_BACKEND=cuda python -m pytest tests/test_torch_kernels.py -q

Tolerance: exact equality, padded outputs included (for ``bitmm``
the output planes word for word, for packed outputs the words); for the bf16
baseline kernel exact equality on the "integer" and "rounding" cases,
else max |kernel - plain| <= 2^-6 * max |plain| per row of logits
(``torch_cases``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from qgtc_ppopp22_tpu_torch.benchmarks import exp_bitcast_probe, exp_packmm, grid_overhead_study
from qgtc_ppopp22_tpu_torch.graph import ClusterBatcher, synthesize
from qgtc_ppopp22_tpu_torch.ops import bitgemm, digitmm, digits, fused_model, packmm
from qgtc_ppopp22_tpu_torch.ops.bitpack import pack_bits, unpack_bits
from qgtc_ppopp22_tpu_torch.runtime import (BaselineEngine, QGTCEngine, mega_block_occ, mega_block_sched,
                                            mega_chunk_occ)
from torch_cases import (  # tests/ is on sys.path
    BF16_REL_TOL,
    baseline_case,
    bf16_rel_err,
    blocky_levels,
    edge_operands,
    hand_map,
    k1_group,
    k1_groups,
    k2_chain,
    k2_group,
    k2_groups,
    k3_group,
    k3_groups,
    k4_group,
    k4_groups,
    k4_operands,
    k5_group,
    k5_groups,
    k6_group,
    k6_groups,
    levels_plane,
    mega_case,
    operands,
)

BITS = [1, 2, 4, 8]
SHAPES = [(2560, 128, 16), (2560, 2560, 40), (1000, 700, 200)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _dt(q, bits, dev):
    return digits.digit_pack(torch.from_numpy(q).to(dev), bits)


def _pt(q, bits, dev):
    return packmm.pack_rows(torch.from_numpy(q).to(dev), bits)


def _check(got, want):
    torch.cuda.synchronize()
    if isinstance(want, packmm.PackedTensor):
        assert got.shape == want.shape and got.bits == want.bits
        assert got.words.dtype == want.words.dtype and torch.equal(got.words, want.words)
    elif isinstance(want, digits.DigitTensor):
        assert got.shape == want.shape and torch.equal(got.digits, want.digits)
    else:
        assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("shift", [0, 2])
def test_packmm_kernel_equals_plain(cuda, bits, shape, shift):
    m, k, n = shape
    qa, qb = operands(bits + m + n, m, k, n, bits, bits, bits, shift)
    a, b = _pt(qa, bits, cuda), _dt(qb, bits, cuda)
    before = packmm.LAUNCHES
    got = packmm.packmm_to_digits(a, b, bits, shift=shift)
    assert packmm.LAUNCHES == before + 1
    _check(got, packmm.packmm_plain(a, b, bits, shift))
    _check(packmm.packmm_to_f32(a, b), packmm.packmm_plain(a, b))
    _check(packmm.packmm_to_i32(a, b), packmm.packmm_plain(a, b, raw_i32=True))


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("shift", [0, 2])
def test_digitmm_kernel_equals_plain(cuda, bits, shape, shift):
    m, k, n = shape
    qa, qb = operands(bits + m + n + 1, m, k, n, bits, bits, bits, shift)
    a, b = _dt(qa, bits, cuda), _dt(qb, bits, cuda)
    before = digitmm.LAUNCHES
    got = digitmm.digitmm_to_digits(a, b, bits, shift=shift)
    assert digitmm.LAUNCHES == before + 1
    _check(got, digitmm.digitmm_plain(a, b, bits, shift))
    _check(digitmm.digitmm_to_f32(a, b), digitmm.digitmm_plain(a, b))
    _check(digitmm.digitmm_to_i32(a, b), digitmm.digitmm_plain(a, b, raw_i32=True))


@pytest.mark.parametrize("b_bits", BITS)
def test_packmm_one_bit_adjacency(cuda, b_bits):
    qa, qb = operands(b_bits, 2560, 2560, 16, 1, b_bits, b_bits, 0)
    a, b = _pt(qa, 1, cuda), _dt(qb, b_bits, cuda)
    _check(packmm.packmm_to_digits(a, b, b_bits), packmm.packmm_plain(a, b, b_bits))


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("shift", [0, 2])
def test_requant_edges_on_card(cuda, bits, shift):
    qa, qb = edge_operands(bits, shift)
    b = _dt(qb, bits, cuda)
    pa, da = _pt(qa, bits, cuda), _dt(qa, bits, cuda)
    got = packmm.packmm_to_digits(pa, b, bits, shift=shift)
    _check(got, packmm.packmm_plain(pa, b, bits, shift))
    ub = 1 << bits
    col0 = digits.digit_unpack(got)[:, 0].cpu().numpy()
    assert col0[ub << shift] == 0 and col0[(ub + 1) << shift] == ub - 1
    _check(digitmm.digitmm_to_digits(da, b, bits, shift=shift), digitmm.digitmm_plain(da, b, bits, shift))


def test_mixed_devices_raise(cuda):
    qa, qb = operands(0, 256, 256, 16, 1, 2, 2, 0)
    with pytest.raises(ValueError, match="operands on"):
        packmm.packmm_to_f32(_pt(qa, 1, cuda), _dt(qb, 2, "cpu"))


@pytest.mark.parametrize("model", ["gcn", "gin"])
def test_engine_on_card_equals_cpu(cuda, model):
    ds = synthesize("Proteins", scale=0.05, seed=5)
    it = ClusterBatcher(ds, 8, 2, bit_width=2, seed=5, partition_method="bfs")
    gpu = QGTCEngine(feat_dim=it.feat_dim, num_classes=ds.num_classes, model=model, seed=4, device=cuda)
    cpu = QGTCEngine(feat_dim=it.feat_dim, num_classes=ds.num_classes, model=model, seed=4,
                     device="cpu")
    for b in it.batches:
        got = gpu.forward_batch(b)
        assert torch.equal(got, gpu.forward_batch(b, plain=True))
        np.testing.assert_array_equal(got.cpu().numpy(), cpu.forward_batch(b).numpy())


def test_device_times_ms(cuda):
    from qgtc_ppopp22_tpu_torch.utils.timing import device_times_ms

    qa, qb = operands(3, 2560, 2560, 16, 1, 2, 2, 0)
    a, b = _pt(qa, 1, cuda), _dt(qb, 2, cuda)
    t = device_times_ms({"kernel": lambda: packmm.packmm_to_f32(a, b),
                         "plain": lambda: packmm.packmm_plain(a, b)}, iters=5)
    assert set(t) == {"kernel", "plain"} and t["kernel"] > 0 and t["plain"] > 0
    # a count per function: the mean is per call whatever the count
    t2 = device_times_ms({"kernel": lambda: packmm.packmm_to_f32(a, b),
                          "plain": lambda: packmm.packmm_plain(a, b)}, iters={"kernel": 5, "plain": 1})
    assert 0.5 < t2["plain"] / t["plain"] < 2 and 0.5 < t2["kernel"] / t["kernel"] < 2


# -- packmm_signed (PreparedRHS) and packmm's packed-words output ---------


def _signed(qa, qb, dev):
    return _pt(qa, 8, dev), packmm.prepare_rhs(_dt(qb, 8, dev))


def _check_signed_forms(a, bp, n):
    """Every output form of the PreparedRHS kernel against plain."""
    plain = packmm.packmm_signed_plain
    _check(packmm.packmm_to_f32(a, bp), plain(a, bp))
    _check(packmm.packmm_to_f32(a, bp, out_cols=n), plain(a, bp, out_form="f32", out_cols=n))
    _check(packmm.packmm_to_i32(a, bp), plain(a, bp, raw_i32=True))
    for ob in (2, 4, 8):
        for sh in (0, 2):
            _check(packmm.packmm_to_digits(a, bp, ob, shift=sh), plain(a, bp, ob, "digits", sh))
    for oc in (None, n):
        _check(packmm.packmm_to_packed(a, bp, 8, out_cols=oc), plain(a, bp, 8, "packed", out_cols=oc))
    for ob in (1, 2, 4):
        _check(packmm.packmm_to_packed(a, bp, ob, out_cols=n), plain(a, bp, ob, "packed", out_cols=n))


@pytest.mark.parametrize("shape", [(700, 300, 60), (700, 300, 120), (1024, 1024, 16), (4096, 4096, 64)])
def test_packmm_signed_kernel_equals_plain(cuda, shape):
    m, k, n = shape
    a, bp = _signed(*operands(m + n, m, k, n, 8, 8, 8, 0), cuda)
    before = (packmm.LAUNCHES, packmm.SIGNED_LAUNCHES)
    packmm.packmm_to_packed(a, bp, 8, out_cols=n)
    assert (packmm.LAUNCHES, packmm.SIGNED_LAUNCHES) == (before[0], before[1] + 1)
    _check_signed_forms(a, bp, n)


@pytest.mark.parametrize("case", ["A at 0", "A and B at 255", "K 32640 at 255"])
def test_packmm_signed_extremes(cuda, case):
    """Level 0 and 255 everywhere, and the deepest K the int32 guard takes."""
    m, k, n = (256, 32640, 16) if case.startswith("K") else (700, 300, 60)
    qa = np.zeros((m, k), np.int32) if case == "A at 0" else np.full((m, k), 255, np.int32)
    _check_signed_forms(*_signed(qa, np.full((k, n), 255, np.int32), cuda), n)


@pytest.mark.parametrize("shape", [(2560, 2560, 16), (300, 520, 40), (512, 512, 512), (512, 512, 300)])
@pytest.mark.parametrize("b_bits", BITS)
@pytest.mark.parametrize("a_bits", BITS)
def test_packmm_packed_out_equals_plain(cuda, a_bits, b_bits, shape):
    m, k, n = shape
    qa, qb = operands(a_bits * 9 + b_bits + m + n, m, k, n, a_bits, b_bits, min(b_bits, 4), 0)
    a, b = _pt(qa, a_bits, cuda), _dt(qb, b_bits, cuda)
    for ob in BITS:
        for oc in (None, n):
            before = packmm.LAUNCHES
            got = packmm.packmm_to_packed(a, b, ob, out_cols=oc)
            assert packmm.LAUNCHES == before + 1
            _check(got, packmm.packmm_plain(a, b, ob, out_form="packed", out_cols=oc))
    _check(packmm.packmm_to_f32(a, b, out_cols=n), packmm.packmm_plain(a, b, out_form="f32", out_cols=n))


def test_packmm_signed_packed_output_chains(cuda):
    """An 8-bit packed output (the signed plane) as the next product's A."""
    rng = np.random.default_rng(4)
    qx, qw = rng.integers(0, 256, (200, 256)), rng.integers(0, 256, (256, 60))
    x, w, w2 = _pt(qx, 8, cuda), _dt(qw, 8, cuda), _dt(rng.integers(0, 256, (64, 40)), 8, cuda)
    xw = packmm.packmm_to_packed(x, w, 8)
    _check(xw, packmm.packmm_plain(x, w, 8, out_form="packed"))
    xw2 = packmm.PackedTensor(words=xw.words, shape=(200, 64), bits=8)
    _check(packmm.packmm_to_f32(xw2, w2), packmm.packmm_plain(xw2, w2))


def test_kernel_sweep_on_card(cuda, monkeypatch):
    """Fig. 8a's rows at M = K = 1024: each packed row launches one
    kernel (the 8-bit ones packmm_signed), equals plain and is timed."""
    from qgtc_ppopp22_tpu_torch.benchmarks import kernel_sweep

    monkeypatch.setattr(kernel_sweep, "MK", (1024,))
    cases = kernel_sweep.figure_cases("8a", np.random.default_rng(0), cuda)
    for c in cases:
        before = (packmm.LAUNCHES, packmm.SIGNED_LAUNCHES)
        out = c.run()
        after = (packmm.LAUNCHES - before[0], packmm.SIGNED_LAUNCHES - before[1])
        assert after == ((0, 1) if c.bits == 8 else (1, 0))
        _check(out, c.plain())
    rows = kernel_sweep.time_cases(cases, iters=3)
    assert [(r["bits"], r["N"]) for r in rows] == [(c.bits, c.N) for c in cases]
    assert all(r["us"] > 0 and r["tflops"] > 0 for r in rows)


# -- fused_model: the whole chain in one launch --------------------------

MEGA_KEEP = {512: [[[0, 1]], [[1]]], 1024: [[[0, 1, 2, 3], [2]], [[], [0, 2, 3]]]}


def _mega_args(cuda, model, bits, pn, shifts, seed=0):
    hidden = 16 if model == "gcn" else 64
    _, _, qws, aw, xd = mega_case(seed + bits + pn, 2, pn, bits, hidden, keep=MEGA_KEEP[pn],
                                  shift=1 if shifts else 0)
    ws = [digits.digit_pack(torch.from_numpy(w).to(cuda), bits) for w in qws]
    sched = np.stack([mega_block_sched(w[None], 512, 256) for w in aw])
    return (torch.from_numpy(aw).to(cuda), torch.from_numpy(xd).to(cuda), ws, bits,
            torch.from_numpy(sched).to(cuda))


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("shifts", [None, [1, 2, 1, 2, 1]])
@pytest.mark.parametrize("pn", [512, 1024])
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("model", ["gcn", "gin"])
def test_fused_model_kernel_equals_plain(cuda, model, bits, pn, shifts, compact):
    a, x, ws, bits, sched = _mega_args(cuda, model, bits, pn, shifts)
    kw = dict(model=model, shifts=shifts, out_cols=40 if shifts else None,
              blk_sched=sched if compact else None)
    before = fused_model.LAUNCHES
    got = fused_model.fused_model_epoch(a, x, ws, bits, **kw)
    assert fused_model.LAUNCHES == before + 1
    want = fused_model.fused_model_epoch_plain(a, x, ws, bits, **kw)
    _check(got, want)
    if compact:  # a real occupancy schedule changes nothing
        _check(got, fused_model.fused_model_epoch(a, x, ws, bits, **dict(kw, blk_sched=None)))


def test_fused_model_kernel_honours_a_partial_schedule(cuda):
    a, x, ws, bits, sched = _mega_args(cuda, "gcn", 2, 1024, None)
    part = sched.clone()
    part[0, 0, 0] = 3  # chunk 0 of batch 0: blocks 0, 1, 2 of its 4
    got = fused_model.fused_model_epoch(a, x, ws, bits, blk_sched=part)
    _check(got, fused_model.fused_model_epoch_plain(a, x, ws, bits, blk_sched=part))
    assert not torch.equal(got, fused_model.fused_model_epoch(a, x, ws, bits, blk_sched=sched))


def test_fused_model_kernel_is_repeatable(cuda):
    """A race between the CTAs of one batch would show as a run that
    differs from the others."""
    a, x, ws, bits, sched = _mega_args(cuda, "gin", 2, 1024, None, seed=9)
    first = fused_model.fused_model_epoch(a, x, ws, bits, model="gin", blk_sched=sched)
    for _ in range(5):
        _check(fused_model.fused_model_epoch(a, x, ws, bits, model="gin", blk_sched=sched), first)


@pytest.mark.parametrize("model", ["gcn", "gin"])
def test_run_epochs_mega_on_card_equals_cpu(cuda, model):
    ds = synthesize("Proteins", scale=0.05, seed=5)
    it = ClusterBatcher(ds, 8, 2, bit_width=2, seed=5, partition_method="bfs")
    gpu = QGTCEngine(feat_dim=it.feat_dim, num_classes=ds.num_classes, model=model, seed=4,
                     device=cuda, zerotile_jump=True)
    cpu = QGTCEngine(feat_dim=it.feat_dim, num_classes=ds.num_classes, model=model, seed=4,
                     device="cpu", zerotile_jump=True)
    before = fused_model.LAUNCHES
    got = gpu._mega_logits(it)
    assert fused_model.LAUNCHES - before == len(gpu.mega_buckets)
    assert all(i["compact"] and not i["fallback"] for i in gpu.mega_buckets)
    for b, g, c in zip(it.batches, got, cpu.forward_all(it)):
        n, k = b.num_nodes, ds.num_classes
        np.testing.assert_array_equal(g[:n, :k].cpu().numpy(), c[:n, :k].numpy())
    # evaluation with zerotile_jump=True: the step engine with its maps
    assert gpu.evaluate(it, ds.labels) == cpu.evaluate(it, ds.labels)


# K1 redesigned (csrc/fused_model_k1.cuh): every form of X, every zero-block
# form, under every forced plan, the whole output against plain, twice (no
# race checker runs on the card: equal repeats are the evidence)
@pytest.mark.parametrize("group", [kw for _, kw in k1_groups()], ids=[gid for gid, _ in k1_groups()])
def test_k1_kernel_equals_plain(cuda, group):
    for tag, kernel, plain in k1_group(cuda, **group):
        before = fused_model.LAUNCHES
        got = kernel()
        assert fused_model.LAUNCHES == before + 1, tag
        _check(got, plain())
        _check(kernel(), got)


def test_k1_refuses_a_plan_it_cannot_run(cuda, monkeypatch):
    """The C entry checks the plan against its own sums: past the Python
    check (patched out here), a plan of another shared-memory size, rows,
    cluster, ring depth or stage depth is refused at the launch."""
    a, x, ws, bits, _ = _mega_args(cuda, "gcn", 2, 1024, None)
    p = fused_model.plan(a.shape, x.shape, ws, bits, "gcn", None, None)
    kp = fused_model.fused_model_plan(p, "gcn")
    monkeypatch.setattr(fused_model, "_check_forced", lambda plan, p, model: plan)
    for bad in (dict(smem=kp.smem + 16), dict(rows=96), dict(cl=9), dict(rows=128, cl=9), dict(stages=2),
                dict(stages=5), dict(depth=32), dict(smem=300 * 1024)):
        with pytest.raises(RuntimeError, match="qgtc_fused_model"):
            fused_model.fused_model_epoch(a, x, ws, bits, _plan=dataclasses.replace(kp, **bad))
    assert torch.equal(fused_model.fused_model_epoch(a, x, ws, bits, _plan=kp),
                       fused_model.fused_model_epoch_plain(a, x, ws, bits))


# -- fused_model: levels-form X (the signed chain, the in-kernel split) ----


def _levels_args(cuda, model, bits, pn, hidden, shifts, B=2, feat=128, seed=0, keep=None):
    qa, qx, qws, aw, xd = mega_case(seed + bits + pn + hidden, B, pn, bits, hidden, keep=keep,
                                    feat=feat, shift=1 if shifts else 0)
    ws = [digits.digit_pack(torch.from_numpy(w).to(cuda), bits) for w in qws]
    sched = np.stack([mega_block_sched(w[None], 512 if pn % 512 == 0 else 256, 256) for w in aw])
    return (torch.from_numpy(aw).to(cuda), torch.from_numpy(levels_plane(xd)).to(cuda),
            torch.from_numpy(xd).to(cuda), ws, torch.from_numpy(sched).to(cuda))


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("shifts", [None, [1, 2, 1, 2, 1]])
@pytest.mark.parametrize("hidden", [16, 128])  # the signed form, the split form
@pytest.mark.parametrize("bits", [5, 8])
@pytest.mark.parametrize("model", ["gcn", "gin"])
def test_fused_model_levels_kernel_equals_plain(cuda, model, bits, hidden, shifts, compact):
    a, xl, xd, ws, sched = _levels_args(cuda, model, bits, 1024, hidden, shifts, keep=MEGA_KEEP[1024])
    kw = dict(model=model, shifts=shifts, out_cols=40 if shifts else None,
              blk_sched=sched if compact else None)
    form = fused_model.plan(a.shape, xl.shape, ws, bits, model, shifts, None,
                            x_levels_bits=bits).form
    assert form == ("signed" if hidden == 16 else "split")
    before = fused_model.LEVELS_LAUNCHES
    got = fused_model.fused_model_epoch(a, xl, ws, bits, x_levels_bits=bits, **kw)
    assert fused_model.LEVELS_LAUNCHES == before + 1
    _check(got, fused_model.fused_model_epoch_plain(a, xl, ws, bits, x_levels_bits=bits, **kw))
    # the same logits as the 2-digit route, padded columns included
    _check(got, fused_model.fused_model_epoch(a, xd, ws, bits, **kw))


@pytest.mark.parametrize("case", ["feat 100", "clamp_bits 4", "B 3 pn 768", "1 layer gin"])
def test_fused_model_levels_kernel_cases(cuda, case):
    bits, out_bits, model, pn, B, feat, hidden = 8, 8, "gcn", 512, 2, 128, 48
    if case == "feat 100":
        model, feat, hidden = "gin", 100, 64
    elif case == "clamp_bits 4":
        out_bits = 4
    elif case == "B 3 pn 768":
        pn, B = 768, 3
    a, xl, xd, ws, sched = _levels_args(cuda, model, bits, pn, hidden, [1, 2, 1, 2, 1], B=B,
                                        feat=feat)
    kw = dict(model=model, shifts=[1, 2, 1, 2, 1], out_cols=40, x_levels_bits=bits)
    if case == "1 layer gin":
        ws, kw = ws[:1], dict(kw, model="gin", shifts=None)
    for blk in (None, sched):
        got = fused_model.fused_model_epoch(a, xl, ws, out_bits, blk_sched=blk, **kw)
        _check(got, fused_model.fused_model_epoch_plain(a, xl, ws, out_bits, blk_sched=blk, **kw))
        assert len(torch.unique(got)) > 4


def test_fused_model_levels_kernel_is_repeatable(cuda):
    """A race between the CTAs of one batch would show as a run that
    differs from the others."""
    a, xl, _, ws, sched = _levels_args(cuda, "gin", 8, 1024, 64, None, seed=9, keep=MEGA_KEEP[1024])
    first = fused_model.fused_model_epoch(a, xl, ws, 8, model="gin", blk_sched=sched, x_levels_bits=8)
    for _ in range(5):
        _check(fused_model.fused_model_epoch(a, xl, ws, 8, model="gin", blk_sched=sched,
                                             x_levels_bits=8), first)


@pytest.mark.parametrize("model", ["gcn", "gin"])
def test_run_epochs_mega_levels_on_card_equals_cpu(cuda, model):
    ds = synthesize("Proteins", scale=0.05, seed=5)
    it = ClusterBatcher(ds, 8, 2, bit_width=8, seed=5, partition_method="bfs")
    kw = dict(feat_dim=it.feat_dim, num_classes=ds.num_classes, model=model, seed=4, bit_width=8,
              shifts=(4, 2, 11, 2, 11) if model == "gcn" else (0, 6, 3, 13, 2))
    gpu, cpu = QGTCEngine(device=cuda, **kw), QGTCEngine(device="cpu", **kw)
    before = fused_model.LEVELS_LAUNCHES
    got = gpu._mega_logits(it)
    assert fused_model.LEVELS_LAUNCHES - before == len(gpu.mega_buckets)
    assert all(i["form"] == "signed" and not i["fallback"] for i in gpu.mega_buckets)
    for b, g, c in zip(it.batches, got, cpu.forward_all(it)):
        n, k = b.num_nodes, ds.num_classes
        np.testing.assert_array_equal(g[:n, :k].cpu().numpy(), c[:n, :k].numpy())


# -- fused_baseline: the bf16 baseline chain in one launch ----------------

BASELINE_DIMS = {"sage": [128, 16, 16, 40], "gin": [128, 64, 64, 40]}


def _baseline_args(cuda, model, pn, layers, kind, B=2):
    dims = BASELINE_DIMS[model] if layers == 3 else [128, 40]
    a, x, ws = baseline_case(pn + layers, B, pn, dims, kind=kind)
    return (torch.from_numpy(a).to(cuda), torch.from_numpy(x).to(cuda),
            [torch.from_numpy(w).to(cuda) for w in ws])


def _check_close(got, want):
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype == torch.float32
    for g, w in zip(got.cpu().numpy(), want.cpu().numpy()):
        assert bf16_rel_err(g, w) <= BF16_REL_TOL


@pytest.mark.parametrize("kind", ["integer", "rounding", "random"])
@pytest.mark.parametrize("layers", [1, 3])
@pytest.mark.parametrize("pn", [512, 1024])
@pytest.mark.parametrize("model", ["sage", "gin"])
def test_fused_baseline_kernel_vs_plain(cuda, model, pn, layers, kind):
    a, x, ws = _baseline_args(cuda, model, pn, layers, kind)
    before = fused_model.BASELINE_LAUNCHES
    got = fused_model.fused_baseline_epoch(a, x, ws)
    assert fused_model.BASELINE_LAUNCHES == before + 1
    want = fused_model.fused_baseline_epoch_plain(a, x, ws)
    if kind != "random":
        _check(got, want)
    else:
        _check_close(got, want)


def test_fused_baseline_kernel_ragged_widths_and_repeatable(cuda):
    """Widths that are not multiples of 16, X wider than 128 columns
    (two aggregation passes), three batches; a race between the CTAs of
    one batch would show as a run that differs from the others."""
    a, x, ws = baseline_case(11, 3, 256, [200, 24, 10])
    a, x = torch.from_numpy(a).to(cuda), torch.from_numpy(x).to(cuda)
    ws = [torch.from_numpy(w).to(cuda) for w in ws]
    first = fused_model.fused_baseline_epoch(a, x, ws)
    _check_close(first, fused_model.fused_baseline_epoch_plain(a, x, ws))
    packed = fused_model.pack_baseline_weights(ws)
    for _ in range(5):
        _check(fused_model.fused_baseline_epoch(a, x, ws, packed=packed), first)
    with pytest.raises(ValueError, match="packed weights"):
        fused_model.fused_baseline_epoch(a, x, ws, packed=fused_model.pack_baseline_weights(ws[1:]))
    _check(fused_model.fused_baseline_epoch(a, x.to(torch.bfloat16), ws),
           fused_model.fused_baseline_epoch(a, x.to(torch.bfloat16).float(), ws))


# K5 redesigned (csrc/fused_baseline_k5.cuh): every group of
# torch_cases.k5_groups under every forced plan, bit for bit on the
# "integer" and "rounding" cases, within BF16_REL_TOL per row on "random",
# each output twice (no race checker runs on the card: equal repeats are
# the evidence)
@pytest.mark.parametrize("group", [kw for _, kw in k5_groups()], ids=[gid for gid, _ in k5_groups()])
def test_k5_kernel_equals_plain(cuda, group):
    for tag, kind, kernel, plain in k5_group(cuda, **group):
        before = fused_model.BASELINE_LAUNCHES
        got = kernel()
        assert fused_model.BASELINE_LAUNCHES == before + 1, tag
        if kind == "random":
            _check_close(got, plain())
        else:
            _check(got, plain())
        _check(kernel(), got)


def test_k5_refuses_a_plan_it_cannot_run(cuda, monkeypatch):
    """The C entry checks the plan against its own sums: past the Python
    check (patched out here), a plan of another shared-memory size, more
    CTAs per group than row tiles, no CTAs, more groups than batches, or
    more CTAs than the card holds at once is refused at the launch."""
    a, x, ws = _baseline_args(cuda, "sage", 512, 3, "random")
    shapes = [tuple(w.shape) for w in ws]
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    kp = fused_model.fused_baseline_plan(a.shape, x.shape, shapes, sms=sms)
    monkeypatch.setattr(fused_model, "_check_forced_k5", lambda *args: None)
    for bad in (dict(smem=kp.smem + 16), dict(ctas=kp.ctas + 1), dict(ctas=0), dict(groups=3),
                dict(smem=300 * 1024)):
        with pytest.raises(RuntimeError, match="qgtc_fused_baseline"):
            fused_model.fused_baseline_epoch(a, x, ws, _plan=dataclasses.replace(kp, **bad))
    big = fused_model.fused_baseline_plan((75, 2560, 2560), (75, 2560, 128), shapes, sms=sms)
    over = sms // big.ctas + 1  # one group past the card's one CTA an SM
    a2, x2, _ = baseline_case(3, 75, 2560, [128, 16, 16, 40], kind="integer")
    with pytest.raises(RuntimeError, match="qgtc_fused_baseline"):
        fused_model.fused_baseline_epoch(torch.from_numpy(a2).to(cuda), torch.from_numpy(x2).to(cuda), ws,
                                         _plan=dataclasses.replace(big, groups=over, grid=over * big.ctas))
    _check_close(fused_model.fused_baseline_epoch(a, x, ws, _plan=kp), fused_model.fused_baseline_epoch_plain(a, x, ws))


@pytest.mark.parametrize("model", ["sage", "gin"])
def test_baseline_mega_on_card_matches_cpu(cuda, model):
    ds = synthesize("Proteins", scale=0.05, seed=5)
    it = ClusterBatcher(ds, 8, 2, bit_width=2, seed=5, partition_method="bfs")
    gpu = BaselineEngine(feat_dim=it.feat_dim, num_classes=ds.num_classes, model=model, seed=4,
                         device=cuda)
    cpu = BaselineEngine(feat_dim=it.feat_dim, num_classes=ds.num_classes, model=model, seed=4,
                         device="cpu")
    before = fused_model.BASELINE_LAUNCHES
    got = gpu._mega_logits(it, ds)
    assert fused_model.BASELINE_LAUNCHES - before == len(gpu.mega_buckets)
    for b, g in zip(it.batches, got):
        assert bf16_rel_err(g.cpu().numpy(), cpu.forward_batch(b, ds).numpy()) <= BF16_REL_TOL


# -- bitmm: BitTensor planes on the one-bit tensor cores -------------------

BIT_PAIRS = [(1, 1), (1, 2), (2, 2), (3, 5), (4, 4), (8, 8), (1, 8)]
# C1's aggregation and first update, and a ragged shape
BIT_SHAPES = [(2560, 2560, 16), (2560, 128, 16), (300, 520, 40)]


def _bt(q, bits, dev):
    return pack_bits(torch.from_numpy(q).to(dev), bits)


def _check_bits(got, want):
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.bits == want.bits
    assert torch.equal(got.planes, want.planes)


@pytest.mark.parametrize("pair", BIT_PAIRS)
@pytest.mark.parametrize("shape", BIT_SHAPES)
def test_bitmm_kernel_equals_plain(cuda, pair, shape):
    a_bits, b_bits = pair
    m, k, n = shape
    qa, qb = operands(a_bits * 9 + b_bits + m + n, m, k, n, a_bits, b_bits, min(b_bits, 4), 0)
    a, b = _bt(qa, a_bits, cuda), _bt(qb, b_bits, cuda)
    for out_bits in (1, 2, 4, 8):
        before = bitgemm.LAUNCHES
        got = bitgemm.bitmm_to_bits(a, b, out_bits)
        assert bitgemm.LAUNCHES == before + 1
        _check_bits(got, bitgemm.bitmm_plain(a, b, out_bits))
    _check(bitgemm.bitmm_to_int(a, b), bitgemm.bitmm_plain(a, b, None))


@pytest.mark.parametrize("bits", BITS)
def test_bitmm_requant_edges_on_card(cuda, bits):
    qa, qb = edge_operands(bits, 0)
    a, b = _bt(qa, 1, cuda), _bt(qb, bits, cuda)
    got = bitgemm.bitmm_to_bits(a, b, bits)
    _check_bits(got, bitgemm.bitmm_plain(a, b, bits))
    ub = 1 << bits
    col0 = unpack_bits(got)[:, 0].cpu().numpy()
    assert col0[ub - 1] == ub - 1 and col0[ub] == 0 and col0[ub + 1] == ub - 1


def test_bitmm_tile_maps_on_card(cuda):
    """Block-diagonal A with empty tiles and an empty row tile: the map
    changes nothing. A map that omits an occupied tile: the kernel
    computes the listed tiles only, as plain does."""
    rng = np.random.default_rng(5)
    qa = np.zeros((2560, 2560), np.int32)
    for s0 in range(0, 2560, 512):
        if s0 != 1024:  # row tile 2 stays empty: kcnt 0
            qa[s0:s0 + 512, s0:s0 + 512] = rng.random((512, 512)) < 0.02
    qb = rng.integers(0, 4, (2560, 16)).astype(np.int32)
    a, b = _bt(qa, 1, cuda), _bt(qb, 2, cuda)
    tm = bitgemm.build_tile_map(a)
    assert tm.kcnt.tolist() == [1, 1, 0, 1, 1]
    dense = bitgemm.bitmm_to_bits(a, b, 2)
    _check_bits(bitgemm.bitmm_to_bits(a, b, 2, tile_map=tm), dense)
    _check(bitgemm.bitmm_to_int(a, b, tile_map=tm), bitgemm.bitmm_to_int(a, b))
    full = bitgemm.build_tile_map(_bt(np.ones((2560, 2560), np.int32), 1, cuda))
    kcnt = full.kcnt.clone()
    kcnt[0] = 2  # row tile 0 visits K tiles 0 and 1 of 5
    hand = bitgemm.TileMap(full.kidx, kcnt, full.tile_m, full.tile_k)
    qd = (rng.random((2560, 2560)) < 0.02).astype(np.int32)
    d = _bt(qd, 1, cuda)
    got = bitgemm.bitmm_to_int(d, b, tile_map=hand)
    _check(got, bitgemm.bitmm_plain(d, b, None, hand))
    assert not torch.equal(got, bitgemm.bitmm_to_int(d, b))
    _check_bits(bitgemm.bitmm_to_bits(d, b, 2, tile_map=hand), bitgemm.bitmm_plain(d, b, 2, hand))


@pytest.mark.parametrize("kind", ["real", "hand"])
@pytest.mark.parametrize("shape,tiles", [
    ((2560, 2560, 16), (256, 256)), ((2560, 2560, 16), (512, 128)),  # C1's aggregation
    ((1792, 1280, 200), (256, 256)), ((1792, 1280, 200), (256, 128)),  # 7 row tiles, ragged N
])
@pytest.mark.parametrize("a_bits", BITS)
def test_packmm_tile_map_kernel_equals_plain(cuda, a_bits, shape, tiles, kind):
    m, k, n = shape
    a = _pt(blocky_levels(a_bits + m, m, k, a_bits), a_bits, cuda)
    b = _dt(operands(n, m, k, n, 1, 2, 2, 0)[1], 2, cuda)
    tm = packmm.build_tile_map_packed(a, *tiles)
    if kind == "hand":
        tm = hand_map(tm)
    before = (packmm.LAUNCHES, packmm.MAPPED_LAUNCHES)
    got = packmm.packmm_to_digits(a, b, 2, tm, shift=1)
    assert (packmm.LAUNCHES, packmm.MAPPED_LAUNCHES) == (before[0] + 1, before[1] + 1)
    _check(got, packmm.packmm_plain(a, b, 2, 1, tile_map=tm))
    _check(packmm.packmm_to_f32(a, b, tm, out_cols=n), packmm.packmm_plain(a, b, out_form="f32", out_cols=n,
                                                                          tile_map=tm))
    _check(packmm.packmm_to_i32(a, b, tm), packmm.packmm_plain(a, b, raw_i32=True, tile_map=tm))
    for ob in BITS:
        _check(packmm.packmm_to_packed(a, b, ob, tm, out_cols=n),
               packmm.packmm_plain(a, b, ob, out_form="packed", out_cols=n, tile_map=tm))
    assert torch.equal(packmm.packmm_to_i32(a, b, tm), packmm.packmm_to_i32(a, b)) == (kind == "real")


@pytest.mark.parametrize("kind", ["real", "hand"])
@pytest.mark.parametrize("tiles", [(256, 256), (128, 128)])
@pytest.mark.parametrize("b_bits", [2, 8])
@pytest.mark.parametrize("a_bits", [2, 8])
def test_digitmm_tile_map_kernel_equals_plain(cuda, a_bits, b_bits, tiles, kind):
    da = _dt(blocky_levels(a_bits * 3 + b_bits, 1280, 1536, a_bits), a_bits, cuda)
    b = _dt(operands(b_bits, 1280, 1536, 40, 1, b_bits, b_bits, 0)[1], b_bits, cuda)
    tm = digitmm.build_tile_map_digits(da, *tiles)
    if kind == "hand":
        tm = hand_map(tm)
    before = (digitmm.LAUNCHES, digitmm.MAPPED_LAUNCHES)
    got = digitmm.digitmm_to_digits(da, b, b_bits, tm, shift=2)
    assert (digitmm.LAUNCHES, digitmm.MAPPED_LAUNCHES) == (before[0] + 1, before[1] + 1)
    _check(got, digitmm.digitmm_plain(da, b, b_bits, 2, tile_map=tm))
    _check(digitmm.digitmm_to_f32(da, b, tm), digitmm.digitmm_plain(da, b, tile_map=tm))
    _check(digitmm.digitmm_to_i32(da, b, tm), digitmm.digitmm_plain(da, b, raw_i32=True, tile_map=tm))


# K2's 1/2/4-bit kernel (csrc/packmm_k2.cuh): every form of each group,
# the whole output against plain, twice (no race checker runs on the card:
# equal repeats are the evidence)
@pytest.mark.parametrize("group", [kw for _, kw in k2_groups()], ids=[gid for gid, _ in k2_groups()])
def test_k2_kernel_equals_plain(cuda, group):
    for tag, kernel, plain in k2_group(cuda, **group):
        before = packmm.LAUNCHES
        got = kernel()
        assert packmm.LAUNCHES == before + 1, tag
        _check(got, plain())
        _check(kernel(), got)


@pytest.mark.parametrize("a_bits", [1, 2, 4])
def test_k2_packed_words_chain(cuda, a_bits):
    _, kernel, plain = k2_chain(cuda, a_bits)
    got = kernel()
    _check(got, plain())
    _check(kernel(), got)


def test_k2_refuses_a_plan_it_cannot_run(cuda):
    a, b = _pt(operands(1, 512, 256, 16, 1, 2, 2, 0)[0], 1, cuda), _dt(operands(1, 512, 256, 16, 1, 2, 2, 0)[1], 2, cuda)
    plan = packmm.packmm_plan(a.padded_rows, a.padded_cols, b.padded_cols, 16, "words", b.padded_cols)
    wrong_tiles = dict(grid=(plan.grid[0] + 1, *plan.grid[1:]))  # the C entry checks the geometry
    wrong_cluster = dict(cluster=(1, 1, plan.splits))  # words take a 256-row group a cluster
    for bad in (dict(splits=3, cluster=(1, 4, 3)), dict(bnt=48), wrong_tiles, wrong_cluster):
        with pytest.raises(RuntimeError, match="qgtc_packmm"):
            packmm._packmm(a, b, 1, "packed", 0, False, _plan=dataclasses.replace(plan, **bad))


# K4's kernel (csrc/packmm_k4.cuh): the PreparedRHS product and K2's 8-bit
# plane, every form of each group under every forced column tile and
# split, the whole output against plain, twice
@pytest.mark.parametrize("group", [kw for _, kw in k4_groups()], ids=[gid for gid, _ in k4_groups()])
def test_k4_kernel_equals_plain(cuda, group):
    prepared = group.get("prepared", True)
    for tag, kernel, plain in k4_group(cuda, **group):
        before = (packmm.LAUNCHES, packmm.SIGNED_LAUNCHES)
        got = kernel()
        assert (packmm.LAUNCHES - before[0], packmm.SIGNED_LAUNCHES - before[1]) == \
            ((0, 1) if prepared else (1, 0)), tag
        _check(got, plain())
        _check(kernel(), got)


@pytest.mark.parametrize("prepared", [True, False])
def test_k4_refuses_a_plan_it_cannot_run(cuda, prepared):
    a, b = k4_operands(1, 512, 256, 16, 8, 8, cuda, prepared=prepared)
    np_ = b.plane.shape[1] if prepared else b.padded_cols
    plan = packmm.packmm_signed_plan(a.padded_rows, a.padded_cols, np_, np_ if prepared else 16, "words", 16)
    wrong_tiles = dict(grid=(plan.grid[0] + 1, *plan.grid[1:]))  # the C entry checks the geometry
    wrong_cluster = dict(cluster=(1, 1, plan.splits))  # words take a 256-row group a cluster
    entry = "qgtc_packmm_signed" if prepared else "qgtc_packmm"
    for bad in (dict(splits=3, cluster=(1, 4, 3), grid=(*plan.grid[:2], 3)), dict(bnt=48), wrong_tiles,
                wrong_cluster):
        with pytest.raises(RuntimeError, match=entry):
            packmm._packmm(a, b, 1, "packed", 0, False, 16, _plan=dataclasses.replace(plan, **bad))


def test_tile_map_kernel_refuses_a_map_on_another_device(cuda):
    a = _pt(blocky_levels(1, 512, 512, 1), 1, cuda)
    b = _dt(operands(1, 512, 512, 16, 1, 2, 2, 0)[1], 2, cuda)
    tm = packmm.build_tile_map_packed(a, 256, 256)
    cpu_map = bitgemm.TileMap(tm.kidx.cpu(), tm.kcnt.cpu(), 256, 256)
    with pytest.raises(ValueError, match="tile_map on cpu"):
        packmm.packmm_to_f32(a, b, cpu_map)


@pytest.mark.parametrize("model", ["gcn", "gin"])
def test_engine_zerotile_jump_on_card_equals_cpu(cuda, model):
    ds = synthesize("Proteins", scale=0.05, seed=5)
    it = ClusterBatcher(ds, 8, 2, bit_width=2, seed=5, partition_method="bfs")
    kw = dict(feat_dim=it.feat_dim, num_classes=ds.num_classes, model=model, seed=4)
    gpu = QGTCEngine(device=cuda, zerotile_jump=True, **kw)
    cpu = QGTCEngine(device="cpu", zerotile_jump=True, **kw)
    dense = QGTCEngine(device=cuda, **kw)
    for b in it.batches:
        before = packmm.MAPPED_LAUNCHES
        got = gpu.forward_batch(b)
        assert packmm.MAPPED_LAUNCHES - before == 3
        assert torch.equal(got, gpu.forward_batch(b, plain=True)) and torch.equal(got, dense.forward_batch(b))
        np.testing.assert_array_equal(got.cpu().numpy(), cpu.forward_batch(b).numpy())


@pytest.mark.parametrize("form", ["1d", "2d", "1d-hand", "2d-hand"])
def test_fused_model_chunk_occ_on_card(cuda, form):
    a, x, ws, bits, _ = _mega_args(cuda, "gcn", 2, 1024, None)
    aw = a.cpu().numpy()
    if form.startswith("1d"):
        occ = np.stack([mega_chunk_occ(w[None], 512) for w in aw])
    else:
        occ = np.stack([mega_block_occ(w[None], 512, 256) for w in aw])
    if form.endswith("hand"):
        occ[0].flat[int(np.flatnonzero(occ[0])[0])] = 0
    occ = torch.from_numpy(occ).to(cuda)
    before = fused_model.LAUNCHES
    got = fused_model.fused_model_epoch(a, x, ws, bits, chunk_occ=occ)
    assert fused_model.LAUNCHES == before + 1
    _check(got, fused_model.fused_model_epoch_plain(a, x, ws, bits, chunk_occ=occ))
    dense = fused_model.fused_model_epoch(a, x, ws, bits, resident_a=False)
    assert torch.equal(got, dense) == (not form.endswith("hand"))


def test_bitmm_kernel_is_repeatable_and_checks_devices(cuda):
    qa, qb = operands(11, 2560, 2560, 16, 1, 2, 2, 0)
    a, b = _bt(qa, 1, cuda), _bt(qb, 2, cuda)
    first = bitgemm.bitmm_to_bits(a, b, 2)
    for _ in range(5):
        _check_bits(bitgemm.bitmm_to_bits(a, b, 2), first)
    with pytest.raises(ValueError, match="operands on"):
        bitgemm.bitmm_to_int(a, _bt(qb, 2, "cpu"))


# K6's kernel (csrc/bitmm_k6.cuh): every column tile and split of each
# group, to bits and to f32, the whole output against plain, twice (no race
# checker runs on the card: equal repeats are the evidence)
@pytest.mark.parametrize("group", [kw for _, kw in k6_groups()], ids=[gid for gid, _ in k6_groups()])
def test_k6_kernel_equals_plain(cuda, group):
    for tag, kernel, plain in k6_group(cuda, **group):
        before = bitgemm.LAUNCHES
        got = kernel()
        assert bitgemm.LAUNCHES == before + 1, tag
        want = plain()
        if isinstance(want, torch.Tensor):
            _check(got, want)
            _check(kernel(), got)
        else:
            _check_bits(got, want)
            _check_bits(kernel(), got)


def test_k6_refuses_a_plan_it_cannot_run(cuda):
    qa, qb = operands(1, 512, 512, 16, 1, 2, 2, 0)
    a, b = _bt(qa, 1, cuda), _bt(qb, 2, cuda)
    plan = bitgemm.bitmm_plan(a.padded_rows, a.padded_cols, b.padded_cols, 16, "bits")
    bad_plans = (dict(bnt=48), dict(grid=(plan.grid[0] + 1, *plan.grid[1:])),  # the C entry checks the geometry
                 dict(splits=5, cluster=(1, 1, 5), grid=(*plan.grid[:2], 5)),
                 dict(cluster=(1, 2, plan.splits)), dict(grid=(plan.grid[0], plan.grid[1] - 1, plan.grid[2])))
    for bad in bad_plans:
        with pytest.raises(RuntimeError, match="qgtc_bitmm"):
            bitgemm._bitmm(a, b, 2, None, _plan=dataclasses.replace(plan, **bad))


# K3 redesigned (csrc/digitmm_k3.cuh): every group of torch_cases.k3_groups
# (C1's updates, N 16-200, K 16-700, 1 and 2 digit planes, maps) in every
# out form under every forced plan, bit for bit over the whole padded
# output, twice
@pytest.mark.parametrize("group", [kw for _, kw in k3_groups()], ids=[gid for gid, _ in k3_groups()])
def test_k3_kernel_equals_plain(cuda, group):
    for tag, kernel, plain in k3_group(cuda, **group):
        before = digitmm.LAUNCHES
        got = kernel()
        assert digitmm.LAUNCHES == before + 1, tag
        _check(got, plain())
        _check(kernel(), got)


def test_k3_refuses_a_plan_it_cannot_run(cuda, monkeypatch):
    qa, qb = operands(2, 2560, 128, 16, 8, 8, 8, 1)
    a, b = _dt(qa, 8, cuda), _dt(qb, 8, cuda)
    plan = digitmm.digitmm_plan(a.ndigits, b.ndigits, 2560, 128, 128, 128, 16)
    monkeypatch.setattr(digitmm, "_check_forced", lambda *args: None)
    for bad in (dict(bnt=48), dict(bnt=64), dict(grid=(2, 160)), dict(grid=(1, 80)), dict(rows=8), dict(kr=160),
                dict(nr=12), dict(ks=48), dict(smem=plan.smem + 128)):
        with pytest.raises(RuntimeError, match="qgtc_digitmm"):
            digitmm._digitmm(a, b, 8, 1, False, None, _plan=dataclasses.replace(plan, **bad))
    _check(digitmm._digitmm(a, b, 8, 1, False, None, _plan=plan), digitmm.digitmm_plain(a, b, 8, 1))


@pytest.mark.parametrize("model", ["gcn", "gin"])
def test_bits_engine_on_card_equals_cpu_and_digits(cuda, model):
    ds = synthesize("Proteins", scale=0.05, seed=5)
    it = ClusterBatcher(ds, 8, 2, bit_width=2, seed=5, partition_method="bfs")
    kw = dict(feat_dim=it.feat_dim, num_classes=ds.num_classes, model=model, seed=4)
    gpu = QGTCEngine(fmt="bits", device=cuda, **kw)
    cpu = QGTCEngine(fmt="bits", device="cpu", **kw)
    dig = QGTCEngine(device=cuda, **kw)
    for b in it.batches:
        before = bitgemm.LAUNCHES
        got = gpu.forward_batch(b)
        assert bitgemm.LAUNCHES - before == 6
        assert torch.equal(got, gpu.forward_batch(b, plain=True))
        np.testing.assert_array_equal(got.cpu().numpy(), cpu.forward_batch(b).numpy())
        assert torch.equal(got, dig.forward_batch(b))


@pytest.mark.parametrize("zerotile_jump", [None, True])
@pytest.mark.parametrize("model", ["gcn", "gin"])
def test_captured_fused_epoch_on_card(cuda, model, zerotile_jump):
    """The fused epoch captured as one CUDA graph: the counters move at the
    warm-up and the capture (3 packmm and 3 digitmm launches a batch each)
    and not at a replay; a replay gives the step engine's logits bit for
    bit, writes every batch again over a sentinel, and quant-in-loop gives
    the same logits."""
    ds = synthesize("Proteins", scale=0.05, seed=5)
    it = ClusterBatcher(ds, 8, 2, bit_width=2, seed=5, partition_method="bfs")
    eng = QGTCEngine(feat_dim=it.feat_dim, num_classes=ds.num_classes, model=model, seed=4, device=cuda,
                     zerotile_jump=zerotile_jump)
    step = eng.forward_all(it)
    before = packmm.LAUNCHES, digitmm.LAUNCHES
    epoch = eng._fused_epoch(it)
    assert (packmm.LAUNCHES - before[0], digitmm.LAUNCHES - before[1]) == (6 * len(it), 6 * len(it))
    outs = epoch()
    for _ in range(2):
        torch.cuda.synchronize()
        assert len(outs) == len(it) and all(torch.equal(o, s) for o, s in zip(outs, step))
        for o in outs:
            o.fill_(-1.0)
        before = packmm.LAUNCHES, digitmm.LAUNCHES
        assert epoch() is outs and (packmm.LAUNCHES, digitmm.LAUNCHES) == before
    qil = eng._fused_logits(it, quant_in_loop=True)
    torch.cuda.synchronize()
    assert all(torch.equal(q, s) for q, s in zip(qil, step))


def test_refused_mega_bucket_runs_the_captured_fused_epoch_on_card(cuda, monkeypatch):
    ds = synthesize("Proteins", scale=0.05, seed=5)
    it = ClusterBatcher(ds, 8, 2, bit_width=2, seed=5, partition_method="bfs")
    eng = QGTCEngine(feat_dim=it.feat_dim, num_classes=ds.num_classes, seed=4, device=cuda)

    def refuse(*args, **kw):
        raise ValueError("refused")

    monkeypatch.setattr(fused_model, "plan", refuse)
    before = fused_model.LAUNCHES
    got = eng._mega_logits(it)
    torch.cuda.synchronize()
    assert fused_model.LAUNCHES == before and all(b["fallback"] for b in eng.mega_buckets)
    assert all(torch.equal(g, s) for g, s in zip(got, eng.forward_all(it)))


@pytest.mark.parametrize("model", ["sage", "gin"])
def test_captured_baseline_fused_loop_on_card(cuda, model):
    """The baseline's fused loop captured as one CUDA graph against the
    loop run uncaptured: within 2^-6 of each row's max |logit| (cuBLAS may
    choose another algorithm under capture), and the same over a
    sentinel."""
    ds = synthesize("Proteins", scale=0.05, seed=5)
    it = ClusterBatcher(ds, 8, 2, bit_width=2, seed=5, partition_method="bfs")
    eng = BaselineEngine(feat_dim=it.feat_dim, num_classes=ds.num_classes, model=model, seed=4, device=cuda)
    loop = {}
    for idx, a, x in eng._stage(it, ds, torch.uint8):
        loop.update(zip(idx, eng._fused_bucket(a, x)))
    epoch = eng._fused_epoch(it, ds)
    outs = epoch()
    for _ in range(2):
        torch.cuda.synchronize()
        assert max(bf16_rel_err(o, loop[i]) for i, o in enumerate(outs)) <= BF16_REL_TOL
        for o in outs:
            o.fill_(-1e30)
        assert epoch() is outs


# -- the kernel-study probes (qgtc_ppopp22_tpu_torch/benchmarks/) ----------

def _probe_operands(seed, m, k, np_, bits, tm, dev, dense=True):
    """Words in the layout of tile tm and B int8 [1, k, np_] with a negated
    column, on the card."""
    rng = np.random.default_rng(seed)
    if dense:
        qa = rng.integers(0, 1 << bits, (m, k))
    else:
        qa = operands(seed, m, k, 16, bits, bits, bits, 0)[0]
    qb = rng.integers(0, 1 << bits, (k, np_))
    qb[:, 1] *= -1
    words = torch.from_numpy(exp_packmm.pack_rows_np(qa, bits, tm)[None]).to(dev)
    return qa, words, torch.from_numpy(qb.astype(np.int8)[None]).to(dev)


@pytest.mark.parametrize("variant", exp_packmm.VARIANTS + ("int8", "rowrange"))
@pytest.mark.parametrize("bits", [1, 2, 4])
@pytest.mark.parametrize("shape", [(512, 256, 16, 256), (768, 640, 64, 256), (1024, 512, 48, 512)])
def test_packmm_exp_kernel_equals_plain(cuda, variant, bits, shape):
    m, k, np_, tm = shape
    if variant == "rowrange":
        tm = 256  # K2's row ranges read the port's layout only
    qa, words, b = _probe_operands(bits + m + np_, m, k, np_, bits, tm, cuda)
    before = exp_packmm.LAUNCHES
    if variant == "int8":
        a8 = torch.from_numpy(qa.astype(np.int8)[None]).to(cuda)
        got, want = exp_packmm.packmm_exp_int8(a8, b), exp_packmm.packmm_exp_int8_plain(a8, b)
    elif variant == "rowrange":
        got, want = exp_packmm.packmm_exp_rowrange(words, b, bits), exp_packmm.packmm_exp_plain(words, b, bits, tm)
    else:
        got = exp_packmm.packmm_exp(words, b, bits, tm, variant)
        want = exp_packmm.packmm_exp_plain(words, b, bits, tm, variant)
    assert exp_packmm.LAUNCHES == before + 1
    _check(got, want)
    if variant in ("concat", "int8", "rowrange"):
        _check(got, exp_packmm.packmm_exp_plain(words, b, bits, tm, "concat"))


@pytest.mark.parametrize("bits", [1, 2, 4])
@pytest.mark.parametrize("shape", [(1024, 512, 16, 1024, 0), (1024, 512, 64, 1024, 256),
                                   (1024, 256, 16, 1024, 512), (768, 512, 16, 768, 256)])
def test_packmm_exp_packedout_kernel_equals_plain(cuda, bits, shape):
    m, k, np_, tm, group = shape
    _, words, b = _probe_operands(bits + group, m, k, np_, bits, group or tm, cuda, dense=False)
    before = exp_packmm.PACKEDOUT_LAUNCHES
    got = exp_packmm.packmm_exp_packedout(words, b, bits, tm, group)
    assert exp_packmm.PACKEDOUT_LAUNCHES == before + 1
    _check(got, exp_packmm.packmm_exp_packedout_plain(words, b, bits, tm, group))


def test_packmm_exp_refuses_what_the_kernel_cannot_index(cuda):
    _, words, b = _probe_operands(0, 512, 4096, 64, 1, 256, cuda)
    with pytest.raises(ValueError):  # B [4096 x 64] on one CTA does not fit in shared memory
        exp_packmm.packmm_exp(words, b, 1, 256, "bres",
                              _plan=exp_packmm.exp_packmm_plan(512, 4096, 64, 1, 256, "bres", bnt=64, splits=1))
    _, words, b = _probe_operands(0, 512, 256, 16, 1, 512, cuda)
    with pytest.raises(ValueError):  # tm % 256 != 0 is JAX-legal but not the kernel's
        exp_packmm.packmm_exp(torch.zeros((1, 4, 256), dtype=torch.int32, device=cuda), b, 1, 128)


@pytest.mark.parametrize("shape", [(8, 128), (5, 40), (64, 300), (16, 6), (3, 7), (1024, 4096)])
def test_bitcast_kernels_equal_plain(cuda, shape):
    x = torch.from_numpy(np.random.default_rng(shape[1]).integers(-2**31, 2**31, shape).astype(np.int32)).to(cuda)
    y = exp_bitcast_probe.bitcast32to8(x)
    _check(y, exp_bitcast_probe.bitcast32to8_plain(x))
    want = exp_bitcast_probe.bitcast8to32_plain(y)
    _check(want, x)
    torch.full(tuple(x.shape), -1, dtype=torch.int32, device=cuda)  # a freed block the output may reuse
    before = exp_bitcast_probe.TO32_LAUNCHES
    _check(exp_bitcast_probe.bitcast8to32(y), want)  # P2b's vector path (n % 4 == 0) or its tail
    assert exp_bitcast_probe.TO32_LAUNCHES == before + 1
    _check(exp_bitcast_probe.bitcast8to32(y), x)


def test_bitcast_and_fragment_tables_on_card(cuda):
    before = (exp_bitcast_probe.TO8_LAUNCHES, exp_bitcast_probe.TO32_LAUNCHES,
              exp_bitcast_probe.FRAGMENT_LAUNCHES)
    out8 = exp_bitcast_probe.probe32to8("cuda")
    assert out8[:, 0].tolist() == list(range(32))
    out32 = exp_bitcast_probe.probe8to32("cuda")
    assert [hex(v) for v in out32[:4, 0].tolist()] == ["0x3020100", "0x7060504", "0xb0a0908", "0xf0e0d0c"]
    assert exp_bitcast_probe.probe_fragments("cuda")
    tile = torch.from_numpy(np.random.default_rng(0).integers(-128, 128, (2, 64, 64)).astype(np.int8)).to(cuda)
    for got, want in zip(exp_bitcast_probe.fragment_registers(tile[0], tile[1]),
                         exp_bitcast_probe.fragment_registers_plain(tile[0], tile[1])):
        _check(got, want)
    after = (exp_bitcast_probe.TO8_LAUNCHES, exp_bitcast_probe.TO32_LAUNCHES,
             exp_bitcast_probe.FRAGMENT_LAUNCHES)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 3]


# (B, pn, G, xp, oc): small shapes, then the study's geometry (pn 1024 and
# 2048: 2 and 4 row tiles a CTA of the cluster of 8; G 5 batches a cluster)
ZERO_BODY_CASES = [(6, 512, G, xp, oc) for G in (1, 3) for xp, oc in ((128, 48), (64, 8), (128, 120))] \
    + [(10, pn, G, 128, 48) for pn in (1024, 2048) for G in (1, 5)]


@pytest.mark.parametrize("B,pn,G,xp,oc", ZERO_BODY_CASES)
def test_zero_body_kernel_writes_every_zero(cuda, B, pn, G, xp, oc):
    x = torch.from_numpy(np.random.default_rng(G).integers(-128, 128, (B, pn, xp)).astype(np.int8)).to(cuda)
    torch.full((B, pn, oc), float("nan"), device=cuda)  # a freed block the output may reuse
    before = grid_overhead_study.ZERO_BODY_LAUNCHES
    got = grid_overhead_study.zero_body(x, oc, G)
    assert grid_overhead_study.ZERO_BODY_LAUNCHES == before + 1
    _check(got, grid_overhead_study.zero_body_plain(x, oc, G))


@pytest.mark.parametrize("K", [0, 1, 2])
@pytest.mark.parametrize("oc", [8, 48, 120])
@pytest.mark.parametrize("pn", [256, 640, 2048])
def test_kdot_kernel_equals_plain(cuda, K, oc, pn):
    rng = np.random.default_rng(K + oc + pn)
    x = torch.from_numpy(rng.integers(-128, 128, (3, pn, 128)).astype(np.int8)).to(cuda)
    s = torch.from_numpy(rng.integers(-128, 128, (pn, pn)).astype(np.int8)).to(cuda)
    before = grid_overhead_study.KDOT_LAUNCHES
    got = grid_overhead_study.kdot(x, s, oc, K)
    assert grid_overhead_study.KDOT_LAUNCHES == before + 1
    _check(got, grid_overhead_study.kdot_plain(x, s, oc, K))
