"""The kernel-study probes of the port (``qgtc_ppopp22_tpu_torch/benchmarks/``:
``exp_packmm``, ``exp_bitcast_probe``, ``grid_overhead_study``) against
the JAX scripts under ``benchmarks/``, on the CPU.

The JAX scripts' Pallas kernels run in interpret mode: ``pallas_call`` is
patched to pass ``interpret=True`` and each script is loaded from its
file, unchanged. The port's CPU path is each kernel's plain version (the
kernels themselves are held to it on the card by
``tests/test_torch_kernels.py``). Tolerance: exact equality throughout.
``grid_overhead_study.py`` defines its kernels inside ``main()``, so they
cannot be imported: its zero-body and K-dot bodies (:83-85, :109-121) are
restated here in NumPy.
"""

import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

from qgtc_ppopp22_tpu_torch.benchmarks import exp_bitcast_probe as bp
from qgtc_ppopp22_tpu_torch.benchmarks import exp_packmm as ep
from qgtc_ppopp22_tpu_torch.benchmarks import grid_overhead_study as go
from qgtc_ppopp22_tpu_torch.ops import packmm
from torch_cases import operands  # tests/ is on sys.path
from torch_threads import one_thread  # noqa: F401  (an autouse fixture: one torch thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NP = 128  # B's padded width, as the JAX script pads it


@pytest.fixture
def jax_script(monkeypatch):
    """Load ``benchmarks/<name>.py`` with its Pallas kernels in interpret mode."""
    from jax.experimental import pallas

    monkeypatch.setattr(pallas, "pallas_call", functools.partial(pallas.pallas_call, interpret=True))

    def load(name):
        spec = importlib.util.spec_from_file_location(f"jax_{name}", os.path.join(REPO, "benchmarks", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    return load


def _b(qb):
    """B levels [K, N] -> int8 [1, K, NP], zero-padded (JAX ``run_shape``)."""
    b = np.zeros((1, qb.shape[0], NP), np.int8)
    b[0, :, :qb.shape[1]] = qb
    return b


def _signed_b(seed, k, n, bits):
    """B levels with a negated column, so sums below 0 occur."""
    qb = np.random.default_rng(seed).integers(0, 1 << bits, (k, n))
    qb[:, -1] *= -1
    return qb


@pytest.mark.parametrize("bits", [1, 2, 4])
def test_pack_rows_tile_256_is_the_packmm_layout(bits):
    q = np.random.default_rng(bits).integers(0, 1 << bits, (512, 256))
    words = ep.pack_rows_np(q, bits, 256)
    assert np.array_equal(words, packmm.pack_rows_np(q, bits)[0])
    for tm in (256, 512):
        w = ep.pack_rows_np(q, bits, tm)
        assert np.array_equal(ep.unpack_rows_np(w, bits, tm), q)
        wt = torch.from_numpy(w)
        assert torch.equal(ep.unpack_levels(wt, bits, tm), torch.from_numpy(q))
        assert torch.equal(ep.pack_levels(torch.from_numpy(q), bits, tm), wt)


# every variant at 1/2/4 bits; the shapes (M = K, tm) cycle through the
# three combinations of M = K in {256, 512} and tm in {256, 512}; concat
# on K2's row ranges (the port's row, JAX's concat) in the tm = 256 layout
P1A_CASES = [(v, bits, (256, 256) if i % 3 == 0 else (512, 256) if i % 3 == 1 else (512, 512))
             for i, (v, bits) in enumerate((v, b) for v in ep.VARIANTS for b in (1, 2, 4))] \
    + [("rowrange", bits, (512, 256)) for bits in (1, 2, 4)]


@pytest.mark.parametrize("variant,bits,shape", P1A_CASES)
def test_packmm_exp_equals_jax_interpret(jax_script, variant, bits, shape):
    jx = jax_script("exp_packmm")
    mk, tm = shape
    rng = np.random.default_rng(bits + mk + tm)
    qa = rng.integers(0, 1 << bits, (mk, mk))  # dense: every field and byte of the words is used
    qb = _signed_b(mk, mk, 16, bits)
    words, b = jx.pack_rows_np(qa, bits, tm)[None], _b(qb)
    if variant == "rowrange":
        want = np.asarray(jx.make_packmm(mk, mk, NP, bits, tm, 128, NP, "concat")(words, b))
        got = ep.packmm_exp_rowrange(torch.from_numpy(words), torch.from_numpy(b), bits)
    else:
        want = np.asarray(jx.make_packmm(mk, mk, NP, bits, tm, 128, NP, variant)(words, b))
        got = ep.packmm_exp(torch.from_numpy(words), torch.from_numpy(b), bits, tm, variant, tk=128)
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)
    if variant != "noextract":
        assert np.array_equal(want[:, :16], (qa @ qb).astype(np.float32))


@pytest.mark.parametrize("group", [0, 256])
@pytest.mark.parametrize("bits", [1, 2, 4])
def test_packmm_exp_packedout_equals_jax_interpret(jax_script, bits, group):
    jx = jax_script("exp_packmm")
    mk, tm = 512, 512
    qa, _ = operands(bits + group, mk, mk, 16, bits, bits, bits, 0)  # accumulators near 2^bits
    qb = _signed_b(group, mk, 16, bits)
    words, b = jx.pack_rows_np(qa, bits, group or tm)[None], _b(qb)
    want = np.asarray(jx.make_packmm_packedout(mk, mk, NP, bits, tm, 128, NP, group=group)(words, b))
    got = ep.packmm_exp_packedout(torch.from_numpy(words), torch.from_numpy(b), bits, tm, group, tk=128)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    levels = jx.unpack_rows_np(want[0], bits, group or tm)[:, :16]
    ub = 1 << bits
    acc = qa @ qb
    assert np.array_equal(levels, np.where(acc > ub, ub - 1, np.where(acc < 0, 1, acc)) & (ub - 1))
    assert (acc < 0).any() and (acc > ub).any() and ((acc >= 0) & (acc <= ub)).mean() > 0.3


def test_packmm_exp_int8_and_cpu_dispatch():
    rng = np.random.default_rng(0)
    qa, qb = rng.integers(-128, 128, (256, 128)), rng.integers(-128, 128, (128, 16))
    a, b = (torch.from_numpy(q.astype(np.int8)[None]) for q in (qa, qb))
    before = (ep.LAUNCHES, ep.PACKEDOUT_LAUNCHES)
    assert np.array_equal(ep.packmm_exp_int8(a, b).numpy(), (qa @ qb).astype(np.float32))
    assert (ep.LAUNCHES, ep.PACKEDOUT_LAUNCHES) == before  # the CPU runs the plain version
    with pytest.raises(ValueError):
        ep.packmm_exp(torch.zeros((1, 8, 128), dtype=torch.int32), b, 1, 256, "nope")
    with pytest.raises(ValueError):  # tm must divide Mp = 256
        ep.packmm_exp(torch.zeros((1, 8, 128), dtype=torch.int32), b, 1, 512)


def test_bitcast_probes_print_the_jax_tables(jax_script, capsys):
    jx = jax_script("exp_bitcast_probe")
    jx.probe32to8()
    jx.probe8to32()
    want = capsys.readouterr().out
    bp.probe32to8("cpu")  # asserts lane invariance, as the JAX probe does
    bp.probe8to32("cpu")
    assert capsys.readouterr().out == want
    assert "[0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12" in want and "'0x3020100'" in want


def test_bitcast_roundtrip_and_byte_order():
    x = torch.from_numpy(np.random.default_rng(0).integers(-2**31, 2**31, (6, 40)).astype(np.int32))
    y = bp.bitcast32to8(x)
    want = x.numpy().view(np.int8).reshape(6, 40, 4).transpose(0, 2, 1).reshape(24, 40)  # little-endian
    assert np.array_equal(y.numpy(), want)
    assert torch.equal(bp.bitcast8to32(y), x)


def test_fragment_table_is_the_ptx_layout(capsys):
    got_a, got_b = bp.fragment_table("cpu")
    want_a, want_b = bp.ptx_layout()
    assert np.array_equal(got_a, want_a) and np.array_equal(got_b, want_b)
    # lane 5 = group 1, thread 1: the gemm_core.cuh comment's fragment loads
    assert [tuple(p) for p in want_a[5, 1]] == [(9, 4), (9, 5), (9, 6), (9, 7)]
    assert [tuple(p) for p in want_b[5, 1]] == [(20, 1), (21, 1), (22, 1), (23, 1)]
    assert bp.probe_fragments("cpu")
    out = capsys.readouterr().out
    assert "lane  5: a0 (1, 4-7) a1 (9, 4-7) a2 (1, 20-23) a3 (9, 20-23) | b0 (4-7, 1) b1 (20-23, 1)" in out


def _kdot_numpy(x, s, oc, K):
    """The JAX kdot body (:109-121) per batch, with S given."""
    out = []
    for h in x:
        acc = np.zeros((h.shape[0], 128), np.int32)
        for k in range(K):
            hk = np.roll(h.astype(np.int32), k, axis=1).astype(np.int8) if k else h
            acc = acc + s.astype(np.int32) @ hk.astype(np.int32)
        out.append(acc[:, :oc].astype(np.float32))
    return np.stack(out)


@pytest.mark.parametrize("K", [0, 1, 2])
@pytest.mark.parametrize("oc", [8, 48, 120])
def test_kdot_plain_equals_the_jax_body(K, oc):
    rng = np.random.default_rng(K + oc)
    x = rng.integers(-128, 128, (2, 128, 128)).astype(np.int8)
    s = rng.integers(-128, 128, (128, 128)).astype(np.int8)
    got = go.kdot(torch.from_numpy(x), torch.from_numpy(s), oc, K)
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), _kdot_numpy(x, s, oc, K))


@pytest.mark.parametrize("G", [1, 3])
def test_zero_body_plain_equals_the_jax_body(G):
    x = torch.from_numpy(np.random.default_rng(G).integers(-128, 128, (3, 128, 128)).astype(np.int8))
    got = go.zero_body(x, 48, G)
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), np.zeros((3, 128, 48), np.float32))
    with pytest.raises(ValueError):
        go.zero_body(x, 48, 2)  # G must divide B


def test_study_rows_check_and_take_turns():
    assert go.l2_copies(go.L2_BYTES) == 3 and go.l2_copies(50 * 2048 * 128) == 9
    seen = []
    call = go.in_turns(seen.append, ["a", "b", "c"])
    for _ in range(4):
        call()
    assert seen == ["a", "b", "c", "a"]
    x = go.random_x(2, 128, torch.Generator().manual_seed(0), "cpu")
    assert x.dtype == torch.int8 and x.shape == (2, 128, 128) and x.min() < -100 and x.max() > 100
    go._checked("zero body", lambda: go.zero_body(x, 48), lambda: go.zero_body_plain(x, 48))
    with pytest.raises(AssertionError, match="kdot"):
        go._checked("kdot", lambda: go.kdot(x, x[0], 8, 1), lambda: go.kdot(x, x[0], 8, 2))


def test_layer_ladder_inputs_and_launch_on_cpu():
    rng = np.random.default_rng(0)
    a, xs, ws = go.mega_inputs(256, 2, 3, rng, "cpu")
    assert a.shape == (2, 8, 256) and xs.shape == (2, 1, 256, 128) and [w.shape for w in ws] == [
        (100, 16), (16, 16), (16, 47)]
    assert torch.equal(a[0], a[1]) and 0.005 < float(packmm.unpack_rows_np(a[:1].numpy(), 1).mean()) < 0.015
    out = go.layer_epoch(a, xs, ws)
    assert out.shape == (2, 256, 48) and torch.isfinite(out).all() and torch.equal(out[0], out[1])
    assert go.cluster_size(256) == 4 and go.cluster_size(2048) == 8


@pytest.mark.parametrize("module", [ep, bp, go])
def test_study_mains_refuse_the_cpu(module, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        module.main([])
