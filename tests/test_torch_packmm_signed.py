"""The kernel sweep's path in the PyTorch port (plain versions, CPU) against
the JAX package in Pallas interpret mode and ``tests/golden.py``:
``PreparedRHS`` and the product that takes it (the TPU kernel
``_packmm_signed_stream``), ``_packmm``'s packed-words output and
``out_cols``, ``pack_digit_tensor``, the sweep's operands and
``write_csv``.

Tolerance: exact equality, whole containers padding included. Every
product is integer arithmetic; float32 outputs are the same integers
rounded once. Test data is the JAX tests' uniform levels (which saturate
the requantizer) and ``tests/torch_cases.operands`` (sparse enough that
the requantizer sees both sides of its clamp). Rows stay at most 768, so
that JAX's interpret mode stays quick.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgtc_ppopp22_tpu.ops import digits as jdigits
from qgtc_ppopp22_tpu.ops import packmm as jpackmm
from qgtc_ppopp22_tpu.utils import metrics as jmetrics
from qgtc_ppopp22_tpu_torch.benchmarks import kernel_sweep
from qgtc_ppopp22_tpu_torch.ops import digits, packmm
from qgtc_ppopp22_tpu_torch.utils import metrics
from tests.golden import bitmm_np
from tests.torch_cases import operands
from torch_threads import one_thread  # noqa: F401  (an autouse fixture: one torch thread)

BITS = [1, 2, 4, 8]


def _pair(qa, qb, a_bits, b_bits, prepared=False):
    """The same operands for the port and for JAX."""
    a = packmm.pack_rows(torch.from_numpy(qa), a_bits)
    b = digits.digit_pack(torch.from_numpy(qb), b_bits)
    ja = jpackmm.pack_rows(jnp.asarray(qa), a_bits)
    jb = jdigits.digit_pack(jnp.asarray(qb), b_bits)
    if prepared:
        return a, packmm.prepare_rhs(b), ja, jpackmm.prepare_rhs(jb)
    return a, b, ja, jb


def _payload(out):
    """The array a wrapper returns: words, digit planes or a tensor."""
    for name in ("words", "digits"):
        if hasattr(out, name):
            return getattr(out, name)
    return out


def _same(got, ref):
    g, r = _payload(got), np.asarray(_payload(ref))
    assert g.numpy().dtype == r.dtype and g.shape == r.shape
    np.testing.assert_array_equal(g.numpy(), r)
    if hasattr(ref, "shape") and hasattr(got, "bits"):
        assert tuple(got.shape) == tuple(ref.shape) and got.bits == ref.bits


# -- PreparedRHS ------------------------------------------------------------


@pytest.mark.parametrize("bits", [5, 8])
@pytest.mark.parametrize("n", [16, 60, 120])
def test_prepare_rhs_matches_jax(bits, n):
    qb = np.random.default_rng(n + bits).integers(0, 1 << bits, (300, n)).astype(np.int32)
    got = packmm.prepare_rhs(digits.digit_pack(torch.from_numpy(qb), bits))
    ref = jpackmm.prepare_rhs(jdigits.digit_pack(jnp.asarray(qb), bits))
    assert got.plane.dtype == torch.int8 and got.corr.dtype == torch.int32
    np.testing.assert_array_equal(got.plane.numpy(), np.asarray(ref.plane))
    np.testing.assert_array_equal(got.corr.numpy(), np.asarray(ref.corr))
    assert got.shape == ref.shape == (300, n) and got.bits == ref.bits == bits
    assert got.to("cpu").plane is not None


@pytest.mark.parametrize("n", [121, 128])
def test_prepare_rhs_needs_a_free_lane(n):
    qb = np.ones((64, n), np.int32)
    with pytest.raises(ValueError, match="free lane"):
        packmm.prepare_rhs(digits.digit_pack(torch.from_numpy(qb), 8))
    with pytest.raises(ValueError, match="free lane"):
        jpackmm.prepare_rhs(jdigits.digit_pack(jnp.asarray(qb), 8))


# -- the PreparedRHS product (K4) ------------------------------------------


@functools.lru_cache(maxsize=None)
def _signed_case(n, data):
    M, K = 700, 300
    if data == "uniform":
        rng = np.random.default_rng(n)
        qa = rng.integers(0, 256, (M, K)).astype(np.int32)
        qb = rng.integers(0, 256, (K, n)).astype(np.int32)
    else:
        qa, qb = operands(n, M, K, n, 8, 8, 8, 0)
    return (qa, qb) + _pair(qa, qb, 8, 8, prepared=True)


# (out_bits, out_form, shift, raw_i32, out_cols); out_cols -1 stands for N
SIGNED_FORMS = [
    (None, "f32", 0, False, None),
    (None, "f32", 0, False, -1),
    (None, "f32", 0, True, None),
    (2, "digits", 0, False, None),
    (4, "digits", 2, False, None),
    (8, "digits", 0, False, None),
    (8, "packed", 0, False, None),
    (8, "packed", 2, False, -1),
    (1, "packed", 0, False, -1),
    (2, "packed", 0, False, -1),
    (4, "packed", 2, False, -1),
]


def _call(lib, a, b, form):
    out_bits, out_form, shift, raw, oc = form
    if out_bits is None:
        return lib.packmm_to_i32(a, b) if raw else lib.packmm_to_f32(a, b, out_cols=oc)
    if out_form == "digits":
        return lib.packmm_to_digits(a, b, out_bits, shift=shift)
    return lib.packmm_to_packed(a, b, out_bits, shift=shift, out_cols=oc)


@pytest.mark.parametrize("data", ["uniform", "linear"])
@pytest.mark.parametrize("form", SIGNED_FORMS, ids=str)
@pytest.mark.parametrize("n", [16, 60, 120])
def test_prepared_rhs_product_matches_jax(n, form, data):
    qa, qb, a, bp, ja, jbp = _signed_case(n, data)
    form = form[:4] + ((n if form[4] == -1 else form[4]),)
    got = _call(packmm, a, bp, form)
    _same(got, _call(jpackmm, ja, jbp, form))
    # the plain version is what the wrapper runs on CPU tensors
    _same(got, packmm.packmm_signed_plain(a, bp, form[0], form[1], form[2], form[3], form[4]))
    out_bits = form[0]
    if out_bits is None:
        np.testing.assert_array_equal(got.numpy().astype(np.float64)[:, :n],
                                      bitmm_np(qa, qb, 8, 8, None)[:, : got.shape[1]])
    elif form[1] == "packed":
        want = bitmm_np(qa, qb, 8, 8, out_bits, form[2])
        np.testing.assert_array_equal(packmm.unpack_rows(got).numpy(), want[:, : got.words.shape[2]])


def test_prepared_rhs_padding_is_level_zero():
    """Rows >= M and lanes >= N come out as level 0: -128 bytes in the
    signed plane, 0 in digit planes and low-bit words."""
    M, N = 700, 60
    _, _, a, bp, _, _ = _signed_case(N, "uniform")
    w = packmm.packmm_to_packed(a, bp, 8).words[0]
    assert (w[M:] == -128).all() and (w[:, N:] == -128).all()
    d = packmm.packmm_to_digits(a, bp, 4, shift=2).digits
    assert (d[:, M:] == 0).all() and (d[:, :, N:] == 0).all()
    lv = packmm.packed_levels(packmm.packmm_to_packed(a, bp, 2, out_cols=N))
    assert (lv[M:] == 0).all() and (lv[:, N:] == 0).all()


def test_prepared_rhs_beyond_the_tpu_streaming_buffer():
    """K = 16512 overflows the TPU kernel's VMEM streaming buffer (a
    TPU-only limit): JAX refuses it, the port computes it."""
    rng = np.random.default_rng(7)
    qa = rng.integers(0, 256, (256, 16512)).astype(np.int32)
    qb = rng.integers(0, 256, (16512, 16)).astype(np.int32)
    a, bp, ja, jbp = _pair(qa, qb, 8, 8, prepared=True)
    with pytest.raises(ValueError, match="streaming buffer"):
        jpackmm.packmm_to_f32(ja, jbp)
    np.testing.assert_array_equal(packmm.packmm_to_f32(a, bp).numpy(), bitmm_np(qa, qb, 8, 8, None))


# -- packed-words output of the DigitTensor product (K2) -------------------


@pytest.mark.parametrize("out_cols", [None, 40])
@pytest.mark.parametrize("out_bits", BITS)
@pytest.mark.parametrize("a_bits", BITS)
def test_packmm_to_packed_matches_jax(a_bits, out_bits, out_cols):
    M, K, N = 300, 520, 40
    # 8-bit A and B hold small levels, so the sums land in the clamp's range
    lv = 2 if a_bits == 8 else a_bits
    qa, qb = operands(a_bits * 10 + out_bits, M, K, N, lv, lv, out_bits, 0)
    a, b, ja, jb = _pair(qa, qb, a_bits, a_bits)
    got = packmm.packmm_to_packed(a, b, out_bits, out_cols=out_cols)
    ref = jpackmm.packmm_to_packed(ja, jb, out_bits, out_cols=out_cols)
    _same(got, ref)
    np.testing.assert_array_equal(packmm.unpack_rows(got).numpy(),
                                  bitmm_np(qa, qb, a_bits, a_bits, out_bits))
    want = bitmm_np(qa, qb, a_bits, a_bits, out_bits)
    assert len(np.unique(want)) > 1  # neither all 0 nor saturated
    f = packmm.packmm_to_f32(a, b, out_cols=out_cols)
    _same(f, jpackmm.packmm_to_f32(ja, jb, out_cols=out_cols))


@pytest.mark.parametrize("out_bits", [2, 8])
def test_packmm_to_packed_with_shift_matches_jax(out_bits):
    qa, qb = operands(out_bits, 256, 256, 64, 2, 2, out_bits, 3)
    a, b, ja, jb = _pair(qa, qb, 2, 2)
    got = packmm.packmm_to_packed(a, b, out_bits, shift=3)
    _same(got, jpackmm.packmm_to_packed(ja, jb, out_bits, shift=3))
    np.testing.assert_array_equal(packmm.unpack_rows(got).numpy(), bitmm_np(qa, qb, 2, 2, out_bits, 3))


@pytest.mark.parametrize("n", [512, 300])
def test_packmm_wide_n_matches_jax(n):
    """N beyond one column tile (tests/test_packmm.py:329-344)."""
    qa, qb = operands(n, 512, 512, n, 1, 2, 2, 0)
    a, b, ja, jb = _pair(qa, qb, 1, 2)
    got = packmm.packmm_to_packed(a, b, 2)
    _same(got, jpackmm.packmm_to_packed(ja, jb, 2))
    np.testing.assert_array_equal(packmm.unpack_rows(got).numpy(), bitmm_np(qa, qb, 1, 2, 2))
    _same(packmm.packmm_to_f32(a, b), jpackmm.packmm_to_f32(ja, jb))


@pytest.mark.parametrize("n", [512, 300])
def test_out_cols_beyond_one_column_tile(n):
    """``out_cols`` with several column tiles: JAX refuses it (its
    single-column-tile restriction is the TPU's), the port stores the
    first round8(out_cols) columns of the full output."""
    qa, qb = operands(n + 1, 512, 512, n, 1, 2, 2, 0)
    a, b, ja, jb = _pair(qa, qb, 1, 2)
    with pytest.raises(ValueError, match="single output column tile"):
        jpackmm.packmm_to_packed(ja, jb, 2, out_cols=n)
    ocp = -(-n // 8) * 8
    full = np.asarray(jpackmm.packmm_to_packed(ja, jb, 2).words)
    got = packmm.packmm_to_packed(a, b, 2, out_cols=n)
    np.testing.assert_array_equal(got.words.numpy(), full[:, :, :ocp])
    np.testing.assert_array_equal(packmm.packmm_to_f32(a, b, out_cols=n).numpy(),
                                  np.asarray(jpackmm.packmm_to_f32(ja, jb)))


def test_packed_output_chains_as_next_lhs():
    """tests/test_packmm.py:232-251: a 2-bit packed output is the next
    product's A; the digit output its B."""
    rng = np.random.default_rng(3)
    qa = rng.integers(0, 2, (256, 256)).astype(np.int32)
    qx = rng.integers(0, 4, (256, 128)).astype(np.int32)
    qw = rng.integers(0, 4, (128, 128)).astype(np.int32)
    x, w, jx, jw = _pair(qx, qw, 2, 2)
    xw = packmm.packmm_to_packed(x, w, 2)
    _same(xw, jpackmm.packmm_to_packed(jx, jw, 2))
    np.testing.assert_array_equal(packmm.unpack_rows(xw).numpy()[:256, :128], bitmm_np(qx, qw, 2, 2, 2))
    a = packmm.pack_rows(torch.from_numpy(qa), 1)
    axw = packmm.packmm_to_digits(a, packmm.packmm_to_digits(x, w, 2), 2)
    want = bitmm_np(qa, bitmm_np(qx, qw, 2, 2, 2), 1, 2, 2)
    np.testing.assert_array_equal(digits.digit_unpack(axw).numpy(), want)


def test_signed_packed_output_chains_as_next_lhs():
    """tests/test_packmm.py:253-280: an 8-bit packed output (the signed
    plane) is the next product's A, its padding (level 0) included."""
    rng = np.random.default_rng(4)
    qx = rng.integers(0, 256, (200, 256)).astype(np.int32)
    qw = rng.integers(0, 256, (256, 60)).astype(np.int32)
    qw2 = rng.integers(0, 256, (64, 40)).astype(np.int32)
    x, w, jx, jw = _pair(qx, qw, 8, 8)
    xw, jxw = packmm.packmm_to_packed(x, w, 8), jpackmm.packmm_to_packed(jx, jw, 8)
    _same(xw, jxw)
    xw2 = packmm.PackedTensor(words=xw.words, shape=(200, 64), bits=8)
    jxw2 = jpackmm.PackedTensor(words=jxw.words, shape=(200, 64), bits=8)
    got = packmm.packmm_to_f32(xw2, digits.digit_pack(torch.from_numpy(qw2), 8))
    _same(got, jpackmm.packmm_to_f32(jxw2, jdigits.digit_pack(jnp.asarray(qw2), 8)))
    want1 = np.zeros((200, 64), np.int64)
    want1[:, :60] = bitmm_np(qx, qw, 8, 8, 8)
    np.testing.assert_array_equal(got.numpy(), bitmm_np(want1, qw2, 8, 8, None))


@pytest.mark.parametrize("bits", BITS)
def test_pack_digit_tensor_matches_jax(bits):
    q = np.random.default_rng(bits).integers(0, 1 << bits, (130, 200)).astype(np.int32)
    got = packmm.pack_digit_tensor(digits.digit_pack(torch.from_numpy(q), bits))
    ref = jpackmm.pack_digit_tensor(jdigits.digit_pack(jnp.asarray(q), bits))
    _same(got, ref)
    np.testing.assert_array_equal(packmm.unpack_rows(got).numpy(), q)


# -- dispatch ----------------------------------------------------------------


def test_prepared_rhs_needs_a_signed_lhs():
    qa, qb = operands(1, 256, 128, 16, 2, 8, 8, 0)
    a = packmm.pack_rows(torch.from_numpy(qa), 2)
    bp = packmm.prepare_rhs(digits.digit_pack(torch.from_numpy(qb), 8))
    with pytest.raises(ValueError, match="signed-plane A"):
        packmm.packmm_to_f32(a, bp)
    with pytest.raises(ValueError, match="signed-plane A"):
        packmm.packmm_plain(a, bp)


@pytest.mark.parametrize("wrapper", ["packmm_to_f32", "packmm_to_i32", "packmm_to_digits",
                                     "packmm_to_packed"])
def test_tile_map_is_not_taken(wrapper):
    """Each wrapper takes a ``tile_map`` as JAX's does (the map built by
    ``build_tile_map_packed``, equal to JAX's, gives JAX's output); a
    ``PreparedRHS`` with a map raises ``ValueError``, as in JAX."""
    qa, qb = operands(2, 512, 512, 16, 8, 8, 8, 0)
    qa[256:, :256] = 0
    qa[0, 0] = qa[0, 300] = qa[300, 300] = 1
    a, b, ja, jb = _pair(qa, qb, 8, 8)
    tm = packmm.build_tile_map_packed(a, 256, 256)
    jtm = jpackmm.build_tile_map_packed(ja, 256, 256)
    assert tm.kcnt.tolist() == np.asarray(jtm.kcnt).tolist() == [2, 1]
    args = (() if wrapper in ("packmm_to_f32", "packmm_to_i32") else (8,))
    _same(getattr(packmm, wrapper)(a, b, *args, tile_map=tm), getattr(jpackmm, wrapper)(ja, jb, *args, tile_map=jtm))
    bp, jbp = packmm.prepare_rhs(b), jpackmm.prepare_rhs(jb)
    for call in (lambda: getattr(packmm, wrapper)(a, bp, *args, tile_map=tm),
                 lambda: getattr(jpackmm, wrapper)(ja, jbp, *args, tile_map=jtm)):
        with pytest.raises(ValueError, match="PreparedRHS runs the dense streaming kernel"):
            call()


def test_prepared_rhs_int32_guard_and_shape_checks():
    kp = 32768  # 4 * 128^2 * kp = 2^31
    a = packmm.PackedTensor(words=torch.zeros((1, 256, kp), dtype=torch.int8), shape=(256, kp), bits=8)
    bp = packmm.PreparedRHS(plane=torch.zeros((kp, 128), dtype=torch.int8),
                            corr=torch.zeros((8, 128), dtype=torch.int32), shape=(kp, 16), bits=8)
    with pytest.raises(ValueError, match="overflow"):
        packmm.packmm_to_f32(a, bp)
    small = packmm.PreparedRHS(plane=torch.zeros((256, 128), dtype=torch.int8),
                               corr=torch.zeros((8, 128), dtype=torch.int32), shape=(kp, 16), bits=8)
    with pytest.raises(ValueError, match="padded K"):
        packmm.packmm_to_f32(a, small)
    other = packmm.PreparedRHS(plane=small.plane, corr=small.corr, shape=(200, 16), bits=8)
    with pytest.raises(ValueError, match="contraction"):
        packmm.packmm_to_f32(a, other)


def test_out_cols_with_digits_out_raises():
    qa, qb = operands(3, 256, 128, 16, 8, 8, 8, 0)
    a, bp, _, _ = _pair(qa, qb, 8, 8, prepared=True)
    b = digits.digit_pack(torch.from_numpy(qb), 8)
    with pytest.raises(ValueError, match="out_cols"):
        packmm.packmm_signed_plain(a, bp, 4, "digits", out_cols=16)
    with pytest.raises(ValueError, match="out_cols"):
        packmm.packmm_plain(a, b, 4, out_form="digits", out_cols=16)


def test_cpu_path_launches_no_kernel():
    qa, qb = operands(4, 256, 128, 16, 8, 8, 8, 0)
    a, bp, _, _ = _pair(qa, qb, 8, 8, prepared=True)
    b = digits.digit_pack(torch.from_numpy(qb), 8)
    before = (packmm.LAUNCHES, packmm.SIGNED_LAUNCHES)
    packmm.packmm_to_packed(a, bp, 8, out_cols=16)
    packmm.packmm_to_packed(a, b, 2)
    assert (packmm.LAUNCHES, packmm.SIGNED_LAUNCHES) == before


# -- the kernel sweep -----------------------------------------------------


def test_sweep_rows_match_jax_bench_shape():
    """``kernel_sweep.shape_case`` draws and packs as JAX's ``bench_shape``
    does, and its timed call gives JAX's output on the same rng."""
    port_rng, jax_rng = np.random.default_rng(0), np.random.default_rng(0)
    for bits in BITS:
        case = kernel_sweep.shape_case(256, 256, 16, bits, port_rng, "cpu")
        qa = jax_rng.integers(0, 1 << bits, (256, 256)).astype(np.int32)
        qb = jax_rng.integers(0, 1 << bits, (256, 16)).astype(np.int32)
        a = jpackmm.pack_rows(jnp.asarray(qa), bits)
        b = jdigits.digit_pack(jnp.asarray(qb), bits)
        oc = None
        if jpackmm.packed_signed(bits):
            b, oc = jpackmm.prepare_rhs(b), 16
        assert case.out_cols == oc
        _same(case.run(), jpackmm.packmm_to_packed(a, b, bits, out_cols=oc))
        _same(case.plain(), jpackmm.packmm_to_packed(a, b, bits, out_cols=oc))


def test_sweep_figures_follow_the_jax_draw_order(monkeypatch):
    monkeypatch.setattr(kernel_sweep, "MK", (256,))
    cases = kernel_sweep.figure_cases("8a", np.random.default_rng(0), "cpu")
    rng = np.random.default_rng(0)
    assert [(c.bits, c.M, c.N) for c in cases] == [(b, 256, n) for b in BITS for n in (16, 32, 64)]
    for c in cases:
        qa = rng.integers(0, 1 << c.bits, (256, 256))
        qb = rng.integers(0, 1 << c.bits, (256, c.N))
        np.testing.assert_array_equal(packmm.unpack_rows(c.a).numpy(), qa)
        b = c.b if not isinstance(c.b, packmm.PreparedRHS) else None
        if b is not None:
            np.testing.assert_array_equal(digits.digit_unpack(b).numpy(), qb)
        else:
            np.testing.assert_array_equal(c.b.plane.numpy()[:256, : c.N], (qb - 128).astype(np.int8))
    cases = kernel_sweep.figure_cases("8c", np.random.default_rng(0), "cpu")
    assert [c.N for c in cases] == [16, 32, 64, 128, 256, 512, 1024] and {c.bits for c in cases} == {1}
    cases = kernel_sweep.figure_cases("int8", np.random.default_rng(0), "cpu")
    rng = np.random.default_rng(0)
    for c in cases:
        np.testing.assert_array_equal(c.a.numpy(), rng.integers(0, 2, (256, 256)))
        np.testing.assert_array_equal(c.b.numpy(), rng.integers(0, 16, (256, c.N)))
        np.testing.assert_array_equal(c.plain().numpy(), c.a.numpy().astype(np.int64) @ c.b.numpy())
    with pytest.raises(ValueError, match="unknown figure"):
        kernel_sweep.figure_cases("9z", np.random.default_rng(0), "cpu")


def test_sweep_profile_case_matches_jax():
    """The profile shapes' A is drawn in the word domain, as JAX's
    ``bench_profile_shape`` does (here at M = 1024, K = 256)."""
    case = kernel_sweep.profile_case(1024, 256, 16, 1, np.random.default_rng(0), "cpu")
    rng = np.random.default_rng(0)
    w = rng.integers(-(2**31), 2**31, (1, 1024 // 32, 256), dtype=np.int64).astype(np.int32)
    qb = rng.integers(0, 2, (256, 16)).astype(np.int32)
    np.testing.assert_array_equal(case.a.words.numpy(), w)
    ja = jpackmm.PackedTensor(words=jnp.asarray(w), shape=(1024, 256), bits=1)
    ref = jpackmm.packmm_to_packed(ja, jdigits.digit_pack(jnp.asarray(qb), 1), 1)
    got = case.run()
    _same(got, ref)
    # the first 256 rows alone give the first 256 rows' words
    np.testing.assert_array_equal(case.plain(256).words.numpy(), np.asarray(ref.words)[:, :8])
    with pytest.raises(ValueError, match="1-bit"):
        kernel_sweep.profile_case(1024, 256, 16, 2, np.random.default_rng(0), "cpu")


def test_sweep_row_and_csv_match_jax(tmp_path):
    case = kernel_sweep.shape_case(256, 256, 16, 1, np.random.default_rng(0), "cpu")
    row = case.row(0.0123456)
    assert row == dict(bits=1, M=256, K=256, N=16, us=12.35,
                       tflops=round(2 * 256 * 256 * 16 / 12.3456e-6 / 1e12, 3))
    rows = [row, dict(row, N=32, us=7.5, tflops=0.125)]
    metrics.write_csv(str(tmp_path / "port" / "sweep.csv"), rows, list(row))
    jmetrics.write_csv(str(tmp_path / "jax" / "sweep.csv"), rows, list(row))
    got = (tmp_path / "port" / "sweep.csv").read_bytes()
    assert got == (tmp_path / "jax" / "sweep.csv").read_bytes()
    assert got.splitlines()[0] == b"bits,M,K,N,us,tflops"


def test_sweep_timing_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        kernel_sweep.run_figure("8a")
    with pytest.raises(RuntimeError, match="CUDA"):
        kernel_sweep.main(["--figure", "int8"])
    case = kernel_sweep.shape_case(256, 256, 16, 1, np.random.default_rng(0), "cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        kernel_sweep.time_cases([case])
