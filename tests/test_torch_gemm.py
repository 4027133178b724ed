"""GEMM parity of the PyTorch port (plain versions, CPU) against the JAX
ops in Pallas interpret mode and ``tests/golden.py::bitmm_np``.

Tolerance: exact equality. Every product is integer arithmetic and the
float32 outputs are integers below 2^24. Test data is asymmetric and
not banded, so a wrong row permutation of the packed A cannot hide, and
it is sparse enough that the requantizer sees values on both sides of
its clamp rather than saturating (``tests/torch_cases.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgtc_ppopp22_tpu.ops import digitmm as jdigitmm
from qgtc_ppopp22_tpu.ops import digits as jdigits
from qgtc_ppopp22_tpu.ops import packmm as jpackmm
from qgtc_ppopp22_tpu_torch.ops import digitmm, digits, packmm
from tests.golden import bitmm_np
from tests.torch_cases import edge_operands, operands

BITS = [1, 2, 4, 8]


def _dt(q, bits):
    return digits.digit_pack(torch.from_numpy(q), bits)


def _pt(q, bits):
    return packmm.PackedTensor(words=torch.from_numpy(packmm.pack_rows_np(q, bits)), shape=q.shape, bits=bits)


def _levels(dt):
    return digits.digit_unpack(dt).numpy()


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("shift", [0, 2])
@pytest.mark.parametrize("mk", [256, 512])
@pytest.mark.parametrize("n", [16, 40, 128])
def test_packmm_to_digits_matches_jax_and_golden(bits, shift, mk, n):
    qa, qb = operands(bits * 1000 + shift * 100 + n, mk, mk, n, bits, bits, bits, shift)
    got = packmm.packmm_to_digits(_pt(qa, bits), _dt(qb, bits), bits, shift=shift)
    ref = jpackmm.packmm_to_digits(
        jpackmm.pack_rows(jnp.asarray(qa), bits), jdigits.digit_pack(jnp.asarray(qb), bits), bits, shift=shift
    )
    # the whole padded container, padding included
    np.testing.assert_array_equal(got.digits.numpy(), np.asarray(ref.digits))
    want = bitmm_np(qa, qb, bits, bits, bits, shift)
    np.testing.assert_array_equal(_levels(got), want)
    ub = 1 << bits
    assert (want == ub - 1).any() and (want < ub - 1).any()  # not saturated


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("shift", [0, 2])
@pytest.mark.parametrize("mk", [256, 512])
@pytest.mark.parametrize("n", [16, 40, 128])
def test_digitmm_to_digits_matches_jax_and_golden(bits, shift, mk, n):
    qa, qb = operands(bits * 1000 + shift * 100 + n + 7, mk, mk, n, bits, bits, bits, shift)
    got = digitmm.digitmm_to_digits(_dt(qa, bits), _dt(qb, bits), bits, shift=shift)
    ref = jdigitmm.digitmm_to_digits(
        jdigits.digit_pack(jnp.asarray(qa), bits), jdigits.digit_pack(jnp.asarray(qb), bits), bits, shift=shift
    )
    np.testing.assert_array_equal(got.digits.numpy(), np.asarray(ref.digits))
    want = bitmm_np(qa, qb, bits, bits, bits, shift)
    np.testing.assert_array_equal(_levels(got), want)
    ub = 1 << bits
    assert (want == ub - 1).any() and (want < ub - 1).any()


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("mk", [256, 512])
@pytest.mark.parametrize("n", [16, 40, 128])
def test_to_f32_matches_jax_and_golden(bits, mk, n):
    qa, qb = operands(bits + mk + n, mk, mk, n, bits, bits, bits, 0)
    want = bitmm_np(qa, qb, bits, bits, None)
    jb = jdigits.digit_pack(jnp.asarray(qb), bits)
    got = packmm.packmm_to_f32(_pt(qa, bits), _dt(qb, bits))
    assert got.dtype == torch.float32 and got.shape == (mk, n)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jpackmm.packmm_to_f32(jpackmm.pack_rows(jnp.asarray(qa), bits), jb))
    )
    got = digitmm.digitmm_to_f32(_dt(qa, bits), _dt(qb, bits))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jdigitmm.digitmm_to_f32(jdigits.digit_pack(jnp.asarray(qa), bits), jb))
    )


@pytest.mark.parametrize("bits", BITS)
def test_to_i32_matches_jax(bits):
    qa, qb = operands(bits, 300, 200, 70, bits, bits, bits, 0)
    want = bitmm_np(qa, qb, bits, bits, None).astype(np.int32)
    got = packmm.packmm_to_i32(_pt(qa, bits), _dt(qb, bits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    got = digitmm.digitmm_to_i32(_dt(qa, bits), _dt(qb, bits))
    np.testing.assert_array_equal(got.numpy(), want)
    jd = jdigitmm.digitmm_to_i32(jdigits.digit_pack(jnp.asarray(qa), bits), jdigits.digit_pack(jnp.asarray(qb), bits))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jd))


@pytest.mark.parametrize("b_bits", [1, 2, 4, 8])
def test_packmm_one_bit_adjacency(b_bits):
    """The slice's pairing: 1-bit A times wider features, ragged shapes."""
    qa, qb = operands(b_bits, 700, 600, 40, 1, b_bits, b_bits, 2)
    got = packmm.packmm_to_digits(_pt(qa, 1), _dt(qb, b_bits), b_bits, shift=2)
    ref = jpackmm.packmm_to_digits(
        jpackmm.pack_rows(jnp.asarray(qa), 1), jdigits.digit_pack(jnp.asarray(qb), b_bits), b_bits, shift=2
    )
    np.testing.assert_array_equal(got.digits.numpy(), np.asarray(ref.digits))
    np.testing.assert_array_equal(_levels(got), bitmm_np(qa, qb, 1, b_bits, b_bits, 2))


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("shift", [0, 2])
def test_requant_edges_in_gemms(bits, shift):
    qa, qb = edge_operands(bits, shift)
    ub = 1 << bits
    acc = qa.sum(axis=1)  # column 0 of A @ B
    assert {ub << shift, (ub + 1) << shift, (ub - 1) << shift} <= set(acc.tolist())
    want = bitmm_np(qa, qb, bits, bits, bits, shift)
    # acc == 2^b passes the clamp and wraps to 0; 2^b + 1 clamps to 2^b - 1
    assert want[ub << shift, 0] == 0 and want[(ub + 1) << shift, 0] == ub - 1
    jb = jdigits.digit_pack(jnp.asarray(qb), bits)
    got = packmm.packmm_to_digits(_pt(qa, bits), _dt(qb, bits), bits, shift=shift)
    ref = jpackmm.packmm_to_digits(jpackmm.pack_rows(jnp.asarray(qa), bits), jb, bits, shift=shift)
    np.testing.assert_array_equal(got.digits.numpy(), np.asarray(ref.digits))
    np.testing.assert_array_equal(_levels(got), want)
    got = digitmm.digitmm_to_digits(_dt(qa, bits), _dt(qb, bits), bits, shift=shift)
    ref = jdigitmm.digitmm_to_digits(jdigits.digit_pack(jnp.asarray(qa), bits), jb, bits, shift=shift)
    np.testing.assert_array_equal(got.digits.numpy(), np.asarray(ref.digits))
    np.testing.assert_array_equal(_levels(got), want)


def test_plain_versions_equal_wrappers_on_cpu():
    qa, qb = operands(1, 300, 300, 50, 2, 2, 2, 1)
    a, b = _pt(qa, 2), _dt(qb, 2)
    assert torch.equal(packmm.packmm_plain(a, b, 2, 1).digits, packmm.packmm_to_digits(a, b, 2, shift=1).digits)
    da = _dt(qa, 2)
    assert torch.equal(digitmm.digitmm_plain(da, b), digitmm.digitmm_to_f32(da, b))


def test_cpu_path_launches_no_kernel():
    qa, qb = operands(2, 256, 256, 16, 1, 2, 2, 0)
    before = (packmm.LAUNCHES, digitmm.LAUNCHES)
    packmm.packmm_to_digits(_pt(qa, 1), _dt(qb, 2), 2)
    digitmm.digitmm_to_f32(_dt(qa, 2), _dt(qb, 2))
    assert (packmm.LAUNCHES, digitmm.LAUNCHES) == before


def test_shape_errors():
    a = _pt(np.ones((256, 200), np.int32), 1)
    with pytest.raises(ValueError, match="contraction"):
        packmm.packmm_to_f32(a, _dt(np.ones((100, 16), np.int32), 2))
    with pytest.raises(ValueError, match="padded K"):
        digitmm.digitmm_to_f32(
            _dt(np.ones((128, 128), np.int32), 2),
            digits.DigitTensor(torch.zeros((1, 256, 128), dtype=torch.int8), (128, 16), 2),
        )


def test_accumulator_guard():
    """8-bit x 8-bit at padded K = 33792 could overflow int32: refused."""
    kp = 33792
    a = digits.DigitTensor(torch.zeros((2, 128, kp), dtype=torch.int8), (128, kp), 8)
    b = digits.DigitTensor(torch.zeros((2, kp, 128), dtype=torch.int8), (kp, 128), 8)
    with pytest.raises(ValueError, match="overflow"):
        digitmm.digitmm_to_f32(a, b)
