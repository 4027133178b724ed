"""Format parity of the PyTorch port against the JAX package.

Every container the port builds (bit planes, digit planes, M-packed
words) must equal the JAX one element for element, and the scalar
quantizers must agree with JAX and with ``tests/golden.py`` exactly,
including the reference's edge rules (negatives -> 1, ``2^b`` wraps).
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qgtc_ppopp22_tpu.ops.quantize  # noqa: F401
from qgtc_ppopp22_tpu.ops import bitpack as jbitpack
from qgtc_ppopp22_tpu.ops import digits as jdigits
from qgtc_ppopp22_tpu.ops import packmm as jpackmm
from qgtc_ppopp22_tpu_torch.ops import bitpack, digits, packmm, quantize
from tests.golden import quantize_np, requantize_np
from torch_threads import one_thread  # noqa: F401  (an autouse fixture: one torch thread)

# the JAX ops package re-exports a function under the module's name
jquantize = sys.modules["qgtc_ppopp22_tpu.ops.quantize"]

BITS = [1, 2, 4, 8]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _j(x):
    """A JAX array as int32 NumPy (uint32 planes compared by bit pattern)."""
    a = np.asarray(x)
    return a.view(np.int32) if a.dtype == np.uint32 else a


@pytest.mark.parametrize("bits", BITS)
def test_quantize_matches_jax_and_golden(bits):
    ub = float(1 << bits)
    rng = np.random.default_rng(bits)
    edges = [-3.0, -0.5, -0.0, 0.0, 0.5, 1.5, 2.5, ub - 0.5, ub, ub + 0.5, ub + 7]
    x = np.concatenate([edges, rng.uniform(-2, ub + 2, 500)]).astype(np.float32)
    port = quantize.quantize(_t(x), bits)
    assert port.dtype == torch.int32
    np.testing.assert_array_equal(port.numpy(), np.asarray(jquantize.quantize(jnp.asarray(x), bits)))
    np.testing.assert_array_equal(port.numpy(), quantize_np(x, bits))
    # negatives go to level 1, ub survives (wraps only when packed)
    assert port[0] == 1 and port[1] == 1 and port[8] == ub


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("shift", [0, 2])
def test_requantize_edges(bits, shift):
    ub = 1 << bits
    base = np.array([ub - 1, ub, ub + 1, 0, 1, 3 * ub, -1, -5], np.int64)
    acc = np.concatenate([base << shift, (base << shift) + (1 << shift) - 1, [-1, -7]]).astype(np.int32)
    port = quantize.requantize(_t(acc), bits, shift)
    np.testing.assert_array_equal(port.numpy(), np.asarray(jquantize.requantize(jnp.asarray(acc), bits, shift)))
    np.testing.assert_array_equal(port.numpy(), requantize_np(acc, bits, shift))
    wrapped = quantize.requantize_wrapped(_t(acc), bits, shift).numpy()
    np.testing.assert_array_equal(
        wrapped, np.asarray(jquantize.requantize_wrapped(jnp.asarray(acc), bits, shift))
    )
    # the quirk: > ub clamps to ub - 1, == ub passes and wraps to 0,
    # negatives (after an arithmetic shift) clamp to 1
    assert list(wrapped[:8]) == [ub - 1, 0, ub - 1, 0, 1, ub - 1, 1, 1]
    assert list(wrapped[-2:]) == [1, 1]


def test_dequantize_levels():
    q = _t(np.array([[0, 3], [255, 7]], np.int32))
    out = quantize.dequantize_levels(q)
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), q.numpy().astype(np.float32))


def test_quantize_rejects_bad_bits():
    with pytest.raises(ValueError):
        quantize.quantize(torch.zeros(2), 9)
    with pytest.raises(ValueError):
        quantize.requantize(torch.zeros(2, dtype=torch.int32), 0)


@pytest.mark.parametrize("bits", BITS + [3])
def test_pack_bits_matches_jax(bits):
    rng = np.random.default_rng(10 + bits)
    q = rng.integers(0, (1 << bits) + 1, (300, 150)).astype(np.int32)  # 2^b wraps
    port = bitpack.pack_bits(_t(q), bits)
    ref = jbitpack.pack_bits(jnp.asarray(q), bits)
    assert port.planes.dtype == torch.int32
    assert port.planes.shape == (bits, 256 * 2 // 32, 256) == ref.planes.shape
    np.testing.assert_array_equal(port.planes.numpy(), _j(ref.planes))
    np.testing.assert_array_equal(bitpack.pack_bits_np(q, bits).planes.numpy(), _j(ref.planes))
    np.testing.assert_array_equal(bitpack.unpack_bits(port).numpy(), np.asarray(jbitpack.unpack_bits(ref)))
    np.testing.assert_array_equal(bitpack.unpack_bits(port).numpy(), q & ((1 << bits) - 1))
    np.testing.assert_array_equal(bitpack.to_digits(port).numpy(), np.asarray(jbitpack.to_digits(ref)))
    assert port.padded_rows == 512 and port.padded_cols == 256 and port.nbytes() == ref.nbytes()


@pytest.mark.parametrize("bits", BITS)
def test_val2bit_bit2val_match_jax(bits):
    x = np.random.default_rng(bits).uniform(-1, (1 << bits) + 1, (70, 90)).astype(np.float32)
    port = bitpack.val2bit(_t(x), bits)
    ref = jbitpack.val2bit(jnp.asarray(x), bits)
    np.testing.assert_array_equal(port.planes.numpy(), _j(ref.planes))
    np.testing.assert_array_equal(bitpack.bit2val(port).numpy(), np.asarray(jbitpack.bit2val(ref)))


@pytest.mark.parametrize("bits", BITS)
def test_to_digit_tensor_matches_jax(bits):
    q = np.random.default_rng(bits).integers(0, 1 << bits, (260, 130)).astype(np.int32)
    port = digits.to_digit_tensor(bitpack.pack_bits_np(q, bits))
    ref = jdigits.to_digit_tensor(jbitpack.pack_bits(jnp.asarray(q), bits))
    assert port.digits.dtype == torch.int8 and port.digits.shape == (bitpack.num_digits(bits), 384, 256)
    np.testing.assert_array_equal(port.digits.numpy(), np.asarray(ref.digits))
    assert port.shape == ref.shape and port.bits == ref.bits


@pytest.mark.parametrize("bits", BITS)
def test_digit_pack_matches_jax(bits):
    q = np.random.default_rng(bits).integers(0, (1 << bits) + 1, (200, 70)).astype(np.int32)
    port = digits.digit_pack(_t(q), bits)
    ref = jdigits.digit_pack(jnp.asarray(q), bits)
    np.testing.assert_array_equal(port.digits.numpy(), np.asarray(ref.digits))
    np.testing.assert_array_equal(digits.digit_unpack(port).numpy(), np.asarray(jdigits.digit_unpack(ref)))
    np.testing.assert_array_equal(digits.digit_unpack(port).numpy(), q & ((1 << bits) - 1))
    assert port.padded_rows == 256 and port.padded_cols == 128


@pytest.mark.parametrize("bits", BITS + [3, 5])
def test_pack_rows_matches_jax(bits):
    q = np.random.default_rng(bits).integers(0, 1 << bits, (270, 140)).astype(np.int32)
    ref_np = jpackmm.pack_rows_np(q, bits)
    ref = jpackmm.pack_rows(jnp.asarray(q), bits)
    np.testing.assert_array_equal(ref_np, np.asarray(ref.words))
    host = packmm.pack_rows_np(q, bits)
    assert host.dtype == ref_np.dtype
    np.testing.assert_array_equal(host, ref_np)
    dev = packmm.pack_rows(_t(q), bits)
    assert dev.words.dtype == (torch.int8 if bits > 4 else torch.int32)
    np.testing.assert_array_equal(dev.words.numpy(), ref_np)
    np.testing.assert_array_equal(packmm.unpack_rows(dev).numpy(), np.asarray(jpackmm.unpack_rows(ref)))
    np.testing.assert_array_equal(packmm.unpack_rows(dev).numpy(), q)
    assert dev.padded_rows == ref.padded_rows and dev.padded_cols == ref.padded_cols
    assert dev.nbytes() == ref.nbytes()
    # padding decodes to level 0
    lv = packmm.packed_levels(dev).numpy()
    assert not lv[270:].any() and not lv[:, 140:].any()


@pytest.mark.parametrize("f", [1, 2, 4])
def test_pack_rows_group_layout(f):
    """Logical row q*4*gw + 4*i + k of a 256-row group lands in bits
    [8k + f*q, 8k + f*(q+1)) of word row i: set one field per row and
    find it again by that formula."""
    bits = f
    gw = 256 // (32 // f)
    q = np.zeros((512, 256), np.int32)
    rows = np.arange(512)
    q[rows, rows % 256] = 1  # one field per (word row, column)
    words = packmm.pack_rows_np(q, bits)[0].view(np.uint32)
    assert np.count_nonzero(words) == 512
    perm = packmm._group_perm(f)  # [P, gw, 4] -> logical row
    for qq in range(8 // f):
        for i in range(gw):
            for k in range(4):
                for grp in range(2):
                    r = grp * 256 + perm[qq, i, k]
                    word = int(words[grp * gw + i, r % 256])
                    assert word == 1 << (8 * k + f * qq)


def test_build_tile_map_packed_np_matches_jax():
    rng = np.random.default_rng(5)
    q = (rng.random((768, 512)) < 0.01).astype(np.int32)
    q[256:512] = 0
    q[:, 256:] = 0
    w = packmm.pack_rows_np(q, 1)
    kidx, kcnt = packmm.build_tile_map_packed_np(w, 1)
    jk, jc = jpackmm.build_tile_map_packed_np(jpackmm.pack_rows_np(q, 1), 1)
    np.testing.assert_array_equal(kidx, jk)
    np.testing.assert_array_equal(kcnt, jc)
    assert list(kcnt) == [1, 0, 1]


@pytest.mark.parametrize("bits", [1, 2, 3, 4, 5, 8])
def test_field_width_matches_jax(bits):
    assert packmm.field_width(bits) == jpackmm.field_width(bits)
    assert packmm.packed_signed(bits) == jpackmm.packed_signed(bits)
