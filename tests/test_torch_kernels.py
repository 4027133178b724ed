"""The CUDA kernels against their plain PyTorch versions, on the card.

A CUDA kernel has no CPU mode, so every test here needs a CUDA device
and skips without one. On a GPU machine (which has no jax; the
environment variable keeps ``tests/conftest.py`` from importing it)::

    QGTC_TEST_BACKEND=cuda python -m pytest tests/test_torch_kernels.py -q

Tolerance: exact equality, padded outputs included.
"""

import numpy as np
import pytest
import torch

from qgtc_ppopp22_tpu_torch.graph import ClusterBatcher, synthesize
from qgtc_ppopp22_tpu_torch.ops import digitmm, digits, packmm
from qgtc_ppopp22_tpu_torch.runtime import QGTCEngine
from torch_cases import edge_operands, operands  # tests/ is on sys.path

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
    if isinstance(want, digits.DigitTensor):
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
    cpu = QGTCEngine(feat_dim=it.feat_dim, num_classes=ds.num_classes, model=model, seed=4)
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
