"""The frozen work and byte counts, against values worked by hand."""

import pytest

from h100bench import work

CFG = {"hidden": 16, "num_layers": 3}


def test_dims():
    assert work.dims(CFG, 128, 40) == [128, 16, 16, 40]


def test_gcn_chain_order():
    assert work.chain_gemms("gcn", 10, [8, 4, 4, 3]) == [
        ("update", 10, 8, 4), ("aggregate", 10, 10, 4),
        ("update", 10, 4, 4), ("aggregate", 10, 10, 4),
        ("update", 10, 4, 3), ("aggregate", 10, 10, 3)]


def test_gin_chain_order():
    assert work.chain_gemms("gin", 10, [8, 4, 4, 3]) == [
        ("aggregate", 10, 10, 8),
        ("update", 10, 8, 4), ("aggregate", 10, 10, 4),
        ("update", 10, 4, 4), ("aggregate", 10, 10, 4),
        ("update", 10, 4, 3)]


@pytest.mark.parametrize("model, ops", [
    # 2 n (8*4 + 10*4 + 4*4 + 10*4 + 4*3 + 10*3) = 20 * 170
    ("gcn", 3400),
    # 2 n (10*8 + 8*4 + 10*4 + 4*4 + 10*4 + 4*3) = 20 * 220
    ("gin", 4400),
])
def test_batch_ops(model, ops):
    assert work.batch_ops(model, 10, [8, 4, 4, 3]) == ops


def test_batch_bytes():
    # A: 100 bits = 12.5 B; X: 10*8 at 2 bits = 20 B; W: (32+16+12) at 2 bits
    # = 15 B; logits: 10*3*4 = 120 B
    assert work.batch_bytes(10, [8, 4, 4, 3], 2) == pytest.approx(12.5 + 20 + 15 + 120)


def test_floor_takes_the_larger_bound():
    peak = {"int8_ops": 1000.0, "hbm_bytes": 100.0}
    assert work.batch_floor_s("gcn", 10, [8, 4, 4, 3], 2, peak) == pytest.approx(3.4)  # ops
    peak = {"int8_ops": 1e6, "hbm_bytes": 1.0}
    assert work.batch_floor_s("gcn", 10, [8, 4, 4, 3], 2, peak) == pytest.approx(167.5)  # bytes


def test_arxiv_epoch_is_operations_bound():
    """C1's order of magnitude: ~2,258 nodes a batch, 75 batches, ~56 G
    operations, ~28 us of floor on the H100."""
    peak = work.peaks("NVIDIA H100 80GB HBM3")
    widths = work.dims(CFG, 128, 40)
    ops = 75 * work.batch_ops("gcn", 2258, widths)
    assert 55e9 < ops < 57e9
    floor = 75 * work.batch_floor_s("gcn", 2258, widths, 2, peak)
    assert floor == pytest.approx(ops / 1979e12)
    assert work.peaks("cpu") is None
