"""The bit-serial path of the PyTorch port against the JAX package.

``bitmm_to_bits`` / ``bitmm_to_int`` (their plain version here, on the
CPU) against the JAX kernel ``_bitmm`` in Pallas interpret mode and
``tests/golden.py``; the zero-tile map builder, the batcher's ``bit_A``,
the BitTensor forwards, the
``QGTCEngine(fmt='bits')`` step engine and the CLI's ``--fmt bits``
against their JAX counterparts and the port's digit path. Inputs come
from NumPy seeds; weights are the same integer levels in both packages.
Tolerance: exact equality.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgtc_ppopp22_tpu import graph as jgraph
from qgtc_ppopp22_tpu.models import qmodels as jqmodels
from qgtc_ppopp22_tpu.ops import bitgemm as jbitgemm
from qgtc_ppopp22_tpu.ops.bitpack import pack_bits as jpack_bits
from qgtc_ppopp22_tpu.runtime import QGTCEngine as JaxEngine
from qgtc_ppopp22_tpu_torch import cli, graph
from qgtc_ppopp22_tpu_torch.models import qmodels
from qgtc_ppopp22_tpu_torch.ops import bitgemm, packmm
from qgtc_ppopp22_tpu_torch.ops.bitpack import BitTensor, pack_bits, unpack_bits
from qgtc_ppopp22_tpu_torch.runtime import EpochStats, QGTCEngine
from tests.golden import bitmm_np
from torch_cases import edge_operands
from torch_threads import one_thread  # noqa: F401  (an autouse fixture: one torch thread)


def _levels(rng, shape, bits, density=1.0):
    q = rng.integers(0, 1 << bits, shape)
    if density < 1.0:
        q = q * (rng.random(shape) < density)
    return q.astype(np.int32)


def _both(q, bits):
    """The same levels packed by the port and by JAX."""
    return pack_bits(torch.from_numpy(q), bits), jpack_bits(jnp.asarray(q), bits)


def _jmap(tm):
    return jbitgemm.TileMap(kidx=jnp.asarray(tm.kidx.numpy()), kcnt=jnp.asarray(tm.kcnt.numpy()),
                            tile_m=tm.tile_m, tile_k=tm.tile_k)


def _assert_bits_equal(got: BitTensor, ref):
    assert got.shape == tuple(ref.shape) and got.bits == ref.bits
    np.testing.assert_array_equal(got.planes.numpy().view(np.uint32), np.asarray(ref.planes))


# -- the GEMM ---------------------------------------------------------------


@pytest.mark.parametrize(
    "a_bits,b_bits,out_bits",
    [(1, 2, 2), (1, 1, 1), (2, 2, 2), (3, 5, 4), (4, 4, 4), (8, 8, 8), (1, 8, 2)],
)
def test_bitmm_to_bits_matches_jax_and_golden(a_bits, b_bits, out_bits):
    rng = np.random.default_rng(a_bits * 10 + b_bits)
    M, K, N = 300, 520, 40  # ragged: pads to 512 x 768 x 256
    qa, qb = _levels(rng, (M, K), a_bits), _levels(rng, (K, N), b_bits)
    (a, ja), (b, jb) = _both(qa, a_bits), _both(qb, b_bits)
    got = bitgemm.bitmm_to_bits(a, b, out_bits)
    _assert_bits_equal(got, jbitgemm.bitmm_to_bits(ja, jb, out_bits))
    np.testing.assert_array_equal(unpack_bits(got).numpy(), bitmm_np(qa, qb, a_bits, b_bits, out_bits))


@pytest.mark.parametrize("a_bits,b_bits", [(1, 2), (2, 2), (8, 8), (3, 5)])
def test_bitmm_to_int_matches_jax_and_golden(a_bits, b_bits):
    rng = np.random.default_rng(a_bits + b_bits)
    M, K, N = 130, 260, 20
    qa, qb = _levels(rng, (M, K), a_bits), _levels(rng, (K, N), b_bits)
    (a, ja), (b, jb) = _both(qa, a_bits), _both(qb, b_bits)
    got = bitgemm.bitmm_to_int(a, b)
    assert got.shape == (M, N) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jbitgemm.bitmm_to_int(ja, jb)))
    np.testing.assert_array_equal(got.numpy(), bitmm_np(qa, qb, a_bits, b_bits, None))


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_bitmm_requant_edges(bits):
    """Row i of the product is i in column 0, so the requantizer sees 0,
    2^b - 1, 2^b (wraps to 0) and 2^b + 1 (clamps to 2^b - 1)."""
    qa, qb = edge_operands(bits, 0)
    (a, ja), (b, jb) = _both(qa, 1), _both(qb, bits)
    got = bitgemm.bitmm_to_bits(a, b, bits)
    _assert_bits_equal(got, jbitgemm.bitmm_to_bits(ja, jb, bits))
    col0 = unpack_bits(got)[:, 0].numpy()
    ub = 1 << bits
    assert col0[ub - 1] == ub - 1 and col0[ub] == 0 and col0[ub + 1] == ub - 1


def test_bitmm_chains_as_either_operand():
    rng = np.random.default_rng(7)
    M, K, N, H = 64, 96, 48, 32
    qa, qb, qw = _levels(rng, (M, K), 2), _levels(rng, (K, N), 2), _levels(rng, (N, H), 2)
    qs = _levels(rng, (M, M), 1)
    (a, ja), (b, jb), (w, jw), (s, js) = (_both(q, bits) for q, bits in ((qa, 2), (qb, 2), (qw, 2), (qs, 1)))
    ab, jab = bitgemm.bitmm_to_bits(a, b, 2), jbitgemm.bitmm_to_bits(ja, jb, 2)
    ab_np = bitmm_np(qa, qb, 2, 2, 2)
    rhs = bitgemm.bitmm_to_bits(s, ab, 2)  # ab as the right operand
    _assert_bits_equal(rhs, jbitgemm.bitmm_to_bits(js, jab, 2))
    np.testing.assert_array_equal(unpack_bits(rhs).numpy(), bitmm_np(qs, ab_np, 1, 2, 2))
    lhs = bitgemm.bitmm_to_bits(ab, w, 2)  # ab as the left operand
    _assert_bits_equal(lhs, jbitgemm.bitmm_to_bits(jab, jw, 2))
    np.testing.assert_array_equal(unpack_bits(lhs).numpy(), bitmm_np(ab_np, qw, 2, 2, 2))


def _block_diagonal(rng, n=1024, block=256):
    qa = np.zeros((n, n), np.int32)
    for s in range(0, n, block):
        qa[s:s + block, s:s + block] = rng.integers(0, 2, (block, block))
    return qa


def test_bitmm_sparse_matches_dense_and_jax():
    rng = np.random.default_rng(3)
    qa, qb = _block_diagonal(rng), _levels(rng, (1024, 16), 2)
    (a, ja), (b, jb) = _both(qa, 1), _both(qb, 2)
    tm = bitgemm.build_tile_map(a)
    sparse = bitgemm.bitmm_to_bits(a, b, 2, tile_map=tm)
    assert torch.equal(sparse.planes, bitgemm.bitmm_to_bits(a, b, 2).planes)
    _assert_bits_equal(sparse, jbitgemm.bitmm_to_bits(ja, jb, 2, tile_map=_jmap(tm)))
    got_f = bitgemm.bitmm_to_int(a, b, tile_map=tm)
    np.testing.assert_array_equal(got_f.numpy(), bitmm_np(qa, qb, 1, 2, None))


def test_bitmm_tile_map_masks_unlisted_tiles():
    """A hand-made map that omits an occupied tile, and a row tile with
    kcnt 0: the result is what the JAX kernel computes (the listed tiles
    only), which is not the dense product."""
    rng = np.random.default_rng(4)
    qa, qb = _levels(rng, (1024, 1024), 1, 0.05), _levels(rng, (1024, 40), 2)
    (a, ja), (b, jb) = _both(qa, 1), _both(qb, 2)
    full = bitgemm.build_tile_map(a)
    assert full.kcnt.tolist() == [2, 2]  # 512 x 512 tiles, all occupied
    kcnt = full.kcnt.clone()
    kcnt[0], kcnt[1] = 1, 0
    hand = dataclasses.replace(full, kcnt=kcnt)
    got = bitgemm.bitmm_to_bits(a, b, 2, tile_map=hand)
    _assert_bits_equal(got, jbitgemm.bitmm_to_bits(ja, jb, 2, tile_map=_jmap(hand)))
    assert not torch.equal(got.planes, bitgemm.bitmm_to_bits(a, b, 2).planes)
    got_f = bitgemm.bitmm_to_int(a, b, tile_map=hand)
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(jbitgemm.bitmm_to_int(ja, jb, tile_map=_jmap(hand))))
    assert not torch.equal(got_f, bitgemm.bitmm_to_int(a, b)) and not got_f[512:].any()


@pytest.mark.parametrize("tiles", [(None, None), (256, 256), (512, 256), (256, 512)])
@pytest.mark.parametrize("bits", [1, 3])
def test_build_tile_map_matches_jax(tiles, bits):
    rng = np.random.default_rng(bits)
    q = _levels(rng, (1024, 1536), bits, 0.02)
    q[512:768] = 0  # an empty row band: kcnt 0 at 256-row tiles
    q[:, 256:768] = 0  # empty K tiles: a clamped tail in every row tile
    a, ja = _both(q, bits)
    tm = bitgemm.build_tile_map(a, *tiles)
    jtm = jbitgemm.build_tile_map(ja, *tiles)
    assert (tm.tile_m, tm.tile_k) == (jtm.tile_m, jtm.tile_k)
    assert tm.kidx.dtype == tm.kcnt.dtype == torch.int32
    np.testing.assert_array_equal(tm.kidx.numpy(), np.asarray(jtm.kidx))
    np.testing.assert_array_equal(tm.kcnt.numpy(), np.asarray(jtm.kcnt))
    assert bitgemm.zero_tile_stats(a, *tiles) == jbitgemm.zero_tile_stats(ja, *tiles)


@pytest.mark.parametrize("shape", [(300, 520), (2560, 2560), (256, 256), (512, 128)])
def test_lhs_tiles_matches_jax(shape):
    a, ja = _both(np.ones(shape, np.int32), 1)
    assert bitgemm.lhs_tiles(a) == jbitgemm.lhs_tiles(ja)
    assert bitgemm.flops_convention(*shape, 16) == jbitgemm.flops_convention(*shape, 16)


def test_zero_tile_stats():
    qa = np.zeros((1024, 1024), np.int32)
    qa[:256, :512] = 1
    stats = bitgemm.zero_tile_stats(pack_bits(torch.from_numpy(qa), 1), tile_m=256, tile_k=512)
    assert stats == {"total": 8, "processed": 1, "ratio": 1 / 8}


def _bad_cases():
    a = pack_bits(torch.ones(300, 520, dtype=torch.int32), 1)
    b = pack_bits(torch.ones(520, 40, dtype=torch.int32), 2)
    short = pack_bits(torch.ones(500, 40, dtype=torch.int32), 2)
    tm = bitgemm.build_tile_map(a, 256, 256)  # the kernel picks 512 x 256 here
    return {
        "contraction": ((a, short, 2, None), "contraction mismatch"),
        "padded K": ((a, dataclasses.replace(b, planes=b.planes[:, :16]), 2, None), "padded K mismatch"),
        "tile sizes": ((a, b, 2, tm), "tile_map built for"),
        "out_bits": ((a, b, 9, None), "out_bits must be in"),
    }


@pytest.mark.parametrize("case", ["contraction", "padded K", "tile sizes", "out_bits"])
def test_bitmm_rejects_what_the_kernel_cannot_take(case):
    args, match = _bad_cases()[case]
    with pytest.raises(ValueError, match=match):
        bitgemm.bitmm_to_bits(*args[:3], tile_map=args[3])


def test_plain_is_the_cpu_path():
    rng = np.random.default_rng(1)
    a = pack_bits(torch.from_numpy(_levels(rng, (256, 512), 2)), 2)
    b = pack_bits(torch.from_numpy(_levels(rng, (512, 16), 2)), 2)
    before = bitgemm.LAUNCHES
    assert torch.equal(bitgemm.bitmm_to_bits(a, b, 2).planes, bitgemm.bitmm_plain(a, b, 2).planes)
    assert torch.equal(bitgemm.bitmm_to_int(a, b), bitgemm.bitmm_plain(a, b, None))
    assert bitgemm.LAUNCHES == before  # the CPU runs no kernel


# -- formats, batcher, models ---------------------------------------------------


def test_batcher_bit_a_matches_jax():
    kw = dict(bit_width=2, seed=5, bucket_rows=256, partition_method="bfs")
    it = graph.ClusterBatcher(graph.synthesize("Proteins", scale=0.02, seed=5), 4, 2, **kw)
    jit = jgraph.ClusterBatcher(jgraph.synthesize("Proteins", scale=0.02, seed=5), 4, 2, **kw)
    for b, jb in zip(it.batches, jit.batches):
        assert "bit_A" not in vars(b)  # packed only when a bits engine asks
        assert b.bit_A.shape == tuple(jb.bit_A.shape) == (b.padded_nodes,) * 2
        _assert_bits_equal(b.bit_A, jb.bit_A)
        assert vars(b)["bit_A"] is b.bit_A  # and then kept


@pytest.mark.parametrize("bits", [1, 2, 4])
def test_unpack_rows_np_inverts_pack_rows_np(bits):
    q = _levels(np.random.default_rng(bits), (300, 200), bits)
    levels = packmm.unpack_rows_np(packmm.pack_rows_np(q, bits), bits)
    assert levels.shape == (512, 256)
    np.testing.assert_array_equal(levels[:300, :200], q)
    assert not levels[300:].any() and not levels[:, 200:].any()


@pytest.mark.parametrize("tile_map", [False, True])
@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("model", ["gcn", "gin"])
def test_forward_bits_matches_jax_and_golden(model, bits, tile_map):
    rng = np.random.default_rng(bits + 3 * (model == "gin"))
    n, feat, hidden, ncls = 768, 128, 16 if model == "gcn" else 64, 40
    qa = (rng.random((n, n)) < 0.02).astype(np.int32)  # asymmetric, not banded
    qa[:256, 256:] = 0  # two empty tiles of 256 x 256 (the tiles at n = 768)
    qx = rng.integers(0, 1 << bits, (n, feat)).astype(np.int32)
    dims = [feat, hidden, hidden, ncls]
    qws = [rng.integers(0, 1 << bits, (dims[i], dims[i + 1])).astype(np.int32) for i in range(3)]
    (a, ja), (x, jx) = _both(qa, 1), _both(qx, bits)
    ws, jws = zip(*(_both(w, bits) for w in qws))
    tm = bitgemm.build_tile_map(a) if tile_map else None
    if tile_map:
        assert tm.kcnt.tolist() == [1, 3, 3]
    fwd = qmodels.qgcn_forward if model == "gcn" else qmodels.qgin_forward
    got = fwd(a, x, ws, bits, tile_map=tm)
    jfwd = jqmodels.qgcn_forward if model == "gcn" else jqmodels.qgin_forward
    ref = jfwd(ja, jx, list(jws), bits, tile_map=_jmap(tm) if tile_map else None)
    assert got.shape == (n, ncls) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    golden = (jqmodels.qgcn_golden if model == "gcn" else jqmodels.qgin_golden)(qa, qx, qws, bits, bits)
    np.testing.assert_array_equal(got.numpy(), golden)
    assert torch.equal(fwd(a, x, ws, bits, plain=True, tile_map=tm), got)


def test_forward_bits_refuses_shifts_and_digit_tile_maps():
    """Shifts stay refused on bit planes; a digit-path tile map, once
    refused, now skips the same zero tiles as the bit path's."""
    rng = np.random.default_rng(0)
    qa = (rng.random((512, 512)) < 0.05).astype(np.int32)
    qa[256:, :256] = 0
    a = pack_bits(torch.from_numpy(qa), 1)
    x = pack_bits(torch.from_numpy(_levels(rng, (512, 128), 2)), 2)
    ws = [pack_bits(torch.from_numpy(_levels(rng, s, 2)), 2) for s in [(128, 16), (16, 16), (16, 40)]]
    with pytest.raises(NotImplementedError, match="scaled requant"):
        qmodels.qgcn_forward(a, x, ws, 2, shifts=[1, 1, 1, 1, 1])
    pa = packmm.PackedTensor(torch.from_numpy(packmm.pack_rows_np(qa, 1)), (512, 512), 1)
    dws = qmodels.pack_weights([torch.from_numpy(unpack_bits(w).numpy().astype(np.float32)) for w in ws], 2)
    from qgtc_ppopp22_tpu_torch.ops.digits import to_digit_tensor

    # the same zero tiles skipped by the packed digit path (K2) and the bit path (K6)
    ptm = packmm.build_tile_map_packed(pa, 256, 256)
    assert ptm.kcnt.tolist() == [2, 1]
    got = qmodels.qgcn_forward(pa, to_digit_tensor(x), dws, 2, tile_map=ptm)
    assert torch.equal(got, qmodels.qgcn_forward(pa, to_digit_tensor(x), dws, 2))
    assert torch.equal(got, qmodels.qgcn_forward(a, x, ws, 2, tile_map=bitgemm.build_tile_map(a)))


# -- the engine and the CLI ----------------------------------------------------------


@pytest.fixture(scope="module")
def small():
    kw = dict(bit_width=2, seed=5, bucket_rows=256, partition_method="bfs")
    ds = graph.synthesize("Proteins", scale=0.02, seed=5)
    jds = jgraph.synthesize("Proteins", scale=0.02, seed=5)
    return ds, graph.ClusterBatcher(ds, 4, 2, **kw), jds, jgraph.ClusterBatcher(jds, 4, 2, **kw)


def _engine(it, ds, model, fmt, float_weights, **kw):
    eng = QGTCEngine(feat_dim=it.feat_dim, num_classes=ds.num_classes, model=model, bit_width=2,
                     fmt=fmt, device="cpu", **kw)
    eng.weights = qmodels.weights_from_jax(float_weights, 2, fmt=fmt)
    return eng


@pytest.mark.parametrize("model", ["gcn", "gin"])
def test_engine_bits_matches_jax_and_digits(small, model):
    ds, it, jds, jit = small
    je = JaxEngine(feat_dim=jit.feat_dim, num_classes=jds.num_classes, model=model, bit_width=2,
                   fmt="bits", seed=1)
    fw = [np.asarray(w) for w in je.float_weights]
    bits, dig = _engine(it, ds, model, "bits", fw), _engine(it, ds, model, "digits", fw)
    assert all(isinstance(w, BitTensor) for w in bits.weights)
    a, _, tm = bits.put_batch(it.batches[0])
    assert tm is None
    assert isinstance(a, BitTensor) and a.bits == 1
    outs = bits.forward_all(it)
    for b, jb, out in zip(it.batches, jit.batches, outs):
        ref = np.asarray(je.forward_batch(jb))
        assert out.shape == (b.padded_nodes, ds.num_classes)
        np.testing.assert_array_equal(out.numpy(), ref)
        np.testing.assert_array_equal(dig.forward_batch(b).numpy(), ref)
        assert torch.equal(bits.forward_batch(b, plain=True), out)
    assert bits.evaluate(it, ds.labels) == je.evaluate(jit, jds.labels) == dig.evaluate(it, ds.labels)


@pytest.mark.parametrize("resident", [False, True])
def test_engine_bits_run_epochs(small, resident):
    ds, it, _, _ = small
    eng = QGTCEngine(feat_dim=it.feat_dim, num_classes=ds.num_classes, fmt="bits", seed=2,
                     device="cpu")
    st = eng.run_epochs(it, n_epochs=2, resident=resident)
    assert isinstance(st, EpochStats) and st.n_batches == 2 and st.avg_ms > 0
    assert eng.evaluate_f1(it, np.eye(ds.num_classes)[ds.labels]).keys() == {"f1_micro", "f1_macro"}


def test_engine_bits_refuses_mega_and_zerotile_jump(small):
    """Mega mode stays refused with fmt='bits'; zerotile_jump=True, once
    refused, is taken and passes no map."""
    ds, it, _, _ = small
    eng = QGTCEngine(feat_dim=it.feat_dim, num_classes=ds.num_classes, fmt="bits", device="cpu")
    with pytest.raises(ValueError, match="mega mode requires fmt='digits'"):
        eng.run_epochs_mega(it, n_epochs=1)
    # as the JAX bits engine (runtime.py:158-163): zerotile_jump=True is
    # taken and no map is passed, so the logits are the engine's own
    zj = QGTCEngine(feat_dim=it.feat_dim, num_classes=ds.num_classes, fmt="bits", device="cpu",
                    zerotile_jump=True)
    assert zj.put_batch(it.batches[0])[2] is None
    assert torch.equal(zj.forward_batch(it.batches[0]), eng.forward_batch(it.batches[0]))
    assert zj.run_epochs(it, n_epochs=1).n_batches == len(it)
    with pytest.raises(ValueError, match="unknown fmt"):
        QGTCEngine(feat_dim=it.feat_dim, num_classes=ds.num_classes, fmt="words", device="cpu")


def _toy_npz(path):
    rng = np.random.default_rng(0)
    np.savez(path / "toy.npz", src_li=rng.integers(0, 600, 3000), dst_li=rng.integers(0, 600, 3000))


@pytest.mark.parametrize("gin", [False, True])
def test_cli_fmt_bits_runs_on_cpu(tmp_path, monkeypatch, capsys, gin):
    _toy_npz(tmp_path)
    monkeypatch.chdir(tmp_path)
    rc = cli.main(["--dataset", "toy", "--data-dir", str(tmp_path), "--psize", "4",
                   "--batch-size", "2", "--n-epochs", "2", "--device", "cpu", "--use_QGTC",
                   "--fmt", "bits", "--eval-accuracy", *(["--run_GIN"] if gin else [])])
    assert rc == 0
    out = capsys.readouterr().out
    record = json.loads(out.strip().splitlines()[-1])
    assert record["fmt"] == "bits" and record["engine"] == "qgtc-step" and record["avg_epoch_ms"] > 0
    assert record["model"] == ("gin" if gin else "gcn") and 0 <= record["accuracy"] <= 1


@pytest.mark.parametrize("argv,message", [
    (["--fmt", "bits", "--mode", "mega"], "mega mode requires fmt='digits'"),
    (["--fmt", "bits", "--mode", "fused"], "fused mode requires fmt='digits'"),
    (["--fmt", "bits", "--regular"], "--fmt is the quantized engine's option"),
])
def test_cli_fmt_bits_refusals(capsys, argv, message):
    with pytest.raises(SystemExit) as exc:
        cli.main(argv)
    assert exc.value.code == 2 and message in capsys.readouterr().err
