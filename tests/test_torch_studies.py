"""The port's study modules (``qgtc_ppopp22_tpu_torch/benchmarks``: run_all,
zero_tile_study, transfer_study, roofline, partition_quality, ring_overlap)
and its last two public functions (``utils/timing.host_bench``,
``parallel.x_digits_np``) against the JAX package, on the CPU: the same
seeded synthetic graphs through both packages' host code, small scales and
partition counts. Tolerance: exact equality of every host-side count (tiles,
chunks, blocks, edge cut, density, skip share, bytes, digit planes); the
roofline's bytes and operations against a count by hand; the engines'
times only finite (the CPU runs the kernels' plain versions).
"""

import math

import numpy as np
import pytest
import torch

from qgtc_ppopp22_tpu import graph as jgraph
from qgtc_ppopp22_tpu import runtime as jruntime
from qgtc_ppopp22_tpu.graph import partition as jpartition
from qgtc_ppopp22_tpu.ops import bitpack as jbitpack
from qgtc_ppopp22_tpu.ops.fused_model import mega_colblock as jmega_colblock
from qgtc_ppopp22_tpu.parallel import x_digits_np as jx_digits_np
from qgtc_ppopp22_tpu_torch import graph
from qgtc_ppopp22_tpu_torch.benchmarks import (partition_quality, ring_overlap, roofline, run_all, transfer_study,
                                               zero_tile_study)
from qgtc_ppopp22_tpu_torch.graph.batching import ClusterBatch
from qgtc_ppopp22_tpu_torch.ops.bitpack import pack_bits_np
from qgtc_ppopp22_tpu_torch.ops.packmm import build_tile_map_packed_np, pack_rows_np
from qgtc_ppopp22_tpu_torch.parallel import x_digits_np
from qgtc_ppopp22_tpu_torch.runtime import QGTCEngine, mega_block_occ
from qgtc_ppopp22_tpu_torch.utils.timing import host_bench

SCALE, PSIZE, BATCH = 0.05, 40, 4  # Proteins: 2173 nodes, 10 batches of 4 partitions


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Beside other test workers the default thread pool slows the plain
    GEMMs down several times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def proteins():
    return graph.synthesize("Proteins", scale=SCALE, seed=0), jgraph.synthesize("Proteins", scale=SCALE, seed=0)


def _batchers(proteins, **kw):
    ds, jds = proteins
    kw = dict(psize=PSIZE, batch_size=BATCH, **kw)
    return graph.ClusterBatcher(ds, **kw), jgraph.ClusterBatcher(jds, **kw)


# -- zero-tile counts ---------------------------------------------------------


def _jax_tile_counts(jit) -> dict:
    """JAX's ``benchmarks/zero_tile_study.py`` counters, on its own batcher."""
    total = processed = chunks_total = chunks_occ = blocks_total = blocks_occ = 0
    for b in jit.batches:
        total += int(b.tile_kidx.size)
        processed += int(np.sum(b.tile_kcnt))
        pn = b.padded_nodes
        chunk = 512 if pn % 512 == 0 else 256
        occ = jruntime.mega_chunk_occ(b.a_words, chunk)
        chunks_total += occ.size
        chunks_occ += int(occ.sum())
        bocc = jruntime.mega_block_occ(b.a_words, chunk, jmega_colblock(pn))
        blocks_total += bocc.size
        blocks_occ += int(bocc.sum())
    return dict(tiles_total=total, tiles_processed=processed,
                jump_ratio=round(1 - processed / max(total, 1), 4),
                chunk_jump_ratio=round(1 - chunks_occ / max(chunks_total, 1), 4),
                block_jump_ratio=round(1 - blocks_occ / max(blocks_total, 1), 4))


@pytest.mark.parametrize("method,bucket_rows", [("native", 512), ("bfs", 512), ("bfs", 256)])
def test_zero_tile_counts_equal_jax(proteins, method, bucket_rows):
    it, jit = _batchers(proteins, partition_method=method, bucket_rows=bucket_rows)
    got = zero_tile_study.tile_counts(it)
    assert got == _jax_tile_counts(jit)
    assert 0 < got["tiles_processed"] <= got["tiles_total"]


def test_zero_tile_rows_on_cpu(proteins):
    it, _ = _batchers(proteins)
    out = zero_tile_study.dataset_rows("Proteins", it, proteins[0].num_classes, ["mega", "mega-streaming"], 1,
                                       torch.device("cpu"), "cpu")
    assert [r["mode"] for r in out] == ["mega", "mega-streaming"]
    assert all(math.isfinite(r["dense_ms"]) and math.isfinite(r["zerotile_ms"]) and r["card"] == "cpu" for r in out)


# -- partition quality --------------------------------------------------------


def _jax_quality(jds, method: str) -> dict:
    """JAX's ``benchmarks/partition_quality.py`` row, its seconds left out."""
    parts = jpartition.get_partition_list(jds.graph, PSIZE, method=method)
    it = jgraph.ClusterBatcher(jds, psize=PSIZE, batch_size=BATCH, bit_width=1, partition_method=method)
    nnz = tot = skip = blocks = 0
    for b in it.batches:
        w = np.asarray(b.a_words)
        nnz += int(np.unpackbits(w.view(np.uint8)).sum())
        tot += b.num_nodes * b.num_nodes
        occ = jruntime.mega_block_occ(w, 512, jmega_colblock(b.padded_nodes))
        skip += int((occ == 0).sum())
        blocks += occ.size
    return dict(edge_cut=round(jpartition.edge_cut_fraction(jds.graph, parts), 4),
                batch_density=round(nnz / max(tot, 1), 5), skip_ratio=round(skip / max(blocks, 1), 4))


@pytest.mark.parametrize("method", ["native", "bfs", "rcm"])
def test_partition_quality_equal_jax(proteins, method):
    row = partition_quality.method_row(proteins[0], method, PSIZE, BATCH, "cpu")
    assert {k: row[k] for k in ("edge_cut", "batch_density", "skip_ratio")} == _jax_quality(proteins[1], method)
    assert row["partition_s"] >= 0 and row["method"] == method and row["card"] == "cpu"


# -- transfer bytes -----------------------------------------------------------


def test_transfer_bytes_equal_jax(proteins):
    ds, jds = proteins
    it, jit = _batchers(proteins, seed=3)
    packed = dense = 0
    for b in jit.batches:  # JAX's benchmarks/transfer_study.py, its own batcher
        packed += np.ascontiguousarray(b.a_words).nbytes + np.asarray(b.bit_X.planes).nbytes
        n, pn = b.num_nodes, b.padded_nodes
        dense += pn * pn + pn * jit.feat_dim * 4
        assert jds.graph.subgraph_dense(b.nodes).shape == (n, n)
    out = transfer_study.study_rows(ds, it, torch.device("cpu"), "cpu", epochs=1)
    got = {r["form"]: r for r in out}
    assert (got["packed"]["bytes_per_epoch"], got["dense"]["bytes_per_epoch"]) == (packed, dense)
    assert got["packed"]["bytes_ratio_vs_dense"] == round(dense / packed, 2) > 1
    # the dense form holds the batch's adjacency and features
    fm = transfer_study.forms(ds, it)
    b0 = it.batches[0]
    assert torch.equal(fm["dense"][0][0][: b0.num_nodes, : b0.num_nodes],
                       torch.from_numpy(ds.graph.subgraph_dense(b0.nodes)))
    assert torch.equal(fm["dense"][0][1][: b0.num_nodes], torch.from_numpy(it.features[b0.nodes]))


# -- roofline ------------------------------------------------------------------


def _batch(dense: np.ndarray, nodes: int, feat: int) -> ClusterBatch:
    """A hand-made batch of a 0/1 adjacency ``dense`` [pn, pn] (``nodes`` real)."""
    pn = dense.shape[0]
    words = pack_rows_np(dense.astype(np.int32), 1)
    kidx, kcnt = build_tile_map_packed_np(words, 1)
    return ClusterBatch(nodes=np.arange(nodes), bit_X=pack_bits_np(np.zeros((pn, feat), np.int32), 2),
                        num_nodes=nodes, padded_nodes=pn, a_words=torch.from_numpy(words),
                        tile_kidx=torch.from_numpy(kidx), tile_kcnt=torch.from_numpy(kcnt))


# a pn 256 bucket of one batch, 200 real nodes, 29 features (Proteins), 2
# classes, 2-bit: by hand, per batch
#   bytes: A's words 256 * 256 / 8 = 8192, X's one digit plane 256 x 128
#   (29 padded) = 32768, the weights' blob 3 x 128 x 128 int8 digit planes
#   = 49152 (one bucket of one batch), logits 200 x 2 float32 = 1600;
#   GCN (hidden 16): updates 2 * 256 * (29*16 + 16*16 + 16*2) = 385024,
#   aggregations 2 * 256^2 * (16 + 16 + 2) = 4456448;
#   GIN (hidden 64): aggregations 2 * 256^2 * (29 + 64 + 64) = 20578304,
#   updates 2 * 256 * (29*64 + 64*64 + 64*2) = 3112960.
HAND_256 = {"gcn": (8192 + 32768 + 49152 + 1600, 385024 + 4456448),
            "gin": (8192 + 32768 + 49152 + 1600, 20578304 + 3112960)}


@pytest.mark.parametrize("model", ["gcn", "gin"])
def test_roofline_pn256_hand_count(model):
    rng = np.random.default_rng(0)
    a = np.zeros((256, 256), np.uint8)
    a[:200, :200] = rng.random((200, 200)) < 0.05
    b = _batch(a, 200, 29)
    eng = QGTCEngine(feat_dim=29, num_classes=2, model=model, bit_width=2, device="cpu")
    w = roofline.bucket_work([b], model, 2, eng)
    assert (w["bytes"], w["ops"]) == ([HAND_256[model][0]], [HAND_256[model][1]])
    assert not w["compact"] and w["refused"] is None and w["k1"][0] >= w["ops"][0]
    # the epoch row: floor = the larger of the two data-sheet times, one batch
    ds = type("DS", (), {"name": "hand", "num_classes": 2})()
    batcher = type("B", (), {"batches": [b], "feat_dim": 29})()
    row = roofline.dataset_rows(ds, batcher, [2], [model], "cpu", rates={"hbm": 1e12, "int8": 1e14}, l2_bytes=1 << 20)
    nbytes, ops = HAND_256[model]
    assert row[0]["floor_ms"] == round(max(nbytes / 3.35e12, ops / 1979e12) * 1e3, 5)
    assert row[0]["floor_ms_card"] == round(max(nbytes / 1e12, ops / 1e14) * 1e3, 5)
    assert row[0]["fits_l2"] is True and row[0]["bound"] == ("bytes" if nbytes / 3.35 > ops / 1979 else "operations")


@pytest.mark.parametrize("bits,gated", [(2, True), (2, False), (8, True)])
def test_roofline_skip_follows_the_engine_gate(monkeypatch, bits, gated):
    """A pn 2048 bucket whose blocks are mostly empty: the aggregations
    count the occupied blocks exactly where ``mega_zero_tile_gate`` gives
    the compacted schedule (<= 4 bits, >= 45% skippable, pn >= 2048)."""
    a = np.zeros((2048, 2048), np.uint8)
    a[:512, :512] = 1  # one of 4 x 4 blocks (512-row chunks x 512-column blocks)
    bs = [_batch(a, 2000, 29), _batch(np.eye(2048, dtype=np.uint8), 2000, 29)]
    if not gated:
        monkeypatch.setattr(roofline, "mega_zero_tile_gate", lambda *args: None)
    eng = QGTCEngine(feat_dim=29, num_classes=2, model="gcn", bit_width=bits, device="cpu")
    w = roofline.bucket_work(bs, "gcn", bits, eng)
    dims = [29, 16, 16, 2]
    share = [float(mega_block_occ(b.a_words.numpy(), 512, 512).mean()) for b in bs]  # 1/16 and 4/16
    compact = gated and bits <= 4
    assert w["compact"] == compact
    assert w["ops"] == [roofline.chain_ops("gcn", 2048, dims, s if compact else 1.0) for s in share]
    assert roofline.chain_ops("gcn", 2048, dims, 0.25) < roofline.chain_ops("gcn", 2048, dims)


# -- run_all ------------------------------------------------------------------


@pytest.mark.parametrize("mode", run_all.MODES)
@pytest.mark.parametrize("model", ["gcn", "gin"])
def test_run_all_rows_on_cpu(proteins, mode, model):
    ds = graph.synthesize("Proteins", scale=0.02, seed=0)
    it = graph.ClusterBatcher(ds, psize=16, batch_size=4, bit_width=2)
    out = run_all.dataset_rows(ds, it, [2, 8], torch.device("cpu"), "cpu", model=model, baseline=True, mode=mode,
                               n_epochs=1)
    assert [(r["engine"], r["bits"]) for r in out] == [("qgtc", 2), ("qgtc", 8), ("fp-baseline", 32)]
    jax_columns = ("dataset", "model", "engine", "bits", "mode", "epoch_ms", "launch_sync_ms")
    for r in out:
        assert tuple(run_all.COLUMNS[:7]) == jax_columns and set(run_all.COLUMNS) <= set(r)
        assert r["not_run"] == "" and r["fallback_buckets"] == 0 and r["card"] == "cpu"
        assert math.isfinite(r["epoch_ms"]) and r["epoch_ms"] > 0 and r["mode"] == mode and r["model"] == model


def test_run_all_main_writes_rows_one_at_a_time(tmp_path, capsys):
    out = tmp_path / "m.csv"
    assert run_all.main(["--datasets", "Proteins", "--scale", "0.02", "--psize", "16", "--batch-size", "4",
                         "--bits", "1", "4", "--n-epochs", "1", "--device", "cpu", "--csv", str(out)]) == 0
    lines = out.read_text().splitlines()
    assert lines[0] == ",".join(run_all.COLUMNS) and len(lines) == 3
    assert capsys.readouterr().out.count("'dataset': 'Proteins'") == 2


def test_run_all_cell_that_fails_stays_in_the_matrix():
    def boom():
        raise RuntimeError("out of memory")

    row = run_all._cell(boom, list, dict(dataset="x"))
    assert row["epoch_ms"] is None and row["not_run"] == "RuntimeError: out of memory"


def test_studies_refuse_cuda_without_it():
    if torch.cuda.is_available():
        pytest.skip("CUDA present")
    for mod, argv in ((run_all, []), (zero_tile_study, []), (transfer_study, []), (roofline, []),
                      (partition_quality, []), (ring_overlap, [])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mod.main(argv)


# -- ring overlap -------------------------------------------------------------


def test_ring_link_volume_is_jax_formula():
    lv = ring_overlap.link_volume()
    n_sp, hid = 4, 64  # JAX: benchmarks/ring_overlap.py:88-103
    rows_loc = 2048 // n_sp
    assert (lv["ring_bytes_per_rotation"], lv["ring_bytes"], lv["gather_bytes"]) == (
        rows_loc * hid, (n_sp - 1) * rows_loc * hid, 2048 * hid)
    assert lv["port_ring_bytes_per_rotation"] == rows_loc * 128  # one 2-bit digit plane, 128 columns


def test_ring_and_gather_equal_the_step_engine_on_a_cpu_mesh():
    out = ring_overlap.rows("cpu", n=1024, steps=1)  # raises where any logits differ
    assert [r["part"] for r in out] == ["a", "a", "b", "c", "c"]
    assert all(r["host_ms_per_step"] > 0 for r in out if r["part"] == "c")


def test_ring_overlap_share_from_a_timeline():
    # two GEMMs on stream 7 over [0, 10) and [20, 30); copies on stream 9
    ev = [("k3_kernel<1, 1>", "kernel", 7, 0.0, 10.0), ("k2_kernel<1>", "kernel", 7, 20.0, 30.0),
          ("Memcpy DtoD", "gpu_memcpy", 9, 5.0, 15.0), ("Memcpy DtoD", "gpu_memcpy", 9, 25.0, 27.0),
          ("elementwise", "kernel", 7, 40.0, 50.0)]
    got = ring_overlap.overlap(ev, 2)
    assert got["overlap_share"] == round((5 + 2) / 12, 4)
    assert (got["copies_per_aggregation"], got["gemms_per_aggregation"], got["gemm_us"]) == (1, 1, 20.0)


# -- host_bench and x_digits_np -------------------------------------------------


def test_host_bench_times_the_calls():
    calls = []

    def fn(a, b):
        calls.append(1)
        return [a + b]

    s = host_bench(fn, (torch.ones(3), torch.ones(3)), iters=5)
    assert s > 0 and len(calls) == 6


@pytest.mark.parametrize("bits", [1, 2, 3, 4, 5, 8])
def test_x_digits_np_equals_jax(bits):
    rng = np.random.default_rng(bits)
    q = rng.integers(0, 1 << bits, (300, 130)).astype(np.int32)
    bt = pack_bits_np(q, bits)
    jbt = jbitpack.BitTensor(planes=bt.planes.numpy().view(np.uint32), shape=bt.shape, bits=bits)
    got = x_digits_np(bt, 256)
    assert got.dtype == np.int8 and np.array_equal(got, jx_digits_np(jbt, 256))
