"""The mega engine of the PyTorch port against the JAX package.

``fused_model_epoch`` (its plain version here, on the CPU) against the
JAX ``fused_model_epoch`` in Pallas interpret mode and against the NumPy
golden chains; the occupancy builders, the feature staging and
``QGTCEngine.run_epochs_mega`` against their JAX counterparts and the
port's step engine. Inputs come from NumPy seeds; weights are the same
integer levels in both packages. Tolerance: exact equality.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgtc_ppopp22_tpu import graph as jgraph
from qgtc_ppopp22_tpu import runtime as jruntime
from qgtc_ppopp22_tpu.models.qmodels import qgcn_golden, qgin_golden
from qgtc_ppopp22_tpu.ops import digits as jdigits
from qgtc_ppopp22_tpu.ops.fused_model import fused_model_epoch as jax_fused_model_epoch
from qgtc_ppopp22_tpu.runtime import QGTCEngine as JaxEngine
from qgtc_ppopp22_tpu_torch import cli, graph, runtime
from qgtc_ppopp22_tpu_torch.models import qmodels
from qgtc_ppopp22_tpu_torch.ops import digits
from qgtc_ppopp22_tpu_torch.ops.fused_model import (
    fused_model_epoch,
    fused_model_epoch_plain,
    mega_colblock,
)
from qgtc_ppopp22_tpu_torch.runtime import EpochStats, QGTCEngine
from torch_cases import mega_case

SHIFTS = [1, 2, 1, 2, 1]
# keep[b][c]: occupied column blocks of row chunk c in batch b
KEEP_512 = [[[0, 1]], [[1]]]  # pn 512: one chunk, 2 blocks of 256
KEEP_1024 = [[[0, 1, 2, 3], [2]], [[], [0, 2, 3]]]  # all, 1, none, 3


def _port_ws(qws, bits):
    return [digits.digit_pack(torch.from_numpy(w), bits) for w in qws]


def _jax_ws(qws, bits):
    return [jdigits.digit_pack(jnp.asarray(w), bits) for w in qws]


def _sched(a_words, chunk, cb):
    return np.stack([runtime.mega_block_sched(w[None], chunk, cb) for w in a_words])


# (pn, keep, compact, shifts, out_cols)
VARIANTS = {
    "dense": (512, KEEP_512, False, None, None),
    "compact-shifts-outcols": (512, KEEP_512, True, SHIFTS, 40),
    "compact-4blocks": (1024, KEEP_1024, True, None, None),
    "dense-shifts-outcols": (1024, KEEP_1024, False, SHIFTS, 40),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("model", ["gcn", "gin"])
def test_fused_model_matches_jax(model, bits, variant):
    pn, keep, compact, shifts, out_cols = VARIANTS[variant]
    hidden = 16 if model == "gcn" else 64
    qa, qx, qws, aw, xd = mega_case(bits + pn + len(variant), 2, pn, bits, hidden,
                                    keep=keep, shift=1 if shifts else 0)
    sched = _sched(aw, 512, 256) if compact else None
    kw = dict(model=model, shifts=shifts, out_cols=out_cols, x_cols=128)
    got = fused_model_epoch(
        torch.from_numpy(aw), torch.from_numpy(xd), _port_ws(qws, bits), bits,
        blk_sched=None if sched is None else torch.from_numpy(sched), **kw)
    ref = np.asarray(jax_fused_model_epoch(
        jnp.asarray(aw), jnp.asarray(xd), _jax_ws(qws, bits), bits,
        blk_sched=None if sched is None else jnp.asarray(sched), **kw))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert got.shape == (2, pn, 40 if out_cols else 128)
    np.testing.assert_array_equal(got.numpy(), ref)
    # the chain neither saturated nor vanished
    assert len(np.unique(ref)) > (2 if bits == 1 else 4)


@pytest.mark.parametrize("bits", [2, 8])
@pytest.mark.parametrize("model", ["gcn", "gin"])
def test_fused_model_golden_nine_blocks(model, bits):
    """pn = 2304: chunks of 256 rows, 9 column blocks of 256, chunks
    with all 9 blocks, none, one, and odd and even counts."""
    pn = 2304
    counts = [9, 0, 1, 5, 8, 3, 9, 7, 2]
    keep = [[list(range(c)) if i % 2 else list(range(9 - c, 9)) for i, c in enumerate(counts)]]
    qa, qx, qws, aw, xd = mega_case(bits, 1, pn, bits, 16, keep=keep, chunk=256, cb=256)
    sched = _sched(aw, 256, 256)
    assert sched.shape == (1, 9, 10) and sched[0, :, 0].tolist() == counts
    ws = _port_ws(qws, bits)
    args = (torch.from_numpy(aw), torch.from_numpy(xd), ws, bits)
    got = fused_model_epoch(*args, model=model, blk_sched=torch.from_numpy(sched))
    gold = (qgcn_golden if model == "gcn" else qgin_golden)(qa[0], qx[0], qws, bits, bits)
    np.testing.assert_array_equal(got[0, :, :40].numpy(), gold)
    assert not got[0, :, 40:].any()
    assert torch.equal(got, fused_model_epoch(*args, model=model))


def test_schedule_drops_unlisted_blocks():
    """A schedule that leaves out occupied blocks multiplies only the
    listed ones: the plain version zeroes the rest of the adjacency."""
    qa, qx, qws, aw, xd = mega_case(1, 1, 512, 2, 16)
    ws = _port_ws(qws, 2)
    sched = torch.tensor([[[1, 1, 0]]], dtype=torch.int32)  # block 1 only
    got = fused_model_epoch(torch.from_numpy(aw), torch.from_numpy(xd), ws, 2,
                            blk_sched=sched)
    qa_kept = qa.copy()
    qa_kept[:, :, :256] = 0
    gold = qgcn_golden(qa_kept[0], qx[0], qws, 2, 2)
    np.testing.assert_array_equal(got[0, :, :40].numpy(), gold)
    with pytest.raises(ValueError, match="not a schedule"):
        fused_model_epoch(torch.from_numpy(aw), torch.from_numpy(xd), ws, 2,
                          blk_sched=torch.tensor([[[2, 1, 1]]], dtype=torch.int32))


@pytest.mark.parametrize("chunk,cb", [(512, 512), (512, 256), (256, 256)])
def test_occupancy_builders_match_jax(chunk, cb):
    keep = [[[0, 3], [1], [], [0, 1, 2, 3]]]
    _, _, _, aw, _ = mega_case(4, 1, 1024, 2, 16, keep=keep, chunk=256, cb=256)
    w = aw[0][None]
    for name in ("mega_block_occ", "mega_block_sched"):
        port, ref = getattr(runtime, name)(w, chunk, cb), getattr(jruntime, name)(w, chunk, cb)
        assert port.dtype == ref.dtype and port.tobytes() == ref.tobytes()
    port, ref = runtime.mega_chunk_occ(w, chunk), jruntime.mega_chunk_occ(w, chunk)
    assert port.dtype == ref.dtype and port.tobytes() == ref.tobytes()
    assert mega_colblock(2560) == 512 and mega_colblock(2304) == 768 and mega_colblock(512) == 256


@pytest.mark.parametrize("bits", [2, 8])
def test_planes_stack_to_digits_matches_jax(bits):
    rng = np.random.default_rng(bits)
    q = rng.integers(0, 1 << bits, (3, 300, 100))
    planes = np.stack([graph.batching.pack_bits_np(x, bits).planes.numpy() for x in q])
    got = digits.planes_stack_to_digits(torch.from_numpy(planes), (300, 100), bits)
    ref = jdigits.planes_stack_to_digits(jnp.asarray(planes.view(np.uint32)), (300, 100), bits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("kwargs", [
    dict(x_levels_bits=8), dict(chunk_occ=torch.ones((1, 1), dtype=torch.int32)), dict(resident_a=False),
    dict(unpack_once=True),
])
def test_fused_model_refuses_unported_forms(kwargs):
    """The TPU's unpack-once tier is refused by name; the JAX kernel's
    predicated occupancy map, its streamed-A tier and levels-form X run
    (a full map and ``resident_a=False`` give the dense logits; the digit
    plane read as byte levels takes the signed chain to the same logits,
    padded columns included)."""
    _, _, qws, aw, xd = mega_case(0, 1, 512, 2, 16)
    args = (torch.from_numpy(aw), torch.from_numpy(xd), _port_ws(qws, 2), 2)
    if "unpack_once" not in kwargs:
        assert torch.equal(fused_model_epoch(*args, **kwargs), fused_model_epoch(*args))
        return
    with pytest.raises(NotImplementedError, match="not yet ported: .*unpack-once"):
        fused_model_epoch(*args, **kwargs)


def test_fused_model_refuses_bad_shapes():
    _, _, qws, aw, xd = mega_case(0, 1, 512, 2, 16)
    ws = _port_ws(qws, 2)
    a, x = torch.from_numpy(aw), torch.from_numpy(xd)
    with pytest.raises(ValueError, match="stacked shapes"):
        fused_model_epoch(a[:, :, :384], x, ws, 2)
    with pytest.raises(ValueError, match="blk_sched"):
        fused_model_epoch(a, x, ws, 2, blk_sched=torch.zeros((1, 2, 3), dtype=torch.int32))
    with pytest.raises(ValueError, match="shifts"):
        fused_model_epoch(a, x, ws, 2, shifts=[1, 2])


# -- the engine -------------------------------------------------------------


def _engine_pair(model, bucket_rows=256, zerotile_jump=None):
    kw = dict(bit_width=2, seed=5, bucket_rows=bucket_rows, partition_method="bfs")
    ds = graph.synthesize("Proteins", scale=0.02, seed=5)
    jds = jgraph.synthesize("Proteins", scale=0.02, seed=5)
    it, jit = graph.ClusterBatcher(ds, 4, 2, **kw), jgraph.ClusterBatcher(jds, 4, 2, **kw)
    je = JaxEngine(feat_dim=it.feat_dim, num_classes=ds.num_classes, model=model, seed=1)
    te = QGTCEngine(feat_dim=it.feat_dim, num_classes=ds.num_classes, model=model, seed=1,
                    zerotile_jump=zerotile_jump, device="cpu")
    te.weights = qmodels.weights_from_jax([np.asarray(w) for w in je.float_weights], 2)
    return ds, it, jit, je, te


def _jax_mega_logits(je, jit, compact):
    """The JAX engine's mega path (runtime.py:473-634 at 2 bits, resident)."""
    out = [None] * len(jit.batches)
    where = {id(b): i for i, b in enumerate(jit.batches)}
    for key, bs, a_np, x_np, _, _ in je._fused_groups(jit):
        pn = key[0]
        x = jdigits.planes_stack_to_digits(jnp.asarray(x_np), bs[0].bit_X.shape, 2)
        sched = None
        if compact:
            sched = jnp.asarray(np.stack([jruntime.mega_block_sched(b.a_words, 512 if pn % 512 == 0 else 256,
                                                                    mega_colblock(pn)) for b in bs]))
        res = np.asarray(jax_fused_model_epoch(
            jnp.asarray(a_np[:, 0]), x, je.weights, 2, model=je.model, blk_sched=sched,
            out_cols=je.cfg.out_dim, x_cols=je.cfg.in_dim))
        for b, r in zip(bs, res):
            out[where[id(b)]] = r
    return out


@pytest.mark.parametrize("zerotile_jump", [None, True, False])
@pytest.mark.parametrize("model", ["gcn", "gin"])
def test_run_epochs_mega_matches_step_engine_and_jax(model, zerotile_jump):
    ds, it, jit, je, te = _engine_pair(model, zerotile_jump=zerotile_jump)
    got = te._mega_logits(it)
    info = te.mega_buckets
    assert info and all(not i["fallback"] for i in info)
    # auto gate: these buckets are below pn 2048, so only True compacts
    assert all(i["compact"] == bool(zerotile_jump) for i in info)
    assert all(0.0 <= i["skippable"] <= 1.0 for i in info)
    te_step = QGTCEngine(feat_dim=it.feat_dim, num_classes=ds.num_classes, model=model,
                         device="cpu")
    te_step.weights = te.weights
    ref = _jax_mega_logits(je, jit, bool(zerotile_jump))
    for b, g, s, r in zip(it.batches, got, te_step.forward_all(it), ref):
        n, c = b.num_nodes, ds.num_classes
        assert g.shape == (b.padded_nodes, -(-c // 8) * 8)
        np.testing.assert_array_equal(g.numpy(), r)
        assert torch.equal(g[:n, :c], s[:n, :c])


def test_run_epochs_mega_falls_back_loudly(capsys):
    """A bucket the kernel refuses (here: more layers than it takes) runs
    through its captured fused epoch (the step engine's chains), and says
    so."""
    ds, it, _, _, _ = _engine_pair("gcn")
    te = QGTCEngine(feat_dim=it.feat_dim, num_classes=ds.num_classes, num_layers=9, seed=3,
                    device="cpu")
    got = te._mega_logits(it)
    assert "[mega] bucket pn=" in capsys.readouterr().out
    assert te.mega_buckets and all(i["fallback"] for i in te.mega_buckets)
    for b, g, s in zip(it.batches, got, te.forward_all(it)):
        assert torch.equal(g, s)


@pytest.mark.parametrize("sync_every_epoch", [False, True])
def test_run_epochs_mega_stats(sync_every_epoch):
    _, it, _, _, te = _engine_pair("gcn")
    st = te.run_epochs_mega(it, n_epochs=2, sync_every_epoch=sync_every_epoch)
    assert isinstance(st, EpochStats) and st.n_batches == len(it)
    assert len(st.epoch_ms) == (2 if sync_every_epoch else 1) and st.avg_ms > 0
    assert (st.launch_sync_ms == 0) == sync_every_epoch


def _toy_npz(path):
    rng = np.random.default_rng(0)
    np.savez(path / "toy.npz", src_li=rng.integers(0, 600, 3000), dst_li=rng.integers(0, 600, 3000))


@pytest.mark.parametrize("flags", [[], ["--zerotile_jump"]])
def test_cli_mega_mode(tmp_path, monkeypatch, capsys, flags):
    _toy_npz(tmp_path)
    monkeypatch.chdir(tmp_path)
    rc = cli.main(["--dataset", "toy", "--data-dir", str(tmp_path), "--psize", "4",
                   "--batch-size", "2", "--n-epochs", "2", "--device", "cpu", "--use_QGTC",
                   "--mode", "mega", *flags])
    assert rc == 0
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert record["engine"] == "qgtc-mega" and record["avg_epoch_ms"] > 0
    assert all(b["compact"] == bool(flags) and not b["fallback"] for b in record["buckets"])


def test_cli_zerotile_jump_needs_mega_mode(tmp_path, monkeypatch, capsys):
    """It no longer does: ``--zerotile_jump`` in step mode runs the
    TileMap K skip and records the batches' tile counters."""
    _toy_npz(tmp_path)
    monkeypatch.chdir(tmp_path)
    rc = cli.main(["--dataset", "toy", "--data-dir", str(tmp_path), "--psize", "4",
                   "--batch-size", "2", "--n-epochs", "1", "--device", "cpu", "--zerotile_jump"])
    assert rc == 0
    out = capsys.readouterr().out
    record = json.loads(out.strip().splitlines()[-1])
    assert record["engine"] == "qgtc-step" and 0 < record["tiles_processed"] <= record["tiles_total"]
    assert f"zero-tile: processed {record['tiles_processed']}/{record['tiles_total']}" in out


def test_plain_is_the_cpu_path():
    _, _, qws, aw, xd = mega_case(2, 1, 512, 2, 16)
    args = (torch.from_numpy(aw), torch.from_numpy(xd), _port_ws(qws, 2), 2)
    assert torch.equal(fused_model_epoch(*args), fused_model_epoch_plain(*args))
