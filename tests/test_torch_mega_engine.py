"""The mega engine of the PyTorch port against the JAX package's, and its CLI.

``QGTCEngine.run_epochs_mega`` (one ``fused_model_epoch`` launch a
bucket; its plain version here, on the CPU) against the JAX engine's mega
path (its ``fused_model_epoch`` in Pallas interpret mode) and the port's
step engine, on two-bucket batches of the Proteins stand-in (scale 0.02):
GCN and GIN, ``zerotile_jump`` None, True and False; the loud fallback of
a bucket the kernel refuses; the epoch statistics; the CLI's mega mode
and its ``--zerotile_jump`` in step mode. Split from ``test_torch_mega.py``
(the kernel against JAX). Weights are the same integer levels in both
packages. Tolerance: exact equality.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgtc_ppopp22_tpu import graph as jgraph
from qgtc_ppopp22_tpu import runtime as jruntime
from qgtc_ppopp22_tpu.ops import digits as jdigits
from qgtc_ppopp22_tpu.ops.fused_model import fused_model_epoch as jax_fused_model_epoch
from qgtc_ppopp22_tpu.runtime import QGTCEngine as JaxEngine
from qgtc_ppopp22_tpu_torch import cli, graph
from qgtc_ppopp22_tpu_torch.models import qmodels
from qgtc_ppopp22_tpu_torch.ops.fused_model import mega_colblock
from qgtc_ppopp22_tpu_torch.runtime import EpochStats, QGTCEngine
from torch_threads import one_thread  # noqa: F401  (an autouse fixture: one torch thread)


@pytest.fixture(scope="module")
def batches():
    """Both packages' 2-bit batches of the Proteins stand-in, built once."""
    kw = dict(bit_width=2, seed=5, bucket_rows=256, partition_method="bfs")
    ds = graph.synthesize("Proteins", scale=0.02, seed=5)
    jds = jgraph.synthesize("Proteins", scale=0.02, seed=5)
    return ds, graph.ClusterBatcher(ds, 4, 2, **kw), jgraph.ClusterBatcher(jds, 4, 2, **kw)


@pytest.fixture(scope="module")
def jax_mega():
    """The JAX engine's mega logits of each (model, compact), computed once
    in the module: ``get(model, compact, je, jit)``."""
    seen = {}

    def get(model, compact, je, jit):
        if (model, compact) not in seen:
            seen[model, compact] = _jax_mega_logits(je, jit, compact)
        return seen[model, compact]

    return get


def _engine_pair(batches, model, zerotile_jump=None):
    ds, it, jit = batches
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
def test_run_epochs_mega_matches_step_engine_and_jax(batches, jax_mega, model, zerotile_jump):
    ds, it, jit, je, te = _engine_pair(batches, model, zerotile_jump=zerotile_jump)
    got = te._mega_logits(it)
    info = te.mega_buckets
    assert info and all(not i["fallback"] for i in info)
    # auto gate: these buckets are below pn 2048, so only True compacts
    assert all(i["compact"] == bool(zerotile_jump) for i in info)
    assert all(0.0 <= i["skippable"] <= 1.0 for i in info)
    te_step = QGTCEngine(feat_dim=it.feat_dim, num_classes=ds.num_classes, model=model,
                         device="cpu")
    te_step.weights = te.weights
    ref = jax_mega(model, bool(zerotile_jump), je, jit)
    for b, g, s, r in zip(it.batches, got, te_step.forward_all(it), ref):
        n, c = b.num_nodes, ds.num_classes
        assert g.shape == (b.padded_nodes, -(-c // 8) * 8)
        np.testing.assert_array_equal(g.numpy(), r)
        assert torch.equal(g[:n, :c], s[:n, :c])


def test_run_epochs_mega_falls_back_loudly(batches, capsys):
    """A bucket the kernel refuses (here: more layers than it takes) runs
    through its captured fused epoch (the step engine's chains), and says
    so."""
    ds, it, _ = batches
    te = QGTCEngine(feat_dim=it.feat_dim, num_classes=ds.num_classes, num_layers=9, seed=3,
                    device="cpu")
    got = te._mega_logits(it)
    assert "[mega] bucket pn=" in capsys.readouterr().out
    assert te.mega_buckets and all(i["fallback"] for i in te.mega_buckets)
    for b, g, s in zip(it.batches, got, te.forward_all(it)):
        assert torch.equal(g, s)


@pytest.mark.parametrize("sync_every_epoch", [False, True])
def test_run_epochs_mega_stats(batches, sync_every_epoch):
    _, it, _, _, te = _engine_pair(batches, "gcn")
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
