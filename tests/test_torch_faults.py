"""Three faults of the PyTorch port against the JAX package, each held
against the reference on the CPU (JAX in Pallas interpret mode):

1. ``QGTCEngine.run_epochs_mega(resident_a=)``: JAX's residency tier
   choice per bucket (``runtime.py:531-613``), on the same batches as
   JAX's engine, whose choice is read from the arguments it hands its
   ``fused_model_epoch``;
2. the baseline's mega mode runs a bucket that ``fused_baseline`` refuses
   through the fused loop, and says so (JAX ``runtime.py:954-971``);
3. ``qgcn_forward`` / ``qgin_forward`` take JAX's arguments: a positional
   fifth argument is the tile map.

Tolerance: exact equality (bf16 logits of the fallback: the fused loop's
own, bit for bit).
"""

import contextlib
import io
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgtc_ppopp22_tpu import graph as jgraph
from qgtc_ppopp22_tpu import runtime as jruntime
from qgtc_ppopp22_tpu.models import qmodels as jqmodels
from qgtc_ppopp22_tpu.ops import digits as jdigits
from qgtc_ppopp22_tpu.ops import fused_model as jfused_model
from qgtc_ppopp22_tpu.ops import packmm as jpackmm
from qgtc_ppopp22_tpu.ops.bitgemm import TileMap as JaxTileMap
from qgtc_ppopp22_tpu_torch import graph
from qgtc_ppopp22_tpu_torch.models import qmodels
from qgtc_ppopp22_tpu_torch.ops import digits, fused_model, packmm
from qgtc_ppopp22_tpu_torch.runtime import BaselineEngine, QGTCEngine
from torch_threads import one_thread  # noqa: F401  (an autouse fixture: one torch thread)

# -- fault 1: run_epochs_mega(resident_a=) ------------------------------------

# Proteins at scale 0.05, psize 4, batch 2: one bucket of 2 batches at pn
# 1280 with 40% of its (row chunk x column block) blocks skippable, above
# JAX's 30% streaming gate and below its pn 2048 resident gate
_KW = dict(bit_width=2, seed=5, bucket_rows=256, partition_method="bfs")


@pytest.fixture(scope="module")
def streamed():
    """The batchers, the JAX engine's float weights, and its logits of the
    bucket's streamed launch with the occupancy map (JAX's kernel in
    interpret mode; a real map gives the dense logits)."""
    ds = graph.synthesize("Proteins", scale=0.05, seed=5)
    jds = jgraph.synthesize("Proteins", scale=0.05, seed=5)
    it, jit = graph.ClusterBatcher(ds, 4, 2, **_KW), jgraph.ClusterBatcher(jds, 4, 2, **_KW)
    je = jruntime.QGTCEngine(feat_dim=jit.feat_dim, num_classes=jds.num_classes, model="gcn", seed=1)
    ref = [None] * len(jit.batches)
    where = {id(b): i for i, b in enumerate(jit.batches)}
    for key, bs, a_np, x_np, _, _ in je._fused_groups(jit):
        pn = key[0]
        x = jdigits.planes_stack_to_digits(jnp.asarray(x_np), bs[0].bit_X.shape, 2)
        chunk = 512 if pn % 512 == 0 else 256
        occ = np.stack([jruntime.mega_block_occ(b.a_words, chunk, jfused_model.mega_colblock(pn)) for b in bs])
        res = np.asarray(jfused_model.fused_model_epoch(
            jnp.asarray(a_np[:, 0]), x, je.weights, 2, model="gcn", chunk_occ=jnp.asarray(occ),
            resident_a=False, out_cols=je.cfg.out_dim, x_cols=je.cfg.in_dim))
        for b, r in zip(bs, res):
            ref[where[id(b)]] = r
    return ds, it, jds, jit, je, ref


def _jax_choices(monkeypatch, je, jit, zerotile_jump, resident_a):
    """What JAX's run_epochs_mega hands its fused_model_epoch for each
    bucket: (chunk_occ given, blk_sched given, resident_a). Its kernel is
    replaced by zeros of the logits' shape: only the choice is read."""
    seen = []

    def record(a, x, ws, out_bits, **kw):
        seen.append((kw.get("chunk_occ") is not None, kw.get("blk_sched") is not None,
                     kw.get("resident_a")))
        return jnp.zeros((a.shape[0], a.shape[2], -(-kw["out_cols"] // 8) * 8), jnp.float32)

    monkeypatch.setattr(jfused_model, "fused_model_epoch", record)
    je.zerotile_jump = zerotile_jump
    with contextlib.redirect_stdout(io.StringIO()):
        je.run_epochs_mega(jit, n_epochs=1, resident_a=resident_a)
    return seen[0]


@pytest.mark.parametrize("resident_a,zerotile_jump", [
    (False, None), (False, True), (False, False), (True, None), (True, True), (None, None)])
def test_run_epochs_mega_resident_a_matches_jax(streamed, monkeypatch, resident_a, zerotile_jump):
    ds, it, jds, jit, je, ref = streamed
    te = QGTCEngine(feat_dim=it.feat_dim, num_classes=ds.num_classes, model="gcn", seed=1,
                    zerotile_jump=zerotile_jump, device="cpu")
    te.weights = qmodels.weights_from_jax([np.asarray(w) for w in je.float_weights], 2)
    got = te._mega_logits(it, resident_a=resident_a)
    (info,) = te.mega_buckets
    assert info["skippable"] == pytest.approx(0.4, abs=0.05) and not info["fallback"]
    assert info["resident_a"] is resident_a
    chunk_occ, blk_sched, ra = _jax_choices(monkeypatch, je, jit, zerotile_jump, resident_a)
    assert (info["chunk_occ"], info["compact"]) == (chunk_occ, blk_sched)
    # JAX's static probe resolves None to its resident tier at this shape:
    # the port's None keeps the resident kernel's gate, the same choice
    assert ra is (True if resident_a is None else resident_a)
    if resident_a is False:  # streamed: never a block schedule; the map at >= 30% or forced
        assert not blk_sched and chunk_occ == (zerotile_jump is not False)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), r)
    st = te.run_epochs_mega(it, n_epochs=1, resident_a=resident_a)
    assert st.n_batches == len(it) and te.mega_buckets[0]["chunk_occ"] == chunk_occ


# -- fault 2: the baseline's mega fallback ---------------------------------------


@pytest.mark.parametrize("model", ["sage", "gin"])
def test_baseline_mega_falls_back_to_the_fused_loop(model, monkeypatch):
    """Two buckets (pn 1280 and 768, batches of two batchers over one
    dataset); the plan refuses pn 1280, as it would a shape the kernel
    cannot take: that bucket runs the fused loop, loudly, with
    ``run_epochs_fused``'s logits bit for bit, and the other takes the
    kernel (its plain version here)."""
    ds = graph.synthesize("Proteins", scale=0.05, seed=5)
    its = [graph.ClusterBatcher(ds, ps, 2, **_KW) for ps in (4, 8)]
    it = types.SimpleNamespace(batches=its[0].batches + its[1].batches, features=its[0].features)
    assert {b.padded_nodes for b in it.batches} == {1280, 768}
    plan = fused_model.baseline_plan

    def refuse_1280(a_shape, x_shape, w_shapes):
        if a_shape[1] == 1280:
            raise ValueError("pn=1280 refused")
        return plan(a_shape, x_shape, w_shapes)

    monkeypatch.setattr(fused_model, "baseline_plan", refuse_1280)
    te = BaselineEngine(feat_dim=its[0].feat_dim, num_classes=ds.num_classes, model=model, seed=2,
                        device="cpu")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        got = te._mega_logits(it, ds)
    assert {b["pn"]: b["fallback"] for b in te.mega_buckets} == {1280: True, 768: False}
    assert "baseline bucket pn=1280: falling back to the fused loop (ValueError: pn=1280 refused)" \
        in buf.getvalue()
    fused = {}
    for idx, a, x in te._stage(it, ds, torch.uint8):
        fused.update(zip(idx, te._fused_bucket(a, x)))
    for i, b in enumerate(it.batches):
        if b.padded_nodes == 1280:
            assert torch.equal(got[i], fused[i])
        else:  # the kernel's one launch (its plain version here)
            assert got[i].shape == (b.padded_nodes, ds.num_classes)


def test_baseline_mega_launch_failure_is_not_a_fallback(monkeypatch):
    """Only the plan's refusal is caught: an error of the launch itself
    (here a stand-in raising from the kernel call) stops the epoch."""
    ds = graph.synthesize("Proteins", scale=0.02, seed=5)
    it = graph.ClusterBatcher(ds, 4, 2, bit_width=2, seed=5, partition_method="bfs")
    te = BaselineEngine(feat_dim=it.feat_dim, num_classes=ds.num_classes, device="cpu")

    def broken(*a, **k):
        raise RuntimeError("qgtc_fused_baseline: CUDA launch failed with cudaError 1")

    monkeypatch.setattr(fused_model, "fused_baseline_epoch", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        te._mega_logits(it, ds)
    assert te.mega_buckets and not any(b["fallback"] for b in te.mega_buckets)


# -- fault 3: JAX's argument order for the forwards ------------------------------


def _operands(model, seed=3):
    rng = np.random.default_rng(seed)
    n, feat, hidden, ncls = 512, 128, 16 if model == "gcn" else 64, 40
    qa = (rng.random((n, n)) < 0.03).astype(np.int32)
    qa[256:, :256] = 0  # an empty 256 x 256 tile for the map to skip
    qx = rng.integers(0, 4, (n, feat)).astype(np.int32)
    dims = [feat, hidden, hidden, ncls]
    qws = [rng.integers(0, 4, (dims[i], dims[i + 1])).astype(np.int32) for i in range(3)]
    a = packmm.pack_rows(torch.from_numpy(qa), 1)
    ja = jpackmm.pack_rows(jnp.asarray(qa), 1)
    x, jx = digits.digit_pack(torch.from_numpy(qx), 2), jdigits.digit_pack(jnp.asarray(qx), 2)
    ws = [digits.digit_pack(torch.from_numpy(w), 2) for w in qws]
    jws = [jdigits.digit_pack(jnp.asarray(w), 2) for w in qws]
    tm = packmm.build_tile_map_packed(a, 256, 256)
    jtm = JaxTileMap(kidx=jnp.asarray(tm.kidx.numpy()), kcnt=jnp.asarray(tm.kcnt.numpy()),
                     tile_m=tm.tile_m, tile_k=tm.tile_k)
    return (a, x, ws, tm), (ja, jx, jws, jtm)


@pytest.mark.parametrize("model", ["gcn", "gin"])
def test_forward_signature_is_jax(model):
    (a, x, ws, tm), (ja, jx, jws, jtm) = _operands(model)
    fwd = qmodels.qgcn_forward if model == "gcn" else qmodels.qgin_forward
    jfwd = jqmodels.qgcn_forward if model == "gcn" else jqmodels.qgin_forward
    assert tm.kcnt.tolist() == [2, 1]  # the map skips a tile
    ref = np.asarray(jfwd(ja, jx, jws, 2, jtm))  # JAX: the fifth argument is the tile map
    got = fwd(a, x, ws, 2, tm)
    np.testing.assert_array_equal(got.numpy(), ref)
    by_name = fwd(bit_a=a, bit_x=x, bit_ws=ws, out_bits=2, tile_map=tm, shifts=None, plain=True)
    assert torch.equal(by_name, got)
    sh = [1, 2, 1, 2, 1]
    np.testing.assert_array_equal(fwd(a, x, ws, 2, shifts=sh).numpy(),
                                  np.asarray(jfwd(ja, jx, jws, 2, shifts=sh)))
    with pytest.raises(TypeError):  # shifts and plain are keyword-only
        fwd(a, x, ws, 2, tm, sh)
