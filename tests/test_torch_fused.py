"""The fused and quant-in-loop epoch engines of the PyTorch port against JAX.

``QGTCEngine._fused_logits`` (every bucket staged on the device once, the
epoch's chains captured as one CUDA graph on a card; on the CPU the same
chains on the plain versions) against the JAX engine's scanned epoch,
``_fused_epoch_fn`` (``runtime.py:259-301``), in Pallas interpret mode,
over two shape buckets: GCN and GIN, 2 and 8 bits, ``zerotile_jump`` None
and True, the unscaled requantize and shifts from
``torch_cases.chain_shifts``. Then quant-in-loop against JAX's
``run_epochs_quant_in_loop`` epoch and the fused logits, a mega bucket
that the plan refuses against the fused logits and the baseline's fused
loop (the CLI's flags and the bench script: ``test_torch_fused_cli.py``).

Tolerance: exact equality over each batch's real nodes and classes.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgtc_ppopp22_tpu import graph as jgraph
from qgtc_ppopp22_tpu import runtime as jruntime
from qgtc_ppopp22_tpu.runtime import QGTCEngine as JaxEngine
from qgtc_ppopp22_tpu_torch import graph
from qgtc_ppopp22_tpu_torch.models import qmodels
from qgtc_ppopp22_tpu_torch.ops import digits, fused_model
from qgtc_ppopp22_tpu_torch.ops.bitpack import unpack_bits
from qgtc_ppopp22_tpu_torch.ops.packmm import packed_levels
from qgtc_ppopp22_tpu_torch.runtime import BaselineEngine, QGTCEngine
from torch_cases import chain_shifts
from torch_threads import one_thread  # noqa: F401  (an autouse fixture: one torch thread)

_KW = dict(seed=5, bucket_rows=256, partition_method="bfs")


class _Batches(types.SimpleNamespace):
    def __len__(self):
        return len(self.batches)


def _batches(mod, bits):
    """Two buckets over one dataset (Proteins at scale 0.02): two batches
    at pn 512 and two at pn 256, from two batchers of ``mod``'s graph
    package."""
    ds = mod.synthesize("Proteins", scale=0.02, seed=5)
    big, small = (mod.ClusterBatcher(ds, ps, 2, bit_width=bits, **_KW) for ps in (4, 8))
    it = _Batches(batches=big.batches + small.batches[:2], features=big.features, feat_dim=big.feat_dim)
    return ds, it


@pytest.fixture(scope="module")
def buckets():
    """The port's and JAX's batches at 2 and 8 bits."""
    out = {}
    for bits in (2, 8):
        ds, it = _batches(graph, bits)
        _, jit = _batches(jgraph, bits)
        assert [b.padded_nodes for b in it.batches] == [512, 512, 256, 256]
        out[bits] = ds, it, jit
    return out


def _shifts(it, model, bits, float_weights):
    """chain_shifts on batch 0 (more than half of each stage's levels
    below the rail)."""
    b0 = it.batches[0]
    a0 = packed_levels(QGTCEngine(feat_dim=it.feat_dim, num_classes=2, device="cpu").put_batch(b0)[0]).numpy()
    x0 = np.zeros((a0.shape[0], it.feat_dim), np.int64)
    x0[:b0.bit_X.shape[0]] = unpack_bits(b0.bit_X).numpy()
    qws = [digits.digit_unpack(w).numpy() for w in qmodels.weights_from_jax(float_weights, bits)]
    sh, shares, _ = chain_shifts(a0, x0, qws, model, bits, rows=b0.num_nodes)
    assert min(shares) > 0.5
    return tuple(sh)


def _pair(buckets, model, bits, shifts, zerotile_jump):
    """The JAX engine and the port's on the same weights and options."""
    ds, it, jit = buckets[bits]
    kw = dict(feat_dim=it.feat_dim, num_classes=ds.num_classes, model=model, seed=1, bit_width=bits,
              zerotile_jump=zerotile_jump)
    if shifts == "chain":
        kw["shifts"] = _shifts(it, model, bits, [np.asarray(w) for w in JaxEngine(**kw).float_weights])
    je = JaxEngine(**kw)
    te = QGTCEngine(device="cpu", **kw)
    te.weights = qmodels.weights_from_jax([np.asarray(w) for w in je.float_weights], bits)
    return ds, it, jit, je, te


@pytest.fixture(scope="module")
def fused_logits():
    """The port's fused logits of each (model, bits, shifts, zerotile_jump)
    pair, computed once in the module: ``get(key, te, it)``."""
    seen = {}

    def get(key, te, it):
        if key not in seen:
            seen[key] = te._fused_logits(it)
        return seen[key]

    return get


def _jax_fused_logits(je, jit):
    """Each batch's logits from JAX's scanned epoch, ``_fused_epoch_fn``
    over the stacks ``run_epochs_fused`` stages (runtime.py:303-324)."""
    out, where = [None] * len(jit.batches), {id(b): i for i, b in enumerate(jit.batches)}
    for key, bs, a_stack, x_stack, kidx, kcnt in je._fused_groups(jit):
        stacks = (jnp.asarray(a_stack), jnp.asarray(x_stack))
        if kidx is not None:
            stacks += (jnp.asarray(kidx), jnp.asarray(kcnt))
        res = np.asarray(je._fused_epoch_fn(key[0], bs[0].bit_X.shape)(stacks, tuple(je.weights)))
        for b, r in zip(bs, res):
            out[where[id(b)]] = r
    return out


def _assert_logits(it, ds, got, want):
    for b, g, w in zip(it.batches, got, want):
        n, c = b.num_nodes, ds.num_classes
        np.testing.assert_array_equal(np.asarray(g[:n, :c]), np.asarray(w[:n, :c]))


@pytest.mark.parametrize("bits,shifts,zerotile_jump", [
    (2, None, None), (2, None, True), (2, "chain", None), (8, "chain", None), (8, "chain", True)])
@pytest.mark.parametrize("model", ["gcn", "gin"])
def test_fused_logits_match_jax(buckets, fused_logits, model, bits, shifts, zerotile_jump):
    ds, it, jit, je, te = _pair(buckets, model, bits, shifts, zerotile_jump)
    assert te.shifts == je.shifts and (shifts is None) == (te.shifts is None)
    got = fused_logits((model, bits, shifts, zerotile_jump), te, it)
    _assert_logits(it, ds, got, _jax_fused_logits(je, jit))
    for g, s in zip(got, te.forward_all(it)):  # the step engine's chain, bit for bit
        assert torch.equal(g, s)
    groups = te._fused_groups(it)
    assert [len(g[1]) for g in groups] == [2, 2]
    assert all((g[4] is None) == (zerotile_jump is None) for g in groups)


def _jax_quant_in_loop_logits(je, jit, monkeypatch):
    """The logits of JAX's ``run_epochs_quant_in_loop`` epoch: its epoch
    function, called once on its staged stacks (runtime.py:404-424)."""
    seen = {}

    def record(one_epoch, n_epochs, n_batches, sync_every_epoch, device_fn=None, device_args=None):
        seen["outs"] = device_fn(*device_args)
        return jruntime.EpochStats(epoch_ms=[0.0], n_batches=n_batches)

    monkeypatch.setattr(jruntime, "_timed_epochs", record)
    je.run_epochs_quant_in_loop(jit, n_epochs=1)
    out, where = [None] * len(jit.batches), {id(b): i for i, b in enumerate(jit.batches)}
    for (_, bs, *_), res in zip(je._fused_groups(jit), seen["outs"]):
        for b, r in zip(bs, np.asarray(res)):
            out[where[id(b)]] = r
    return out


@pytest.mark.parametrize("model,bits,shifts,zerotile_jump", [
    ("gcn", 2, None, None), ("gin", 8, "chain", True)])
def test_quant_in_loop_matches_jax_and_fused(buckets, fused_logits, monkeypatch, model, bits, shifts,
                                             zerotile_jump):
    ds, it, jit, je, te = _pair(buckets, model, bits, shifts, zerotile_jump)
    got = te._fused_logits(it, quant_in_loop=True)
    _assert_logits(it, ds, got, _jax_quant_in_loop_logits(je, jit, monkeypatch))
    for g, f in zip(got, fused_logits((model, bits, shifts, zerotile_jump), te, it)):
        assert torch.equal(g, f)
    st = te.run_epochs_quant_in_loop(it, n_epochs=2)
    assert st.n_batches == 4 and st.avg_ms > 0 and st.launch_sync_ms == st.avg_ms


@pytest.mark.parametrize("zerotile_jump", [None, True])
def test_refused_mega_bucket_runs_the_fused_epoch(buckets, fused_logits, monkeypatch, capsys, zerotile_jump):
    """The plan refuses pn 512: that bucket runs its fused epoch, loudly,
    and records ``fallback``; pn 256 takes the kernel (its plain version)."""
    ds, it, _, _, te = _pair(buckets, "gcn", 2, None, zerotile_jump)
    plan = fused_model.plan

    def refuse_512(a_shape, *args, **kw):
        if a_shape[-1] == 512:
            raise ValueError("pn=512 refused")
        return plan(a_shape, *args, **kw)

    monkeypatch.setattr(fused_model, "plan", refuse_512)
    got = te._mega_logits(it)
    assert "[mega] bucket pn=512: falling back to the captured fused epoch (ValueError: pn=512 refused)" \
        in capsys.readouterr().out
    assert {b["pn"]: b["fallback"] for b in te.mega_buckets} == {512: True, 256: False}
    _assert_logits(it, ds, got, fused_logits(("gcn", 2, None, zerotile_jump), te, it))
    st = te.run_epochs_mega(it, n_epochs=1, sync_every_epoch=True)
    assert st.n_batches == 4 and len(st.epoch_ms) == 1 and st.launch_sync_ms == 0


def test_fused_mode_refuses_bits():
    eng = QGTCEngine(feat_dim=16, num_classes=4, fmt="bits", device="cpu")
    for run in (eng.run_epochs_fused, eng.run_epochs_quant_in_loop):
        with pytest.raises(ValueError, match="requires fmt='digits'"):
            run(types.SimpleNamespace(batches=[], features=None), n_epochs=1)


def test_measure_transfer_ms(buckets):
    _, it, _, _, te = _pair(buckets, "gcn", 2, None, True)
    assert te.measure_transfer_ms(it, n_rounds=2) > 0


@pytest.mark.parametrize("model", ["sage", "gin"])
def test_baseline_fused_epoch_is_the_fused_loop(buckets, model):
    ds, it, _ = buckets[2]
    te = BaselineEngine(feat_dim=it.feat_dim, num_classes=ds.num_classes, model=model, seed=2, device="cpu")
    got = te._fused_epoch(it, ds)()
    loop = {}
    for idx, a, x in te._stage(it, ds, torch.uint8):
        loop.update(zip(idx, te._fused_bucket(a, x)))
    assert len(got) == 4 and all(torch.equal(g, loop[i]) for i, g in enumerate(got))
    st = te.run_epochs_fused(it, ds, n_epochs=1, sync_every_epoch=True)
    assert st.n_batches == 4 and len(st.epoch_ms) == 1
