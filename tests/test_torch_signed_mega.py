"""Levels-form X through the mega engine of the PyTorch port against JAX.

``fused_model_epoch(..., x_levels_bits=b)`` (its plain version here, on
the CPU) against the JAX ``fused_model_epoch`` in Pallas interpret mode
and the NumPy golden chains, in both of the JAX kernel's forms: the
offset-signed single-plane chain (every weight has a free padded lane)
and the in-kernel digit split (some weight has none). Cases mirror
``tests/test_signed_mega.py``: saturating and linear-range data (the
latter guarded so that no stage hides on the requantize rail), feature
widths 100 (JAX's "ones" mode) and 128 ("deg" mode), single-layer GIN and
the zero-block forms. Then the engine's ``shifts`` and ``clamp_bits``,
and its 8-bit mega path against its step engine and JAX's engine.

The linear-range operands and their guard are ``tests/test_signed_mega.py``'s.
Tolerance: exact equality. The logits are compared on every stored
column: the cases store ``out_cols`` below the last padded column, the
one where the JAX signed kernel keeps its ones-lane bookkeeping.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgtc_ppopp22_tpu import graph as jgraph
from qgtc_ppopp22_tpu.models.qmodels import qgcn_golden, qgin_golden
from qgtc_ppopp22_tpu.ops import digits as jdigits
from qgtc_ppopp22_tpu.ops.fused_model import fused_model_epoch as jax_fused_model_epoch
from qgtc_ppopp22_tpu.ops.packmm import pack_rows_np
from qgtc_ppopp22_tpu.runtime import QGTCEngine as JaxEngine
from qgtc_ppopp22_tpu.runtime import mega_block_occ as jax_block_occ
from qgtc_ppopp22_tpu.runtime import mega_block_sched as jax_block_sched
from qgtc_ppopp22_tpu_torch import cli, graph
from qgtc_ppopp22_tpu_torch.models import qmodels
from qgtc_ppopp22_tpu_torch.ops import digits
from qgtc_ppopp22_tpu_torch.ops.bitpack import unpack_bits
from qgtc_ppopp22_tpu_torch.ops.fused_model import fused_model_epoch, plan, signed_weights
from qgtc_ppopp22_tpu_torch.ops.packmm import packed_levels
from qgtc_ppopp22_tpu_torch.runtime import QGTCEngine
from test_signed_mega import _LINEAR_SHIFTS, _assert_linear_chain, _linear_case
from torch_cases import chain_shifts, levels_plane, mega_case
from torch_threads import one_thread  # noqa: F401  (an autouse fixture: one torch thread)


def _levels(qx, bits, xp=128):
    """Levels [B, pn, feat] -> levels-form X int8[B, 1, pn, xp]."""
    xl = np.zeros(qx.shape[:2] + (xp,), np.int32)
    xl[:, :, :qx.shape[2]] = qx & ((1 << bits) - 1)
    return xl.astype(np.uint8).view(np.int8)[:, None]


def _both(aw, xl, qws, bits, **kw):
    """The port's and JAX's logits, float32[B, pn, oc] as numpy."""
    ws = [digits.digit_pack(torch.from_numpy(w), bits) for w in qws]
    jws = [jdigits.digit_pack(jnp.asarray(w), bits) for w in qws]
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    got = fused_model_epoch(torch.from_numpy(aw), torch.from_numpy(xl), ws, bits, **tkw)
    ref = np.asarray(jax_fused_model_epoch(jnp.asarray(aw), jnp.asarray(xl), jws, bits, **jkw))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    return got.numpy(), ref


def _form(aw, xl, qws, bits, model):
    ws = [digits.digit_pack(torch.from_numpy(w), bits) for w in qws]
    return plan(aw.shape, xl.shape, ws, bits, model, None, None, x_levels_bits=bits).form


def _golden(model, qa, qx, qws, bits, out_bits=None, shifts=None):
    fn = qgcn_golden if model == "gcn" else qgin_golden
    return fn(qa, qx, qws, bits, out_bits or bits, shifts=shifts).astype(np.float32)


# -- the kernel's function -------------------------------------------------


@pytest.mark.parametrize("shifts", [None, (2, 1, 0, 1, 2)])
@pytest.mark.parametrize("hid,cls", [(16, 12), (64, 40)])
@pytest.mark.parametrize("model", ["gcn", "gin"])
def test_levels_saturating(model, hid, cls, shifts):
    """Uniform 0-255 data: the requantize rails, signed form."""
    bits, pn, xdim = 8, 256, 100
    rng = np.random.default_rng(hid + cls)
    qa = (rng.random((pn, pn)) < 0.02).astype(np.int32)
    qx = rng.integers(0, 256, (pn, xdim)).astype(np.int32)
    qws = [rng.integers(0, 256, s).astype(np.int32) for s in ((xdim, hid), (hid, hid), (hid, cls))]
    aw, xl = pack_rows_np(qa, 1)[0][None], _levels(qx[None], bits)
    assert _form(aw, xl, qws, bits, model) == "signed"
    got, ref = _both(aw, xl, qws, bits, model=model, x_cols=xdim, x_levels_bits=bits,
                     out_cols=cls, shifts=shifts)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[0, :, :cls], _golden(model, qa, qx, qws, bits, shifts=shifts))


@pytest.mark.parametrize("xdim", [100, 128])
@pytest.mark.parametrize("model", ["gcn", "gin"])
def test_levels_linear(model, xdim):
    """Linear-range data: xdim 128 is GIN's "deg" case (no free X lane),
    100 its "ones" case; the port takes both degrees from the A tiles."""
    bits, pn, hid, cls = 8, 256, 64, 40
    qa, qx, qws = _linear_case(np.random.default_rng(xdim), pn, xdim, hid, cls)
    _assert_linear_chain(model, qa, qx, qws, bits, _LINEAR_SHIFTS)
    aw, xl = pack_rows_np(qa, 1)[0][None], _levels(qx[None], bits)
    got, ref = _both(aw, xl, qws, bits, model=model, x_cols=xdim, x_levels_bits=bits,
                     out_cols=cls, shifts=_LINEAR_SHIFTS)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[0, :, :cls],
                                  _golden(model, qa, qx, qws, bits, shifts=_LINEAR_SHIFTS))
    assert len(np.unique(ref)) > 50


def test_levels_gin_single_layer_feat128():
    """One-layer GIN: the first aggregation's store reaches the logits
    through a single update."""
    bits, pn, xdim, hid = 8, 256, 128, 64
    rng = np.random.default_rng(1)
    qa = (rng.random((pn, pn)) < 0.02).astype(np.int32)
    qx = rng.integers(0, 4, (pn, xdim)).astype(np.int32)
    qw = (rng.random((xdim, hid)) < 0.1).astype(np.int32)
    aw, xl = pack_rows_np(qa, 1)[0][None], _levels(qx[None], bits)
    got, ref = _both(aw, xl, [qw], bits, model="gin", x_cols=xdim, x_levels_bits=bits,
                     out_cols=hid)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[0, :, :hid], _golden("gin", qa, qx, [qw], bits))


@pytest.mark.parametrize("zero", ["chunk_occ", "blk_sched"])
@pytest.mark.parametrize("model,xdim", [("gcn", 100), ("gin", 128)])
def test_levels_zero_blocks(model, xdim, zero):
    """The zero-block forms at 8 bits: blocks a map skips drop their
    product and their degree together."""
    bits, pn, hid, cls = 8, 512, 64, 40
    rng = np.random.default_rng(7)
    qa = np.zeros((pn, pn), np.int32)
    qa[:256, :256] = (rng.random((256, 256)) < 0.05).astype(np.int32)
    _, qx, qws = _linear_case(np.random.default_rng(3), pn, xdim, hid, cls)
    aw = pack_rows_np(qa, 1)
    occ = jax_block_occ(aw, 512, 256)[None]
    assert occ.sum() < occ.size  # blocks actually skip
    amap = occ if zero == "chunk_occ" else jax_block_sched(aw, 512, 256)[None]
    kw = {zero: amap, "resident_a": True} if zero == "blk_sched" else {zero: amap}
    got, ref = _both(aw[0][None], _levels(qx[None], bits), qws, bits, model=model,
                     x_cols=xdim, x_levels_bits=bits, out_cols=cls, shifts=_LINEAR_SHIFTS, **kw)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[0, :, :cls],
                                  _golden(model, qa, qx, qws, bits, shifts=_LINEAR_SHIFTS))


def test_levels_schedule_drops_listed_blocks_degree():
    """A schedule that leaves out an occupied block: the degree of the
    visited blocks only, as in the JAX kernel (a degree over the whole row
    would differ)."""
    bits, pn = 8, 512
    qa, qx, qws, aw, xd = mega_case(11, 1, pn, bits, 16, shift=1)
    sched = np.array([[[1, 1, 0]]], np.int32)  # block 1 of 2 only
    got, ref = _both(aw, levels_plane(xd), qws, bits, model="gcn", x_cols=128, x_levels_bits=bits,
                     out_cols=40, shifts=[1, 2, 1, 2, 1], blk_sched=sched)
    np.testing.assert_array_equal(got, ref)
    kept = qa.copy()
    kept[:, :, :256] = 0
    np.testing.assert_array_equal(got[0, :, :40],
                                  _golden("gcn", kept[0], qx[0], qws, bits, shifts=[1, 2, 1, 2, 1]))


@pytest.mark.parametrize("model", ["gcn", "gin"])
def test_levels_split_form(model):
    """Hidden 128 leaves W1 and W2 no free lane: the JAX kernel splits
    the levels into digits and runs the digit chain."""
    bits, pn = 8, 256
    qa, qx, qws, aw, xd = mega_case(5, 1, pn, bits, 128, shift=1)
    xl = levels_plane(xd)
    assert _form(aw, xl, qws, bits, model) == "split"
    sh = [1, 2, 1, 2, 1]
    got, ref = _both(aw, xl, qws, bits, model=model, x_cols=128, x_levels_bits=bits, shifts=sh)
    np.testing.assert_array_equal(got, ref)  # the whole padded output
    np.testing.assert_array_equal(got[0, :, :40], _golden(model, qa[0], qx[0], qws, bits, shifts=sh))
    assert len(np.unique(ref)) > 4


@pytest.mark.parametrize("hidden", [16, 128])
def test_levels_five_bits(hidden):
    """5-bit levels: the signed form (hidden 16) and the split form with a
    one-bit second digit (hidden 128)."""
    bits, pn = 5, 256
    qa, qx, qws, aw, xd = mega_case(bits, 1, pn, bits, hidden)
    xl = levels_plane(xd)
    assert _form(aw, xl, qws, bits, "gcn") == ("signed" if hidden == 16 else "split")
    got, ref = _both(aw, xl, qws, bits, model="gcn", x_cols=128, x_levels_bits=bits, out_cols=40)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[0, :, :40], _golden("gcn", qa[0], qx[0], qws, bits))
    assert len(np.unique(ref)) > 4


@pytest.mark.parametrize("hidden", [16, 128])
@pytest.mark.parametrize("model", ["gcn", "gin"])
def test_levels_clamp_bits_below_bit_width(model, hidden):
    """8-bit levels and weights requantized to 4-bit hidden layers: the
    signed form stores one plane of level - 128 where the digit route
    stores one 4-bit digit."""
    bits, out_bits, pn = 8, 4, 256
    qa, qx, qws, aw, xd = mega_case(21, 1, pn, bits, hidden, shift=2)
    sh, shares, logits = chain_shifts(qa[0], qx[0], qws, model, out_bits)
    assert min(shares) > 0.5
    ws = [digits.digit_pack(torch.from_numpy(w), bits) for w in qws]
    jws = [jdigits.digit_pack(jnp.asarray(w), bits) for w in qws]
    xl = levels_plane(xd)
    kw = dict(model=model, x_cols=128, x_levels_bits=bits, out_cols=40, shifts=sh)
    got = fused_model_epoch(torch.from_numpy(aw), torch.from_numpy(xl), ws, out_bits, **kw).numpy()
    ref = np.asarray(jax_fused_model_epoch(jnp.asarray(aw), jnp.asarray(xl), jws, out_bits, **kw))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[0, :, :40],
                                  _golden(model, qa[0], qx[0], qws, bits, out_bits, sh))
    np.testing.assert_array_equal(got[0, :, :40], logits.astype(np.float32))
    assert len(np.unique(ref)) > 4


@pytest.mark.parametrize("model", ["gcn", "gin"])
def test_levels_three_batches_odd_remainder(model):
    """B = 3 at pn 768 (chunks of 256, 12 row tiles over a cluster of 8)
    and hidden 48 (a 64- and a 32-column tile per layer)."""
    bits, pn = 8, 768
    qa, qx, qws, aw, xd = mega_case(33, 3, pn, bits, 48, shift=1)
    sh = [1, 2, 1, 2, 1]
    got, ref = _both(aw, levels_plane(xd), qws, bits, model=model, x_cols=128, x_levels_bits=bits,
                     out_cols=40, shifts=sh)
    np.testing.assert_array_equal(got, ref)
    for b in range(3):
        np.testing.assert_array_equal(got[b, :, :40], _golden(model, qa[b], qx[b], qws, bits, shifts=sh))


@pytest.mark.parametrize("k", [70, 96, 128])
def test_signed_weights_correction_rows(k):
    """The signed operands' algebra over any K from the weight's real rows
    (70) to its padded ones: Hs Ws[:K] + 128 rowsum(Hs) + corr == H W[:K]
    in int64, whatever Hs holds in the columns past the real rows (they
    meet level 0). The kernel contracts the real widths rounded to 32
    (its column granule, 16, rounded to the mma's depth)."""
    rng = np.random.default_rng(k)
    qw = rng.integers(0, 256, (70, 90))
    w = digits.digit_pack(torch.from_numpy(qw), 8)
    (plane,), (corr,) = signed_weights([w])
    assert plane.shape == (128, 128) and plane.dtype == torch.int8 and corr.shape == (128,)
    h = rng.integers(0, 256, (64, k))
    h[:, 70:] = rng.integers(0, 256, (64, max(k - 70, 0)))  # garbage past the real rows
    hs = torch.from_numpy(h - 128)
    lhs = hs @ plane[:k].to(torch.int64) + (hs.sum(dim=1, keepdim=True) << 7) + corr.to(torch.int64)
    wl = np.zeros((128, 128), np.int64)
    wl[:70, :90] = qw
    np.testing.assert_array_equal(lhs.numpy(), h @ wl[:k])


def test_levels_plan_checks():
    _, _, qws, aw, xd = mega_case(0, 1, 512, 8, 16)
    ws = [digits.digit_pack(torch.from_numpy(w), 8) for w in qws]
    with pytest.raises(ValueError, match="x_levels_bits given but x_stack has 2 planes"):
        plan(aw.shape, xd.shape, ws, 8, "gcn", None, None, x_levels_bits=8)
    for bad in (0, 9):
        with pytest.raises(ValueError, match=r"x_levels_bits must be in \[1, 8\]"):
            plan(aw.shape, levels_plane(xd).shape, ws, 8, "gcn", None, None, x_levels_bits=bad)
    p = plan(aw.shape, levels_plane(xd).shape, ws, 8, "gcn", None, None, x_levels_bits=8)
    assert (p.form, p.x_bits, p.nd_x, p.widths) == ("signed", 8, 2, [16, 16, 128])
    # 1-4-bit levels: one digit (JAX's x_split masks it to the bits)
    p = plan(aw.shape, levels_plane(xd).shape, ws, 8, "gcn", None, None, x_levels_bits=4)
    assert (p.form, p.x_bits, p.nd_x) == ("signed", 4, 1)


# -- the engine: shifts, clamp_bits and the 8-bit mega path ------------------

SHIFTS = {"gcn": (4, 2, 11, 2, 11), "gin": (0, 6, 3, 13, 2)}  # chain_shifts on batch 0


def _engine_pair(model, bit_width=8, **ekw):
    kw = dict(bit_width=bit_width, seed=5, bucket_rows=256, partition_method="bfs")
    ds = graph.synthesize("Proteins", scale=0.02, seed=5)
    jds = jgraph.synthesize("Proteins", scale=0.02, seed=5)
    it, jit = graph.ClusterBatcher(ds, 4, 2, **kw), jgraph.ClusterBatcher(jds, 4, 2, **kw)
    je = JaxEngine(feat_dim=it.feat_dim, num_classes=ds.num_classes, model=model, seed=1,
                   bit_width=bit_width, **ekw)
    te = QGTCEngine(feat_dim=it.feat_dim, num_classes=ds.num_classes, model=model, seed=1,
                    bit_width=bit_width, device="cpu", **ekw)
    te.weights = qmodels.weights_from_jax([np.asarray(w) for w in je.float_weights], bit_width)
    return ds, it, jit, je, te


def _jax_levels_mega_logits(je, jit):
    """The JAX engine's 5-8-bit mega path (runtime.py:504-516): digit
    planes collapsed to levels, one fused_model_epoch per bucket."""
    out = [None] * len(jit.batches)
    where = {id(b): i for i, b in enumerate(jit.batches)}
    for _, bs, a_np, x_np, _, _ in je._fused_groups(jit):
        x = jdigits.planes_stack_to_digits(jnp.asarray(x_np), bs[0].bit_X.shape, je.bit_width)
        xl = (x[:, 0].astype(jnp.int32) | (x[:, 1].astype(jnp.int32) << 4)).astype(jnp.int8)[:, None]
        res = np.asarray(jax_fused_model_epoch(
            jnp.asarray(a_np[:, 0]), xl, je.weights, je.clamp_bits, model=je.model,
            shifts=je.shifts, out_cols=je.cfg.out_dim, x_cols=je.cfg.in_dim,
            x_levels_bits=je.bit_width))
        for b, r in zip(bs, res):
            out[where[id(b)]] = r
    return out


@pytest.mark.parametrize("model", ["gcn", "gin"])
def test_engine_levels_mega_matches_step_and_jax(model):
    ds, it, jit, je, te = _engine_pair(model, shifts=SHIFTS[model])
    got = te._mega_logits(it)
    assert te.mega_buckets and all(i["form"] == "signed" and not i["fallback"] and not i["compact"]
                                   for i in te.mega_buckets)
    ref = _jax_levels_mega_logits(je, jit)
    for b, g, s, r in zip(it.batches, got, te.forward_all(it), ref):
        n, c = b.num_nodes, ds.num_classes
        np.testing.assert_array_equal(g.numpy(), r)
        assert torch.equal(g[:n, :c], s[:n, :c])
    # the shifts keep batch 0's chain off the rail
    b0 = it.batches[0]
    a0 = packed_levels(te.put_batch(b0)[0]).numpy()
    x0 = np.zeros((a0.shape[0], it.feat_dim), np.int64)
    x0[:b0.bit_X.shape[0]] = unpack_bits(b0.bit_X).numpy()
    qws = [digits.digit_unpack(w).numpy() for w in te.weights]
    sh, shares, logits = chain_shifts(a0, x0, qws, model, 8, rows=b0.num_nodes)
    assert tuple(sh) == SHIFTS[model] and min(shares) > 0.5
    np.testing.assert_array_equal(got[0][:, :ds.num_classes].numpy(),
                                  logits[:, :ds.num_classes].astype(np.float32))


@pytest.mark.parametrize("clamp_bits", [None, 4])
@pytest.mark.parametrize("model", ["gcn", "gin"])
def test_engine_shifts_clamp_bits_match_jax_step(model, clamp_bits):
    sh = (2, 1, 3, 1, 2)
    ds, it, jit, je, te = _engine_pair(model, shifts=sh, clamp_bits=clamp_bits)
    assert te.clamp_bits == je.clamp_bits == (clamp_bits or 8) and te.shifts == sh
    for b, jb in zip(it.batches, jit.batches):
        n, c = b.num_nodes, ds.num_classes
        got = te.forward_batch(b)
        np.testing.assert_array_equal(got[:n, :c].numpy(), np.asarray(je.forward_batch(jb))[:n, :c])
    mega = te._mega_logits(it)
    for b, g, s in zip(it.batches, mega, te.forward_all(it)):
        assert torch.equal(g[:b.num_nodes, :ds.num_classes], s[:b.num_nodes, :ds.num_classes])


def test_engine_refuses_clamp_bits_above_bit_width_and_shifted_bits():
    with pytest.raises(ValueError, match="clamp_bits must be <= bit_width"):
        QGTCEngine(feat_dim=16, num_classes=4, bit_width=4, clamp_bits=8, device="cpu")
    with pytest.raises(ValueError, match="clamp_bits must be <= bit_width"):
        JaxEngine(feat_dim=16, num_classes=4, bit_width=4, clamp_bits=8)
    ds, it, _, _, _ = _engine_pair("gcn", bit_width=2)
    eng = QGTCEngine(feat_dim=it.feat_dim, num_classes=ds.num_classes, bit_width=2, fmt="bits",
                     shifts=(1, 0, 0, 0, 0), device="cpu")
    with pytest.raises(NotImplementedError, match="scaled requant is only on the digit path"):
        eng.forward_batch(it.batches[0])


def _toy_npz(path):
    rng = np.random.default_rng(0)
    np.savez(path / "toy.npz", src_li=rng.integers(0, 600, 3000), dst_li=rng.integers(0, 600, 3000))


@pytest.mark.parametrize("model", [[], ["--run_GIN"]])
def test_cli_mega_mode_eight_bits(tmp_path, monkeypatch, capsys, model):
    _toy_npz(tmp_path)
    monkeypatch.chdir(tmp_path)
    rc = cli.main(["--dataset", "toy", "--data-dir", str(tmp_path), "--psize", "4",
                   "--batch-size", "2", "--n-epochs", "2", "--device", "cpu", "--use_QGTC",
                   "--mode", "mega", "--bit_width", "8", *model])
    assert rc == 0
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert record["engine"] == "qgtc-mega" and record["bit_width"] == 8 and record["avg_epoch_ms"] > 0
    assert all(b["form"] == "signed" and not b["fallback"] for b in record["buckets"])
