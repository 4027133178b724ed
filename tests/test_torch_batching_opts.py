"""The port's batcher options against the JAX package's.

``precalc``, ``feature_scale``, ``quant_bits`` (the narrow-grid wrap
``qx % 2^qb`` and its check against ``bit_width``), ``shuffle``,
``reorder``, ``bucket_rows``, ``rebit`` and ``ClusterBatch.nbytes`` give
the JAX batcher's bytes on the same NumPy-seeded data; ``rebit`` gives a
fresh batcher's; and the baseline engine's step, fused and mega routes
take the precalc-widened features (``--use-pp``) as JAX's does. Tolerance:
exact equality, except the bf16 baseline: per row of logits, max |port -
JAX| <= 2^-6 max |JAX| (``torch_cases.bf16_rel_err``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from qgtc_ppopp22_tpu import graph as jgraph
from qgtc_ppopp22_tpu import runtime as jruntime
from qgtc_ppopp22_tpu_torch import graph
from qgtc_ppopp22_tpu_torch.models import baselines
from qgtc_ppopp22_tpu_torch.models.golden import quantize_np
from qgtc_ppopp22_tpu_torch.ops.bitpack import unpack_bits
from qgtc_ppopp22_tpu_torch.runtime import BaselineEngine
from torch_cases import BF16_REL_TOL, bf16_rel_err
from torch_threads import one_thread  # noqa: F401  (an autouse fixture: one torch thread)


@pytest.fixture(scope="module")
def datasets():
    return (graph.synthesize("Proteins", scale=0.02, seed=6),
            jgraph.synthesize("Proteins", scale=0.02, seed=6))


def _j(planes):
    return np.asarray(planes).view(np.int32)


def _assert_same(it, jit, order=True):
    assert it.feat_dim == jit.feat_dim and it.buckets() == jit.buckets() and len(it) == len(jit)
    assert (it.bit_width, it.quant_bits) == (jit.bit_width, jit.quant_bits)
    np.testing.assert_array_equal(it.features, jit.features)
    for b, jb in zip(it.batches, jit.batches):
        assert (b.num_nodes, b.padded_nodes, b.nbytes()) == (jb.num_nodes, jb.padded_nodes, jb.nbytes())
        assert b.bit_X.shape == jb.bit_X.shape and b.bit_X.bits == jb.bit_X.bits
        np.testing.assert_array_equal(b.nodes, jb.nodes)
        np.testing.assert_array_equal(b.a_words.numpy(), jb.a_words)
        np.testing.assert_array_equal(b.bit_X.planes.numpy(), _j(jb.bit_X.planes))
        np.testing.assert_array_equal(b.tile_kcnt.numpy(), jb.tile_kcnt)
    if order:  # the first epoch's order (iterating draws from the batcher's generator)
        assert [list(b.nodes) for b in it] == [list(b.nodes) for b in jit]


@pytest.mark.parametrize("kw", [
    dict(precalc=True),
    dict(bit_width=8, feature_scale=20.0),
    dict(bit_width=4, quant_bits=2, feature_scale=2.0),
    dict(shuffle=False),
    dict(reorder="none", bucket_rows=256),
    dict(bit_width=8, quant_bits=5, precalc=True, feature_scale=6.0, shuffle=False, reorder="none"),
])
def test_option_matches_jax(datasets, kw):
    ds, jds = datasets
    it = graph.ClusterBatcher(ds, 8, 2, seed=2, **kw)
    jit = jgraph.ClusterBatcher(jds, 8, 2, seed=2, **kw)
    _assert_same(it, jit)
    if kw.get("precalc"):
        assert it.feat_dim == 2 * ds.feat_dim


@pytest.mark.parametrize("bw,qb", [(8, None), (8, 2), (4, 3), (1, None)])
def test_rebit_equals_a_fresh_batcher(datasets, bw, qb):
    ds, jds = datasets
    base = graph.ClusterBatcher(ds, 8, 2, seed=2, feature_scale=5.0)
    it = base.rebit(bw, quant_bits=qb)
    _assert_same(it, jgraph.ClusterBatcher(jds, 8, 2, seed=2, feature_scale=5.0).rebit(bw, quant_bits=qb))
    _assert_same(it, graph.ClusterBatcher(ds, 8, 2, seed=2, feature_scale=5.0, bit_width=bw, quant_bits=qb),
                 order=False)
    for b, b0 in zip(it.batches, base.batches):  # every bit-independent artifact shared
        assert b.a_words is b0.a_words and b.tile_kidx is b0.tile_kidx and b.nodes is b0.nodes
    assert base.bit_width == 2 and base.batches[0].bit_X.bits == 2


def test_quant_bits_and_reorder_checks(datasets):
    ds, _ = datasets
    with pytest.raises(ValueError, match="quant_bits"):
        graph.ClusterBatcher(ds, 8, 2, bit_width=2, quant_bits=4)
    with pytest.raises(ValueError, match="reorder"):
        graph.ClusterBatcher(ds, 8, 2, reorder="metis")
    with pytest.raises(ValueError, match="quant_bits"):
        graph.ClusterBatcher(ds, 8, 2, bit_width=2).rebit(4, quant_bits=8)


def test_narrow_grid_wraps_top_level(datasets):
    """Features on the 2-bit grid that reach level 2^2 = 4 (rounded up from
    3.5-4.0, not clipped) and stay below the clip: packed at 4 bits, the
    level wraps to 0 as a 2-plane pack would, in the port and in JAX."""
    ds, jds = datasets
    rng = np.random.default_rng(9)
    x = rng.choice(np.array([0.0, 0.6, 1.2, 2.0, 2.9, 3.6, 4.0], np.float32), ds.features.shape)
    ds, jds = dataclasses.replace(ds, features=x), dataclasses.replace(jds, features=x)
    it = graph.ClusterBatcher(ds, 8, 2, bit_width=4, quant_bits=2)
    _assert_same(it, jgraph.ClusterBatcher(jds, 8, 2, bit_width=4, quant_bits=2))
    tops = 0
    for b in it.batches:
        q = quantize_np(x[b.nodes], 2)
        assert q.max() == 4 and (x[b.nodes] <= 4.0).all()  # the top level, no clip
        tops += int((q == 4).sum())
        got = unpack_bits(b.bit_X).numpy()[: b.num_nodes]
        np.testing.assert_array_equal(got, q % 4)
    assert tops > 0


@pytest.fixture(scope="module", params=["sage", "gin"])
def precalc_pair(request, datasets):
    ds, jds = datasets
    kw = dict(seed=5, bucket_rows=256, precalc=True)
    it, jit = graph.ClusterBatcher(ds, 4, 2, **kw), jgraph.ClusterBatcher(jds, 4, 2, **kw)
    je = jruntime.BaselineEngine(feat_dim=it.feat_dim, num_classes=ds.num_classes, model=request.param, seed=1)
    te = BaselineEngine(feat_dim=it.feat_dim, num_classes=ds.num_classes, model=request.param, seed=1,
                        device="cpu")
    te.weights = baselines.baseline_weights_from_jax([np.asarray(w) for w in je.weights])
    return ds, it, jds, jit, je, te


def test_precalc_baseline_matches_jax(precalc_pair):
    """Step, fused and mega routes of the baseline read the batcher's
    widened features, and give JAX's logits."""
    ds, it, jds, jit, je, te = precalc_pair
    assert it.feat_dim == 2 * ds.feat_dim
    ref = [np.asarray(je.forward_batch(jb, jds, jit.features)) for jb in jit.batches]
    te.run_epochs(it, ds, n_epochs=1)  # the staged step route fills the cache from the batcher
    step = [te.forward_batch(b, ds) for b in it.batches]
    fused = te._fused_epoch(it, ds)()
    mega = te._mega_logits(it, ds)
    for b, r, s, f, m in zip(it.batches, ref, step, fused, mega):
        x = te._dense(b, ds)[1].numpy()
        np.testing.assert_array_equal(x[: b.num_nodes], it.features[b.nodes])
        assert x.shape[1] == it.feat_dim
        for got in (s, f, m):
            assert bf16_rel_err(got.numpy(), r) <= BF16_REL_TOL
        assert torch.equal(s, f) and torch.equal(s, m)
    assert te.mega_buckets and not any(bk["fallback"] for bk in te.mega_buckets)


def test_precalc_baseline_fresh_engine_mega_first(precalc_pair):
    """A fresh engine whose first call is the mega staging still reads the
    batcher's features (the cache is filled from them)."""
    ds, it, jds, jit, _, _ = precalc_pair
    je = jruntime.BaselineEngine(it.feat_dim, ds.num_classes, seed=1)
    te = BaselineEngine(feat_dim=it.feat_dim, num_classes=ds.num_classes, seed=1, device="cpu")
    te.weights = baselines.baseline_weights_from_jax([np.asarray(w) for w in je.weights])
    for b, jb, m in zip(it.batches, jit.batches, te._mega_logits(it, ds)):
        assert bf16_rel_err(m.numpy(), np.asarray(je.forward_batch(jb, jds, jit.features))) <= BF16_REL_TOL
