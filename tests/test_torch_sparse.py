"""The port's full-graph sparse engine and golden forwards against the JAX package's.

``sparse_q_forward`` (GCN and GIN, with and without requantize shifts)
against JAX's and against the port's NumPy ``qgcn_golden`` /
``qgin_golden`` over the dense adjacency; those goldens against JAX's;
and ``SparseEngine`` (JAX's float weights carried across) against JAX's
engine: logits, accuracy, F1 and the epoch record. Inputs come from NumPy
seeds. Tolerance: exact equality throughout (integer semantics).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgtc_ppopp22_tpu import graph as jgraph
from qgtc_ppopp22_tpu import runtime as jruntime
from qgtc_ppopp22_tpu.models import qmodels as jqmodels
from qgtc_ppopp22_tpu.models.sparse import sparse_q_forward as jax_sparse_q_forward
from qgtc_ppopp22_tpu_torch import graph
from qgtc_ppopp22_tpu_torch.models import golden, qmodels
from qgtc_ppopp22_tpu_torch.models.sparse import sparse_aggregate_levels, sparse_q_forward
from qgtc_ppopp22_tpu_torch.runtime import SparseEngine
from torch_threads import one_thread  # noqa: F401  (an autouse fixture: one torch thread)

SHIFTS = {"none": None, "gcn": [1, 2, 0, 1, 0], "gin": [2, 0, 1, 0, 1]}


@pytest.fixture(scope="module")
def data():
    ds = graph.synthesize("Proteins", scale=0.01, seed=3)
    rng = np.random.default_rng(7)
    qa = ds.graph.to_scipy().toarray().astype(np.int64)
    return ds, qa, rng


def _levels(rng, ds, bits, hidden=16):
    dims = [ds.feat_dim, hidden, hidden, ds.num_classes]
    qx = golden.quantize_np(rng.uniform(-1, (1 << bits) + 1, ds.features.shape), bits)
    qws = [golden.quantize_np(rng.uniform(0, 1 << bits, (dims[i], dims[i + 1])), bits) for i in range(3)]
    return qx, qws


@pytest.mark.parametrize("model", ["gcn", "gin"])
@pytest.mark.parametrize("bits", [1, 2, 4])
@pytest.mark.parametrize("shifted", [False, True])
def test_sparse_q_forward_matches_jax_and_golden(data, model, bits, shifted):
    ds, qa, rng = data
    qx, qws = _levels(rng, ds, bits)
    sh = SHIFTS[model] if shifted else None
    g = ds.graph
    got = sparse_q_forward(torch.from_numpy(g.indptr.astype(np.int64)), torch.from_numpy(g.indices.astype(np.int64)),
                           torch.from_numpy(qx), [torch.from_numpy(w) for w in qws], bits, model, sh)
    want = jax_sparse_q_forward(jnp.asarray(g.indptr), jnp.asarray(g.indices), jnp.asarray(qx),
                                [jnp.asarray(w) for w in qws], bits, model, sh)
    gold = (qmodels.qgcn_golden if model == "gcn" else qmodels.qgin_golden)(qa, qx, qws, bits, bits, sh)
    assert got.dtype == torch.float32 and got.shape == (ds.num_nodes, ds.num_classes)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), gold.astype(np.float32))
    assert (got != 0).any()


@pytest.mark.parametrize("model", ["gcn", "gin"])
@pytest.mark.parametrize("shifted", [False, True])
def test_goldens_match_jax(data, model, shifted):
    ds, qa, rng = data
    qx, qws = _levels(rng, ds, 2)
    sh = SHIFTS[model] if shifted else None
    name = f"q{model}_golden"
    np.testing.assert_array_equal(getattr(qmodels, name)(qa, qx, qws, 2, 2, sh),
                                  getattr(jqmodels, name)(qa, qx, qws, 2, 2, sh))


def test_sparse_aggregate_levels_is_the_dense_product(data):
    ds, qa, rng = data
    h = rng.integers(0, 16, (ds.num_nodes, 5)).astype(np.int32)
    g = ds.graph
    got = sparse_aggregate_levels(torch.from_numpy(g.indptr.astype(np.int64)),
                                  torch.from_numpy(g.indices.astype(np.int64)), torch.from_numpy(h), ds.num_nodes)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), qa @ h)


@pytest.mark.parametrize("model,shifts", [("gcn", None), ("gin", None), ("gcn", [1, 0, 1, 0, 0])])
def test_sparse_engine_matches_jax(model, shifts):
    ds = graph.synthesize("ppi", scale=0.01, seed=2)
    jds = jgraph.synthesize("ppi", scale=0.01, seed=2)
    je = jruntime.SparseEngine(jds, model=model, bit_width=2, seed=7, shifts=shifts)
    te = SparseEngine(ds, model=model, bit_width=2, shifts=shifts, device="cpu",
                      float_weights=[np.asarray(w) for w in je.float_weights])
    assert te.cfg.hidden == (16 if model == "gcn" else 64)
    got, want = te.forward(), np.asarray(je.forward())
    np.testing.assert_array_equal(got.numpy(), want)
    assert te.evaluate(ds.labels) == je.evaluate(jds.labels)
    assert te.evaluate_f1(ds.multilabels) == je.evaluate_f1(jds.multilabels)
    st = te.run_epochs(2, sync_every_epoch=True)
    assert st.n_batches == 1 and len(st.epoch_ms) == 2 and st.launch_sync_ms == 0
    st = te.run_epochs(2)
    assert len(st.epoch_ms) == 1 and st.launch_sync_ms == st.avg_ms > 0


def test_sparse_engine_seeded_weights_and_device():
    ds = graph.synthesize("Proteins", scale=0.01, seed=3)
    a = SparseEngine(ds, seed=4, device="cpu")
    b = SparseEngine(ds, seed=4, device="cpu")
    assert torch.equal(a.forward(), b.forward())
    assert [w.shape for w in a.float_weights] == [(ds.feat_dim, 16), (16, 16), (16, ds.num_classes)]
    with pytest.raises(ValueError):
        SparseEngine(ds, model="sage", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            SparseEngine(ds)
