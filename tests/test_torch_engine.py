"""Models, engine and CLI of the PyTorch port against the JAX package.

Both packages run the same cluster batches with the same integer weight
levels (``weights_from_jax`` converts the JAX engine's float weights),
on the CPU: the port through its GEMMs' plain versions, JAX through
Pallas interpret mode. Tolerance: exact equality.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgtc_ppopp22_tpu import graph as jgraph
from qgtc_ppopp22_tpu.models import qmodels as jqmodels
from qgtc_ppopp22_tpu.ops import digits as jdigits
from qgtc_ppopp22_tpu.ops import packmm as jpackmm
from qgtc_ppopp22_tpu.runtime import QGTCEngine as JaxEngine
from qgtc_ppopp22_tpu_torch import cli, graph
from qgtc_ppopp22_tpu_torch.models import qmodels
from qgtc_ppopp22_tpu_torch.ops import digits, packmm
from qgtc_ppopp22_tpu_torch.runtime import EpochStats, QGTCEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _batchers(bit_width, psize=4):
    kw = dict(bit_width=bit_width, seed=5, bucket_rows=256, partition_method="bfs")
    ds = graph.synthesize("Proteins", scale=0.02, seed=5)
    jds = jgraph.synthesize("Proteins", scale=0.02, seed=5)
    return ds, graph.ClusterBatcher(ds, psize, 2, **kw), jds, jgraph.ClusterBatcher(jds, psize, 2, **kw)


def _engines(it, ds, model, bit_width, seed=1):
    je = JaxEngine(feat_dim=it.feat_dim, num_classes=ds.num_classes, model=model,
                   bit_width=bit_width, seed=seed)
    te = QGTCEngine(feat_dim=it.feat_dim, num_classes=ds.num_classes, model=model,
                    bit_width=bit_width, seed=seed)
    te.weights = qmodels.weights_from_jax([np.asarray(w) for w in je.float_weights], bit_width)
    return je, te


@pytest.fixture(scope="module")
def small():
    return _batchers(2)


@pytest.mark.parametrize("bit_width,quant_bits", [(2, None), (8, None), (4, 2)])
def test_weights_from_jax_matches_pack_weights(bit_width, quant_bits):
    rng = np.random.default_rng(bit_width)
    fw = [rng.uniform(-1, (1 << bit_width) + 1, s).astype(np.float32) for s in [(128, 16), (16, 16), (16, 40)]]
    port = qmodels.weights_from_jax(fw, bit_width, quant_bits)
    ref = jqmodels.pack_weights([jnp.asarray(w) for w in fw], bit_width, fmt="digits", quant_bits=quant_bits)
    for p, r in zip(port, ref):
        assert p.shape == r.shape and p.bits == r.bits
        np.testing.assert_array_equal(p.digits.numpy(), np.asarray(r.digits))
    with pytest.raises(NotImplementedError):
        qmodels.pack_weights([torch.zeros(4, 4)], 2, fmt="bits")


def test_init_weights_shapes_and_range():
    cfg = qmodels.QModelConfig(in_dim=128, hidden=16, out_dim=40, bit_width=2)
    ws = qmodels.init_weights(torch.Generator().manual_seed(0), cfg)
    assert [tuple(w.shape) for w in ws] == cfg.weight_shapes() == [(128, 16), (16, 16), (16, 40)]
    assert all(w.dtype == torch.float32 and w.min() >= 0 and w.max() < 4 for w in ws)
    again = qmodels.init_weights(torch.Generator().manual_seed(0), cfg)
    assert all(torch.equal(a, b) for a, b in zip(ws, again))


@pytest.mark.parametrize("model", ["gcn", "gin"])
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("shifts", [None, "scaled"])
def test_forward_matches_jax_and_golden(model, bits, shifts):
    rng = np.random.default_rng(bits + (model == "gin"))
    n, feat, hidden, ncls = 512, 128, 16 if model == "gcn" else 64, 40
    qa = (rng.random((n, n)) < 0.02).astype(np.int32)  # asymmetric, not banded
    qx = rng.integers(0, 1 << bits, (n, feat)).astype(np.int32)
    dims = [feat, hidden, hidden, ncls]
    qws = [rng.integers(0, 1 << bits, (dims[i], dims[i + 1])).astype(np.int32) for i in range(3)]
    sh = None if shifts is None else [2, 1, 3, 1, 2]
    fwd = qmodels.qgcn_forward if model == "gcn" else qmodels.qgin_forward
    a = packmm.PackedTensor(torch.from_numpy(packmm.pack_rows_np(qa, 1)), (n, n), 1)
    got = fwd(a, digits.digit_pack(torch.from_numpy(qx), bits),
              [digits.digit_pack(torch.from_numpy(w), bits) for w in qws], bits, shifts=sh)
    jfwd = jqmodels.qgcn_forward if model == "gcn" else jqmodels.qgin_forward
    ref = jfwd(jpackmm.pack_rows(jnp.asarray(qa), 1), jdigits.digit_pack(jnp.asarray(qx), bits),
               [jdigits.digit_pack(jnp.asarray(w), bits) for w in qws], bits, shifts=sh)
    assert got.shape == (n, ncls) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    golden = (jqmodels.qgcn_golden if model == "gcn" else jqmodels.qgin_golden)(qa, qx, qws, bits, bits, sh)
    np.testing.assert_array_equal(got.numpy(), golden)
    plain = fwd(a, digits.digit_pack(torch.from_numpy(qx), bits),
                [digits.digit_pack(torch.from_numpy(w), bits) for w in qws], bits, shifts=sh, plain=True)
    assert torch.equal(plain, got)


@pytest.mark.parametrize("model", ["gcn", "gin"])
def test_engine_forward_matches_jax(small, model):
    ds, it, jds, jit = small
    je, te = _engines(it, ds, model, 2)
    outs = te.forward_all(it)
    assert len(outs) == len(it.batches)
    for b, jb, out in zip(it.batches, jit.batches, outs):
        ref = np.asarray(je.forward_batch(jb))
        got = te.forward_batch(b)
        assert got.shape == (b.padded_nodes, ds.num_classes)
        np.testing.assert_array_equal(got.numpy(), ref)
        np.testing.assert_array_equal(out.numpy(), ref)
        assert torch.equal(te.forward_batch(b, plain=True), got)
    for got, ref in zip(outs, je.forward_all(jit)):
        np.testing.assert_array_equal(got.numpy(), ref)
    assert te.evaluate(it, ds.labels) == je.evaluate(jit, jds.labels)


def test_engine_8bit_matches_jax_and_golden():
    ds, it, jds, jit = _batchers(8, psize=2)
    je, te = _engines(it, ds, "gcn", 8, seed=7)
    b, jb = it.batches[0], jit.batches[0]
    got = te.forward_batch(b).numpy()
    np.testing.assert_array_equal(got, np.asarray(je.forward_batch(jb)))
    pn = b.padded_nodes
    qa = packmm.unpack_rows(te.put_batch(b)[0]).numpy()
    qx = graph.batching.quantize_np(np.pad(ds.features[b.nodes], ((0, pn - b.num_nodes), (0, 0))), 8)
    qws = [digits.digit_unpack(w).numpy() for w in te.weights]
    np.testing.assert_array_equal(got, jqmodels.qgcn_golden(qa, qx, qws, 8, 8))


@pytest.mark.parametrize("resident", [False, True])
@pytest.mark.parametrize("sync_every_epoch", [False, True])
def test_run_epochs_covers_every_batch(small, resident, sync_every_epoch):
    ds, it, _, _ = small
    eng = QGTCEngine(feat_dim=it.feat_dim, num_classes=ds.num_classes, bit_width=2, seed=2)
    st = eng.run_epochs(it, n_epochs=2, resident=resident, sync_every_epoch=sync_every_epoch)
    assert isinstance(st, EpochStats) and st.n_batches == len(it) == 2
    assert len(st.epoch_ms) == (2 if sync_every_epoch else 1) and st.avg_ms > 0


def test_engine_cuda_raises_without_cuda(small, monkeypatch):
    ds, it, _, _ = small
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        QGTCEngine(feat_dim=it.feat_dim, num_classes=ds.num_classes, device="cuda")


@pytest.mark.parametrize("kwargs,exc", [
    (dict(zerotile_jump=True), NotImplementedError),
    (dict(fmt="bits"), NotImplementedError),
    (dict(model="sage"), ValueError),
])
def test_engine_rejects_unported_options(kwargs, exc):
    with pytest.raises(exc):
        QGTCEngine(feat_dim=128, num_classes=40, **kwargs)


def test_package_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import qgtc_ppopp22_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'qgtc_ppopp22_tpu', 'triton'))\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 18  # every module of the package imported


def _toy_npz(path):
    rng = np.random.default_rng(0)
    np.savez(path / "toy.npz", src_li=rng.integers(0, 600, 3000), dst_li=rng.integers(0, 600, 3000))


def test_cli_runs_step_engine_on_cpu(tmp_path, monkeypatch, capsys):
    _toy_npz(tmp_path)
    monkeypatch.chdir(tmp_path)
    rc = cli.main(["--dataset", "toy", "--data-dir", str(tmp_path), "--psize", "4",
                   "--batch-size", "2", "--n-epochs", "2", "--device", "cpu", "--use_QGTC",
                   "--run_GIN", "--hidden", "32"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Avg. Epoch:" in out
    record = json.loads(out.strip().splitlines()[-1])
    assert record["model"] == "gin" and record["device"] == "cpu" and record["avg_epoch_ms"] > 0


def test_cli_rejects_unported_flags(capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(["--zerotile_jump"])
    assert exc.value.code == 2
    assert "not yet ported" in capsys.readouterr().err
