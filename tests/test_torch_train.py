"""QAT in the PyTorch port (``models/train.py``) against the JAX package's.

The same NumPy-drawn weights and host batches (the Proteins stand-in at
scale 0.04, psize 8, batch 2: four 512-row batches, as ``tests/test_train.py``
uses) go through both packages on the CPU, the JAX engine in Pallas
interpret mode. Tolerances: the STE twin, the shifts, the spread weights,
the engines' logits and the deployed metrics exactly; the smooth twin
within 1e-6 of the largest logit; one loss's gradient within rtol 1e-5,
atol 1e-6; two smooth epochs' weights within 1e-4. Also the ladder through
``benchmarks/accuracy_frontier.py``, the probes' entry points, checkpoints
written by either package and read by the other, and ``--weights`` in the
port's CLI.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from qgtc_ppopp22_tpu import cli as jcli
from qgtc_ppopp22_tpu.graph import ClusterBatcher as JaxBatcher
from qgtc_ppopp22_tpu.graph import synthesize as jsynthesize
from qgtc_ppopp22_tpu.models import train as jtrain
from qgtc_ppopp22_tpu.models.qmodels import QModelConfig as JaxConfig
from qgtc_ppopp22_tpu.models.qmodels import pack_weights as jpack_weights
from qgtc_ppopp22_tpu.runtime import QGTCEngine as JaxEngine
from qgtc_ppopp22_tpu_torch import cli
from qgtc_ppopp22_tpu_torch.benchmarks import accuracy_frontier, artist_gin_probe, frontier_probe
from qgtc_ppopp22_tpu_torch.graph import ClusterBatcher, synthesize
from qgtc_ppopp22_tpu_torch.models import train
from qgtc_ppopp22_tpu_torch.models.golden import quantize_np
from qgtc_ppopp22_tpu_torch.models.qmodels import QModelConfig
from qgtc_ppopp22_tpu_torch.runtime import QGTCEngine

KW = dict(psize=8, batch_size=2, bucket_rows=512, shuffle=False)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The twin's small products on one thread: several test workers share
    the machine's cores, and each worker's default thread pool spins."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    ds, jds = synthesize("Proteins", scale=0.04, seed=7), jsynthesize("Proteins", scale=0.04, seed=7)
    it, jit_ = ClusterBatcher(ds, bit_width=2, **KW), JaxBatcher(jds, bit_width=2, **KW)
    assert [b.nodes.tolist() for b in it.batches] == [b.nodes.tolist() for b in jit_.batches]
    return ds, it, jds, jit_


def _weights(seed, cfg, scale=0.4):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0.0, (1 << cfg.bit_width) * scale, s).astype(np.float32) for s in cfg.weight_shapes()]


def _case(data, model, bits, seed=0):
    """Batch 0's dense a and x (x scaled by the ladder's feature scale),
    NumPy weights and the shifts calibrated on them."""
    ds, it, _, _ = data
    cfg = QModelConfig(it.feat_dim, 16, ds.num_classes, bit_width=bits)
    ws = _weights(seed, cfg)
    shifts = train.calibrate_shifts(ds, it, [quantize_np(w, bits) for w in ws], bits, model)
    a, x, labels, mask = train._dense_batches(ds, it)[0]
    return cfg, ws, shifts, a, x * train.ladder_feature_scale(bits), labels, mask.astype(np.float32)


@pytest.mark.parametrize("ste", [True, False], ids=["ste", "smooth"])
@pytest.mark.parametrize("bits", [1, 2, 8])
@pytest.mark.parametrize("model", ["gcn", "gin"])
def test_twin_forward_matches_jax(data, model, bits, ste):
    cfg, ws, shifts, a, x, _, _ = _case(data, model, bits)
    got = train.float_twin_forward(torch.from_numpy(a), torch.from_numpy(x), [torch.from_numpy(w) for w in ws],
                                   bits, model, shifts, ste=ste).numpy()
    want = np.asarray(jtrain.float_twin_forward(jnp.asarray(a), jnp.asarray(x), [jnp.asarray(w) for w in ws],
                                                bits, model, shifts, ste=ste))
    if ste:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    assert np.abs(want).max() > 0


def _jax_loss(ws, a, x, labels, mask, bits, model, shifts, ste, multilabel):
    """JAX ``train_float_twin``'s ``batch_loss`` (``models/train.py:268-292``)."""
    logits = jtrain.float_twin_forward(a, x, ws, bits, model, shifts, ste=ste)
    tau = jnp.maximum(jax.lax.stop_gradient(jnp.std(logits)), 1.0)
    if multilabel:
        mean = jax.lax.stop_gradient(jnp.sum(logits * mask[:, None], axis=0) / jnp.maximum(jnp.sum(mask), 1.0))
        bce = optax.sigmoid_binary_cross_entropy((logits - mean[None, :]) / tau, labels)
        return jnp.sum(jnp.mean(bce, axis=-1) * mask) / jnp.maximum(jnp.sum(mask), 1)
    logp = jax.nn.log_softmax(logits / tau, axis=-1)
    nll = -jnp.take_along_axis(logp, labels[:, None], axis=1)[:, 0]
    return jnp.sum(nll * mask) / jnp.maximum(jnp.sum(mask), 1)


@pytest.mark.parametrize("ste,multilabel", [(True, False), (False, False), (True, True)],
                         ids=["nll-ste", "nll-smooth", "bce-ste"])
def test_batch_loss_gradient_matches_jax(data, ste, multilabel):
    cfg, ws, shifts, a, x, labels, mask = _case(data, "gcn", 2, seed=4)
    ws[0][:2] = 0.0  # weights on the clip's bounds, where the gradient halves
    ws[1][:, :2] = 4.0
    if multilabel:
        labels = np.random.default_rng(5).integers(0, 2, (a.shape[0], cfg.out_dim)).astype(np.float32)
    tw = [torch.from_numpy(w).requires_grad_(True) for w in ws]
    loss = train.batch_loss(tw, torch.from_numpy(a), torch.from_numpy(x), torch.from_numpy(labels),
                            torch.from_numpy(mask), 2, "gcn", shifts, ste, multilabel)
    loss.backward()
    want, grads = jax.value_and_grad(_jax_loss)([jnp.asarray(w) for w in ws], jnp.asarray(a), jnp.asarray(x),
                                                 jnp.asarray(labels), jnp.asarray(mask), 2, "gcn", tuple(shifts),
                                                 ste, multilabel)
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-6)
    for t, g in zip(tw, grads):
        assert np.abs(np.asarray(g)).max() > 0
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("model", ["gcn", "gin"])
def test_calibrate_shifts_and_spread_match_jax(data, model):
    ds, it, jds, jit_ = data
    for bits in (1, 2, 4):
        cfg = QModelConfig(it.feat_dim, 16, ds.num_classes, bit_width=bits)
        ws = _weights(bits, cfg, scale=0.1)  # small weights: the 1-2-bit spread multiplies them
        qws = [quantize_np(w, bits) for w in ws]
        shifts = train.calibrate_shifts(ds, it, qws, bits, model)
        assert shifts == jtrain.calibrate_shifts(jds, jit_, qws, bits, model)
        got_ws, got_sh = train._spread_weights([torch.from_numpy(w) for w in ws], shifts, bits, model)
        want_ws, want_sh = jtrain._spread_weights([jnp.asarray(w) for w in ws], shifts, bits, model)
        assert got_sh == want_sh and (got_sh != shifts) == (bits <= 2)
        for g, w in zip(got_ws, want_ws):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("name,multilabel", [("Proteins", False), ("ppi", True)])
def test_train_float_twin_matches_jax(name, multilabel):
    """Two smooth epochs from the same weights, Adam in both: the weights
    within 1e-4, the metric (accuracy, or micro-F1) within 2e-3 (the
    weights' last bits may move a node across a decision boundary)."""
    ds, jds = synthesize(name, scale=0.04, seed=7), jsynthesize(name, scale=0.04, seed=7)
    it, jit_ = ClusterBatcher(ds, bit_width=2, **KW), JaxBatcher(jds, bit_width=2, **KW)
    out = ds.multilabels.shape[1] if multilabel else ds.num_classes
    cfg = QModelConfig(it.feat_dim, 16, out, bit_width=2)
    ws = _weights(9, cfg, scale=0.25)
    shifts = train.calibrate_shifts(ds, it, [quantize_np(w, 2) for w in ws], 2)
    kw = dict(epochs=2, lr=1e-2, shifts=shifts, ste=False, multilabel=multilabel)
    got, got_metric = train.train_float_twin(ds, it, cfg, init_ws=ws, device="cpu", **kw)
    want, want_metric = jtrain.train_float_twin(jds, jit_, JaxConfig(it.feat_dim, 16, out, bit_width=2),
                                                init_ws=[jnp.asarray(w) for w in ws], **kw)
    for g, w, w0 in zip(got, want, ws):
        assert g.dtype == torch.float32 and g.device.type == "cpu"
        assert np.abs(np.asarray(w) - w0).max() > 1e-3  # the weights moved
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)
    assert got_metric == pytest.approx(want_metric, abs=2e-3)


@pytest.mark.parametrize("model", ["gcn", "gin"])
def test_twin_equals_engines(data, model):
    """The STE twin's logits equal the deployed engines' on every batch
    exactly: the step engine (K2, K3) and the mega engine (K1) of the port,
    and the JAX engine (JAX's ``test_ste_twin_is_integer_exact``)."""
    ds, it, jds, jit_ = data
    cfg, ws, shifts, *_ = _case(data, model, 2, seed=3)
    twin = train.float_twin_logits(ds, it, ws, 2, model, shifts, device="cpu")
    eng = train._deployed(it, ds.num_classes, ws, 2, model, shifts, None, None, "cpu")
    jeng = JaxEngine(feat_dim=it.feat_dim, num_classes=ds.num_classes, model=model, bit_width=2, hidden=16,
                     shifts=shifts)
    jeng.float_weights = [jnp.asarray(w) for w in ws]
    jeng.weights = jpack_weights(jeng.float_weights, 2, fmt="digits")
    engines = [eng.forward_all(it), eng._mega_logits(it), jeng.forward_all(jit_)]
    for i, (b, tw) in enumerate(zip(it.batches, twin)):
        n, c = b.num_nodes, ds.num_classes
        assert (tw[:n] != 0).any()
        for lg in engines:
            np.testing.assert_array_equal(np.asarray(lg[i])[:n, :c], tw[:n, :c].numpy())


def test_qat_train_deploys_exactly(data):
    """A short QAT schedule, one seed: the twin's accuracy is the deployed
    step and mega engines' exactly, above chance (0.5)."""
    ds, it, _, _ = data
    cfg = QModelConfig(it.feat_dim, 16, ds.num_classes, bit_width=2)
    ws, shifts, acc = train.qat_train(ds, it, cfg, smooth_epochs=20, ste_epochs=12, seed=0, device="cpu")
    assert len(shifts) == 5 and all(w.device.type == "cpu" and w.dtype == torch.float32 for w in ws)
    for mode in ("step", "mega"):
        assert train.quantized_accuracy(ds, it, ws, 2, shifts=shifts, device="cpu", mode=mode) == acc
    assert acc > 0.6, acc


def test_ladder_through_accuracy_frontier(tmp_path, capsys):
    """``python -m ...benchmarks.accuracy_frontier`` at 1 and 2 bits: the
    rows are monotone, and the 2-bit row's exact emulation of the 1-bit
    winner reproduces the 1-bit row."""
    csv = tmp_path / "frontier.csv"
    assert accuracy_frontier.main(["--bits", "1", "2", "--seeds", "0", "--scale", "0.04", "--device", "cpu",
                                   "--csv", str(csv)]) == 0
    lines = csv.read_text().splitlines()
    header, rows = lines[0].split(","), [dict(zip(lines[0].split(","), r.split(","))) for r in lines[1:]]
    assert header[:8] == ["dataset", "model", "bits", "accuracy", "chance", "shifts", "winner", "emulated"]
    assert [r["bits"] for r in rows] == ["1", "2"] and rows[0]["emulated"] == ""
    acc1, acc2 = float(rows[0]["accuracy"]), float(rows[1]["accuracy"])
    assert acc2 >= acc1 > float(rows[0]["chance"]) and float(rows[1]["emulated"]) == acc1
    assert capsys.readouterr().out.startswith("card: cpu\n")


def test_probes_run(tmp_path, monkeypatch):
    """The frontier probes' entry points at a small scale on the CPU, each
    ``qat_train`` on a 2 + 2 + 2 epoch schedule."""
    monkeypatch.setattr(train, "qat_train", functools.partial(train.qat_train, smooth_epochs=2, ste_epochs=2))
    assert artist_gin_probe.main(["--bits", "4", "--seeds", "0", "--scale", "0.02", "--device", "cpu",
                                  "--csv", str(tmp_path / "artist.csv")]) == 0
    rows = (tmp_path / "artist.csv").read_text().splitlines()
    assert rows[0] == "bits,fs_mult,lr,seed,train_acc,deployed_acc,beats_floor" and len(rows) == 7
    for r in rows[1:]:  # train accuracy is deployed accuracy
        assert r.split(",")[4] == r.split(",")[5]
    assert frontier_probe.main(["--scale", "0.02", "--device", "cpu", "--csv", str(tmp_path / "probe.csv")]) == 0
    rows = (tmp_path / "probe.csv").read_text().splitlines()
    assert rows[1].startswith("ppi_gin_1bit,") and len(rows) == 7


def _checkpoint_case(it, ds, model):
    cfg = QModelConfig(it.feat_dim, 16, ds.num_classes, bit_width=2)
    ws = _weights(11, cfg)
    shifts = train.calibrate_shifts(ds, it, [quantize_np(w, 2) for w in ws], 2, model)
    return cfg, ws, shifts


@pytest.mark.parametrize("model", ["gcn", "gin"])
def test_checkpoint_jax_to_port(data, tmp_path, model):
    """A checkpoint the JAX package writes loads in the port and deploys to
    the JAX engine's logits."""
    ds, it, jds, jit_ = data
    cfg, ws, shifts = _checkpoint_case(it, ds, model)
    path = str(tmp_path / "jax.npz")
    jtrain.save_checkpoint(path, [jnp.asarray(w) for w in ws], shifts,
                           JaxConfig(cfg.in_dim, cfg.hidden, cfg.out_dim, bit_width=2), model=model)
    got_ws, got_sh, got_cfg, got_model = train.load_checkpoint(path)
    assert (got_sh, got_cfg, got_model) == (shifts, cfg, model) and isinstance(got_cfg, QModelConfig)
    for g, w in zip(got_ws, ws):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), w)
    eng = QGTCEngine(feat_dim=it.feat_dim, num_classes=ds.num_classes, model=got_model, bit_width=2,
                     hidden=got_cfg.hidden, shifts=got_sh, device="cpu")
    eng.set_float_weights(got_ws)
    jws, jsh, _, _ = jtrain.load_checkpoint(path)
    jeng = JaxEngine(feat_dim=it.feat_dim, num_classes=ds.num_classes, model=model, bit_width=2, hidden=16,
                     shifts=jsh)
    jeng.float_weights = list(jws)
    jeng.weights = jpack_weights(jws, 2, fmt="digits")
    for b, got, want in zip(it.batches, eng.forward_all(it), jeng.forward_all(jit_)):
        np.testing.assert_array_equal(got.numpy()[:b.num_nodes, :ds.num_classes],
                                      np.asarray(want)[:b.num_nodes, :ds.num_classes])


def test_checkpoint_port_to_jax(data, tmp_path):
    ds, it, _, _ = data
    cfg, ws, shifts = _checkpoint_case(it, ds, "gin")
    path = str(tmp_path / "sub" / "port.npz")
    train.save_checkpoint(path, [torch.from_numpy(w) for w in ws], shifts, cfg, model="gin")
    jws, jsh, jcfg, jmodel = jtrain.load_checkpoint(path)
    assert (jsh, jmodel) == (shifts, "gin")
    assert (jcfg.in_dim, jcfg.hidden, jcfg.out_dim, jcfg.bit_width, jcfg.num_layers) == \
        (cfg.in_dim, cfg.hidden, cfg.out_dim, cfg.bit_width, cfg.num_layers)
    for g, w in zip(jws, ws):
        np.testing.assert_array_equal(np.asarray(g), w)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A JAX-written 2-bit GCN checkpoint for the synthetic Proteins stand-in
    the CLI builds, and the JAX CLI's records with it: the step engine's
    and ``--sparse``'s."""
    import contextlib
    import io

    from qgtc_ppopp22_tpu.graph import load_dataset as jload

    jds = jload("Proteins", scale=0.04)
    cfg = JaxConfig(jds.feat_dim, 16, jds.num_classes, bit_width=2)
    ws = _weights(13, cfg)
    jit_ = JaxBatcher(jds, psize=8, batch_size=2, bit_width=2, seed=3)
    shifts = jtrain.calibrate_shifts(jds, jit_, [quantize_np(w, 2) for w in ws], 2)
    d = tmp_path_factory.mktemp("ck")
    path = str(d / "ck.npz")
    jtrain.save_checkpoint(path, [jnp.asarray(w) for w in ws], shifts, cfg, model="gcn")
    records = {}
    for engine, flags in (("step", []), ("sparse", ["--sparse"])):
        out = str(d / f"{engine}.jsonl")
        with contextlib.redirect_stdout(io.StringIO()):
            assert jcli.main(CLI_ARGV + ["--weights", path, "--json-out", out,
                                         "--cache-dir", str(d / "cache")] + flags) == 0
        with open(out) as f:
            records[engine] = json.loads(f.read().splitlines()[-1])
    return path, records


CLI_ARGV = ["--dataset", "Proteins", "--dataset-scale", "0.04", "--psize", "8", "--batch-size", "2",
            "--n-epochs", "1", "--eval-accuracy", "--run_GIN"]


@pytest.mark.parametrize("flags", [["--mode", "step"], ["--mode", "fused"], ["--mode", "mega"], ["--sparse"]],
                         ids=["step", "fused", "mega", "sparse"])
def test_cli_weights(checkpoint, tmp_path, capsys, flags):
    """``--weights`` deploys the JAX-written checkpoint in every quantized
    engine of the port's CLI (it overrides ``--run_GIN``): the record names
    it and carries the JAX CLI's accuracy, the fused and mega engines the
    step engine's."""
    path, records = checkpoint
    want = records["sparse" if "--sparse" in flags else "step"]
    assert main_ok(CLI_ARGV + ["--weights", path, "--cache-dir", str(tmp_path), "--device", "cpu"] + flags)
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["weights"] == path and got["model"] == "gcn" and got["bit_width"] == 2
    assert got["accuracy"] == want["accuracy"] > 0


def main_ok(argv) -> bool:
    return cli.main(argv) == 0


def test_weights_refused_with_the_baseline(checkpoint, capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(["--regular", "--weights", checkpoint[0], "--device", "cpu"])
    assert exc.value.code == 2 and "--weights is the quantized engine's option" in capsys.readouterr().err
