"""The full-precision baseline of the PyTorch port against the JAX package.

Models, the whole-bucket ``fused_baseline_epoch`` (its plain version on
the CPU; JAX in Pallas interpret mode), ``BaselineEngine``, the F1
metrics and the ``--regular`` / ``--eval-accuracy`` CLI. Inputs come from
NumPy seeds, weights from the JAX package or NumPy.

Tolerance: exact equality for the weights, ``int8_mm``,
``sparse_aggregate``, the F1 functions and the bf16 chain's "integer"
and "rounding" cases (``torch_cases.baseline_case``). Elsewhere, per row
of logits, max |port - JAX| <= 2^-6 * max |JAX| (``torch_cases``, which
gives the reason): a float32 sum taken in another order can move a bf16
rounding by one ulp at any of the chain's 2n casts.
"""

import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgtc_ppopp22_tpu import graph as jgraph
from qgtc_ppopp22_tpu import runtime as jruntime
from qgtc_ppopp22_tpu.models import baselines as jbaselines
from qgtc_ppopp22_tpu.ops.fused_model import fused_baseline_epoch as jax_fused_baseline_epoch
from qgtc_ppopp22_tpu.utils import metrics as jmetrics
from qgtc_ppopp22_tpu_torch import cli, graph, runtime
from qgtc_ppopp22_tpu_torch.models import baselines, qmodels
from qgtc_ppopp22_tpu_torch.ops import fused_model
from qgtc_ppopp22_tpu_torch.ops.fused_model import (
    fused_baseline_epoch,
    fused_baseline_epoch_plain,
)
from qgtc_ppopp22_tpu_torch.runtime import BaselineEngine, EpochStats, QGTCEngine
from qgtc_ppopp22_tpu_torch.utils import metrics
from torch_cases import BF16_REL_TOL, baseline_case, bf16_rel_err
from torch_threads import one_thread  # noqa: F401  (an autouse fixture: one torch thread)

DIMS = {"sage": [128, 16, 16, 40], "gin": [128, 64, 64, 40]}


def _dims(model, layers):
    d = DIMS[model]
    return d if layers == 3 else [d[0], d[-1]]


def _assert_close(got, ref):
    for g, r in zip(got, ref):
        assert bf16_rel_err(g, r) <= BF16_REL_TOL


def _bf16_round(v, mode):
    """float32 -> bf16 values (as float32), to nearest even or toward
    zero, by the bits (no NaN or overflow in these cases)."""
    u = np.asarray(v, np.float32).view(np.uint32).astype(np.uint64)
    if mode == "nearest":
        u = u + 0x7FFF + ((u >> 16) & 1)
    return (u & 0xFFFF0000).astype(np.uint32).view(np.float32)


def _chain(a, x, ws, mode):
    """The bf16 chain in NumPy with rounding ``mode`` at the JAX kernel's
    points; exact sums, as every sum of the "rounding" case has at most
    2 nonzero terms."""
    h = _bf16_round(x, mode)
    for i, w in enumerate(ws):
        agg = _bf16_round((a.astype(np.float64) @ h).astype(np.float32), mode)
        h = (agg.astype(np.float64) @ _bf16_round(w, mode)).astype(np.float32)
        if i < len(ws) - 1:
            h = _bf16_round(np.maximum(h, 0), mode)
    return h


# -- models ------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3])
def test_weights_from_jax_are_the_jax_weights(seed):
    dims = [128, 16, 16, 40]
    ref = [np.asarray(w) for w in jbaselines.init_mlp_weights(jax.random.PRNGKey(seed), dims)]
    got = baselines.baseline_weights_from_jax(ref)
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), r)
    ws = baselines.init_mlp_weights(torch.Generator().manual_seed(seed), dims)
    assert [tuple(w.shape) for w in ws] == [(128, 16), (16, 16), (16, 40)]
    again = baselines.init_mlp_weights(torch.Generator().manual_seed(seed), dims)
    assert all(torch.equal(a, b) for a, b in zip(ws, again))
    assert 0.05 < float(torch.cat([w.reshape(-1) for w in ws]).std()) < 0.2


@pytest.mark.parametrize("shape", [(64, 96, 24), (300, 128, 40)])
def test_int8_mm_matches_jax(shape):
    m, k, n = shape
    rng = np.random.default_rng(m)
    a = rng.integers(-128, 128, (m, k)).astype(np.int8)
    b = rng.integers(-128, 128, (k, n)).astype(np.int8)
    got = baselines.int8_mm(torch.from_numpy(a), torch.from_numpy(b))
    ref = np.asarray(jbaselines.int8_mm(jnp.asarray(a), jnp.asarray(b)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_sparse_aggregate_matches_jax():
    rng = np.random.default_rng(1)
    n = 200
    deg = rng.integers(0, 9, n)
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    indices = rng.integers(0, n, indptr[-1]).astype(np.int32)
    x = rng.integers(-50, 50, (n, 16)).astype(np.float32)  # integer-valued: exact sums
    got = baselines.sparse_aggregate(torch.from_numpy(indptr).long(), torch.from_numpy(indices).long(),
                                     torch.from_numpy(x))
    ref = np.asarray(jbaselines.sparse_aggregate(jnp.asarray(indptr), jnp.asarray(indices), jnp.asarray(x)))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("model", ["sage", "gin"])
@pytest.mark.parametrize("pn", [256, 512])
@pytest.mark.parametrize("layers", [1, 3])
def test_forward_matches_jax(model, pn, layers):
    a, x, ws = baseline_case(pn + layers, 1, pn, _dims(model, layers))
    fwd = baselines.sage_forward if model == "sage" else baselines.gin_forward
    jfwd = jbaselines.sage_forward if model == "sage" else jbaselines.gin_forward
    got = fwd(torch.from_numpy(a[0]), torch.from_numpy(x[0]), [torch.from_numpy(w) for w in ws])
    ref = np.asarray(jfwd(jnp.asarray(a[0]), jnp.asarray(x[0]), [jnp.asarray(w) for w in ws]))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert np.abs(ref).max() > 0
    _assert_close([got.numpy()], [ref])


# -- the whole-bucket chain (K5) ----------------------------------------------


def _jax_k5(a, x, ws):
    return np.asarray(jax_fused_baseline_epoch(jnp.asarray(a), jnp.asarray(x),
                                               tuple(jnp.asarray(w) for w in ws)))


@pytest.mark.parametrize("model", ["sage", "gin"])
@pytest.mark.parametrize("pn", [256, 512])
@pytest.mark.parametrize("layers", [1, 3])
def test_fused_baseline_matches_jax(model, pn, layers):
    a, x, ws = baseline_case(2 * pn + layers, 2, pn, _dims(model, layers))
    got = fused_baseline_epoch(torch.from_numpy(a), torch.from_numpy(x), [torch.from_numpy(w) for w in ws])
    ref = _jax_k5(a, x, ws)
    assert got.dtype == torch.float32 and got.shape == ref.shape == (2, pn, 40)
    _assert_close(got.numpy(), ref)


@pytest.mark.parametrize("model", ["sage", "gin"])
def test_fused_baseline_exact_case(model):
    """Every intermediate is an integer of magnitude <= 64: the port and
    the JAX kernel agree bit for bit, and both equal an integer chain."""
    a, x, ws = baseline_case(7, 2, 512, DIMS[model], kind="integer")
    got = fused_baseline_epoch(torch.from_numpy(a), torch.from_numpy(x), [torch.from_numpy(w) for w in ws])
    np.testing.assert_array_equal(got.numpy(), _jax_k5(a, x, ws))
    for b in range(2):
        h = x[b].astype(np.int64)
        for i, w in enumerate(ws):
            h = (a[b].astype(np.int64) @ h) @ w.astype(np.int64)
            if i < len(ws) - 1:
                h = np.maximum(h, 0)
        np.testing.assert_array_equal(got[b].numpy(), h.astype(np.float32))
        assert 8 < np.abs(h).max() <= 64  # the chain neither vanished nor left the bound


@pytest.mark.parametrize("model", ["sage", "gin"])
def test_fused_baseline_rounding_case(model):
    """Every float32 sum is exact and every cast rounds: the port, the
    JAX kernel and a NumPy chain rounding to nearest even agree bit for
    bit, and the same chain rounding toward zero does not."""
    a, x, ws = baseline_case(9, 2, 512, DIMS[model], kind="rounding")
    got = fused_baseline_epoch(torch.from_numpy(a), torch.from_numpy(x), [torch.from_numpy(w) for w in ws])
    np.testing.assert_array_equal(got.numpy(), _jax_k5(a, x, ws))
    for b in range(2):
        np.testing.assert_array_equal(got[b].numpy(), _chain(a[b], x[b], ws, "nearest"))
        g, truncated = got[b].numpy(), _chain(a[b], x[b], ws, "zero")
        assert np.mean(g[g != 0] != truncated[g != 0]) > 0.5
        assert not np.array_equal(x[b], _bf16_round(x[b], "nearest"))  # X is not bf16


def test_fused_baseline_takes_bf16_features_and_ragged_widths():
    dims = [29, 24, 10]  # widths that are not multiples of 16
    a, x, ws = baseline_case(5, 2, 256, dims)
    args = (torch.from_numpy(a), torch.from_numpy(x), [torch.from_numpy(w) for w in ws])
    got = fused_baseline_epoch(*args)
    assert got.shape == (2, 256, 10)
    _assert_close(got.numpy(), _jax_k5(a, x, ws))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert torch.equal(fused_baseline_epoch(args[0], xb, args[2]),
                       fused_baseline_epoch(args[0], xb.float(), args[2]))
    assert torch.equal(got, fused_baseline_epoch_plain(*args))


def test_fused_baseline_takes_resident_a_false():
    """The TPU's streamed-A tier is the card's one launch, as JAX callers
    pass it."""
    a, x, ws = baseline_case(0, 1, 256, [128, 16, 40])
    a, x, ws = torch.from_numpy(a), torch.from_numpy(x), [torch.from_numpy(w) for w in ws]
    assert torch.equal(fused_baseline_epoch(a, x, ws, resident_a=False), fused_baseline_epoch(a, x, ws))


@pytest.mark.parametrize("case,exc,match", [
    ("pn384", ValueError, "chunk divisor"),
    ("stacks", ValueError, "stacked shapes"),
    ("chain", ValueError, "do not chain"),
    ("x_width", ValueError, "x width"),
    ("wide", ValueError, "at most 128"),
    ("layers", ValueError, "layers"),
])
def test_fused_baseline_refuses(case, exc, match):
    pn = 384 if case == "pn384" else 256
    dims = {"wide": [128, 144, 40], "layers": [16] * 10}.get(case, [128, 16, 40])
    a, x, ws = baseline_case(0, 1, pn, dims)
    a, x, ws = torch.from_numpy(a), torch.from_numpy(x), [torch.from_numpy(w) for w in ws]
    kw = {}
    if case == "stacks":
        a = a[:, :, :128]
    elif case == "chain":
        ws[1] = ws[1][:8]
    elif case == "x_width":
        x = x[:, :, :64]
    with pytest.raises(exc, match=match):
        fused_baseline_epoch(a, x, ws, **kw)


def test_pack_baseline_weights_layout():
    """Each weight rounded to bf16, transposed and zero-padded to 16-wide
    [np, kp] blocks, one after another."""
    _, _, ws = baseline_case(2, 1, 256, [29, 24, 10])
    packed = fused_model.pack_baseline_weights([torch.from_numpy(w) for w in ws])
    assert (packed.kp, packed.np, packed.offs) == ([32, 32], [32, 16], [0, 32 * 32])
    assert packed.buf.dtype == torch.bfloat16 and packed.buf.numel() == 32 * 32 + 16 * 32
    for w, off, kp, np_ in zip(ws, packed.offs, packed.kp, packed.np):
        block = packed.buf[off:off + np_ * kp].reshape(np_, kp).float().numpy()
        want = np.zeros((np_, kp), np.float32)
        want[: w.shape[1], : w.shape[0]] = torch.from_numpy(w.T.copy()).to(torch.bfloat16).float().numpy()
        np.testing.assert_array_equal(block, want)
    with pytest.raises(ValueError, match="at most 128"):
        fused_model.pack_baseline_weights([torch.zeros(16, 144)])


# -- the engine ---------------------------------------------------------------


def _baseline_pair(model, scale=0.02, name="Proteins", seed=1):
    kw = dict(bit_width=2, seed=5, bucket_rows=256, partition_method="bfs")
    ds, jds = graph.synthesize(name, scale=scale, seed=5), jgraph.synthesize(name, scale=scale, seed=5)
    it, jit = graph.ClusterBatcher(ds, 4, 2, **kw), jgraph.ClusterBatcher(jds, 4, 2, **kw)
    je = jruntime.BaselineEngine(feat_dim=it.feat_dim, num_classes=ds.num_classes, model=model, seed=seed)
    te = BaselineEngine(feat_dim=it.feat_dim, num_classes=ds.num_classes, model=model, seed=seed,
                        device="cpu")
    te.weights = baselines.baseline_weights_from_jax([np.asarray(w) for w in je.weights])
    return ds, it, jds, jit, je, te


@pytest.fixture(scope="module", params=["sage", "gin"])
def pair(request):
    return _baseline_pair(request.param)


def test_engine_forward_fused_and_mega_match_jax(pair):
    ds, it, jds, jit, je, te = pair
    ref = [np.asarray(je.forward_batch(jb, jds, jit.features)) for jb in jit.batches]
    step = [te.forward_batch(b, ds, it.features) for b in it.batches]
    fused = [None] * len(it.batches)
    for idx, a_s, x_s in te._stage(it, ds, torch.uint8):
        assert a_s.dtype == torch.uint8
        for i, logits in zip(idx, te._fused_bucket(a_s, x_s)):
            fused[i] = logits
    fused_model.BASELINE_LAUNCHES = 0
    mega = te._mega_logits(it, ds)
    assert te.mega_buckets and sum(i["batches"] for i in te.mega_buckets) == len(it.batches)
    assert fused_model.BASELINE_LAUNCHES == 0  # CPU tensors run the plain version
    for b, r, s, f, m in zip(it.batches, ref, step, fused, mega):
        assert r.shape == (b.padded_nodes, ds.num_classes) == s.shape == f.shape == m.shape
        _assert_close([s.numpy(), f.numpy(), m.numpy()], [r, r, r])
        assert torch.equal(s, f) and torch.equal(s, m)  # one chain on one device


def test_engine_hidden_defaults():
    for model, hidden in (("sage", 16), ("gin", 64)):
        eng = BaselineEngine(feat_dim=30, num_classes=7, model=model, device="cpu")
        assert [tuple(w.shape) for w in eng.weights] == [(30, hidden), (hidden, hidden), (hidden, 7)]
    with pytest.raises(ValueError):
        BaselineEngine(feat_dim=30, num_classes=7, model="gcn", device="cpu")


@pytest.mark.parametrize("mode", ["step", "step-transfer", "fused", "mega"])
@pytest.mark.parametrize("sync_every_epoch", [False, True])
def test_engine_epoch_stats(pair, mode, sync_every_epoch):
    ds, it, _, _, _, te = pair
    kw = dict(n_epochs=2, sync_every_epoch=sync_every_epoch)
    if mode.startswith("step"):
        st = te.run_epochs(it, ds, resident=mode == "step", **kw)
    else:
        st = getattr(te, f"run_epochs_{mode}")(it, ds, **kw)
    assert isinstance(st, EpochStats) and st.n_batches == len(it)
    assert len(st.epoch_ms) == (2 if sync_every_epoch else 1) and st.avg_ms > 0


def test_mega_refuses_what_the_kernel_cannot_take():
    """Weights the kernel refuses (a layer wider than 128 columns) no
    longer stop the mega mode: every bucket runs the fused loop, loudly,
    with the fused mode's logits (JAX runs such a bucket through its scan
    epoch). It never gives way to the plain chain silently."""
    ds, it, _, _, _, _ = _baseline_pair("sage")
    te = BaselineEngine(feat_dim=it.feat_dim, num_classes=ds.num_classes, hidden=144, device="cpu")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        got = te._mega_logits(it, ds)
        assert te.run_epochs_mega(it, ds, n_epochs=1).n_batches == len(it)
    assert "falling back to the fused loop" in buf.getvalue() and "at most 128" in buf.getvalue()
    assert te.mega_buckets and all(b["fallback"] for b in te.mega_buckets)
    fused = [lg for _, a, x in te._stage(it, ds, torch.uint8) for lg in te._fused_bucket(a, x)]
    order = [i for idx, _, _ in te._stage(it, ds, torch.uint8) for i in idx]
    for i, want in zip(order, fused):
        assert torch.equal(got[i], want)
    assert te.run_epochs_fused(it, ds, n_epochs=1).n_batches == len(it)


def test_evaluate_and_f1_on_multilabel_data():
    ds, it, jds, jit, je, te = _baseline_pair("sage", scale=0.01, name="ppi")
    assert ds.multilabels is not None
    f1 = te.evaluate_f1(it, ds, ds.multilabels)
    assert 0.0 <= f1["f1_micro"] <= 1.0 and 0.0 <= f1["f1_macro"] <= 1.0
    assert 0.0 <= te.evaluate(it, ds, ds.labels) <= 1.0
    # the quantized engine's F1 equals the JAX engine's: its logits are exact
    jq = jruntime.QGTCEngine(feat_dim=jit.feat_dim, num_classes=jds.num_classes, bit_width=2, seed=2)
    tq = QGTCEngine(feat_dim=it.feat_dim, num_classes=ds.num_classes, bit_width=2, device="cpu")
    tq.weights = qmodels.weights_from_jax([np.asarray(w) for w in jq.float_weights], 2)
    assert tq.evaluate_f1(it, ds.multilabels) == jq.evaluate_f1(jit, jds.multilabels)


def test_f1_functions_match_jax():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((300, 12)).astype(np.float32) + 0.3
    labels = (rng.random((300, 12)) < 0.3).astype(np.int8)
    for avg in ("micro", "macro"):
        assert metrics.multilabel_f1(logits, labels, avg) == jmetrics.multilabel_f1(logits, labels, avg)
        y, p = rng.integers(0, 5, 200), rng.integers(0, 5, 200)
        assert metrics.f1_score(y, p, average=avg) == jmetrics.f1_score(y, p, average=avg)
    assert runtime._threshold_f1(logits, labels) == jruntime._threshold_f1(logits, labels)
    with pytest.raises(ValueError):
        metrics.f1_score([0], [0], average="weighted")


# -- the CLI --------------------------------------------------------------------


def _toy_npz(path):
    rng = np.random.default_rng(0)
    np.savez(path / "toy.npz", src_li=rng.integers(0, 600, 3000), dst_li=rng.integers(0, 600, 3000))


@pytest.mark.parametrize("mode", ["step", "fused", "mega"])
@pytest.mark.parametrize("gin", [False, True])
def test_cli_regular(tmp_path, monkeypatch, capsys, mode, gin):
    _toy_npz(tmp_path)
    monkeypatch.chdir(tmp_path)
    rc = cli.main(["--dataset", "toy", "--data-dir", str(tmp_path), "--psize", "4",
                   "--batch-size", "2", "--n-epochs", "2", "--device", "cpu", "--regular",
                   "--mode", mode, *(["--run_GIN"] if gin else [])])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Avg. Epoch:" in out
    record = json.loads(out.strip().splitlines()[-1])
    assert record["engine"] == f"regular-{mode}" and record["avg_epoch_ms"] > 0
    assert record["model"] == ("gin" if gin else "sage") and record["device"] == "cpu"
    if mode == "mega":
        assert record["buckets"] and all(b["batches"] > 0 for b in record["buckets"])


def test_cli_regular_mega_refuses_wide_layers(tmp_path, monkeypatch, capsys):
    """The kernel refuses a layer wider than 128 columns: the mega mode
    runs the fused loop for every bucket, says so, and records it."""
    _toy_npz(tmp_path)
    monkeypatch.chdir(tmp_path)
    rc = cli.main(["--dataset", "toy", "--data-dir", str(tmp_path), "--psize", "4",
                   "--batch-size", "2", "--n-epochs", "1", "--device", "cpu", "--regular",
                   "--mode", "mega", "--hidden", "144"])
    out = capsys.readouterr().out
    assert rc == 0 and "at most 128" in out and "falling back to the fused loop" in out
    record = json.loads(out.strip().splitlines()[-1])
    assert record["buckets"] and all(b["fallback"] for b in record["buckets"])


@pytest.mark.parametrize("engine", ["--use_QGTC", "--regular"])
def test_cli_eval_accuracy_on_ppi(tmp_path, monkeypatch, capsys, engine):
    monkeypatch.chdir(tmp_path)
    rc = cli.main(["--dataset", "ppi", "--dataset-scale", "0.01", "--data-dir", str(tmp_path),
                   "--psize", "4", "--batch-size", "2", "--n-epochs", "1", "--device", "cpu",
                   engine, "--eval-accuracy"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "accuracy:" in out and "F1-mic:" in out and "F1-mac:" in out
    record = json.loads(out.strip().splitlines()[-1])
    assert 0.0 <= record["accuracy"] <= 1.0 and 0.0 <= record["f1_micro"] <= 1.0


@pytest.mark.parametrize("argv,msg", [
    (["--mode", "fused", "--mesh", "2"], "bad --mesh '2'; expected DP,SP"),
    (["--regular", "--zerotile_jump", "--mode", "mega"], "quantized engine"),
    (["--regular", "--resident", "--mode", "mega"], "--resident"),
    (["--regular", "--weights", "w.npz", "--mode", "mega"], "quantized engine"),
])
def test_cli_refuses(capsys, argv, msg):
    with pytest.raises(SystemExit) as exc:
        cli.main(argv)
    assert exc.value.code == 2 and msg in capsys.readouterr().err


# -- the default device ----------------------------------------------------------


@pytest.mark.parametrize("engine", [QGTCEngine, BaselineEngine])
def test_engines_default_to_cuda(monkeypatch, engine):
    """Without CUDA an engine given no device raises: it never falls
    back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        engine(feat_dim=30, num_classes=7)
