"""The (dp, sp) mesh layer of the PyTorch port (``parallel/``) against the
JAX package, on the CPU over meshes of one repeated CPU device (the analog
of JAX's virtual CPU devices): the port's GEMMs run their plain versions,
JAX runs its single-device forwards and engine in Pallas interpret mode
in this process. JAX's own ``tests/test_parallel.py`` holds its mesh equal
to those. Tolerance: exact integer equality over the real extents
``[:num_nodes, :num_classes]``.
"""

import contextlib
import io
import json

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
from qgtc_ppopp22_tpu_torch.entry import dryrun_multichip, entry
from qgtc_ppopp22_tpu_torch.models import qmodels
from qgtc_ppopp22_tpu_torch.ops.digits import digit_pack
from qgtc_ppopp22_tpu_torch.ops.fused_model import mega_colblock
from qgtc_ppopp22_tpu_torch.ops.packmm import pack_rows_np
from qgtc_ppopp22_tpu_torch.parallel import (
    MeshEngine,
    dp_mega_epoch_packed,
    dp_sp_epoch_packed,
    dp_sp_epoch_step,
    make_mesh,
    shard_packed_batches,
    sp_gcn_forward,
    sp_gcn_forward_ring,
    sp_gin_forward,
    sp_gin_forward_ring,
)
from qgtc_ppopp22_tpu_torch.runtime import QGTCEngine, mega_block_sched


def _cpu(n):
    return ["cpu"] * n


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Beside other test workers the default thread pool slows the plain
    GEMMs down several times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the functional layer against JAX's single-device forwards -----------------


def _operands(bits, n, seed):
    rng = np.random.default_rng(seed)
    d, hid, cls = 128, 64, 128
    qa = (rng.random((n, n)) < 0.01).astype(np.int32)
    qx = rng.integers(0, 1 << bits, (n, d)).astype(np.int32)
    qws = [rng.integers(0, 1 << bits, s).astype(np.int32) for s in [(d, hid), (hid, hid), (hid, cls)]]
    return qa, qx, qws


@pytest.fixture(scope="module", params=[2, 8])
def packed_case(request):
    """A random 1024-node batch at 1% (JAX's PACKED-RING shapes: sp 4 needs
    pn % (4 x 256) == 0) and JAX's ``qgcn_forward`` over its packed words."""
    bits = request.param
    qa, qx, qws = _operands(bits, 1024, bits)
    words = pack_rows_np(qa, 1)
    ja = jpackmm.PackedTensor(words=jnp.asarray(words), shape=qa.shape, bits=1)
    jx = jdigits.digit_pack(jnp.asarray(qx), bits)
    ref = np.asarray(jqmodels.qgcn_forward(ja, jx, [jdigits.digit_pack(jnp.asarray(w), bits) for w in qws],
                                           out_bits=bits))
    x = digit_pack(torch.from_numpy(qx), bits)
    return bits, torch.from_numpy(words), x, [digit_pack(torch.from_numpy(w), bits) for w in qws], ref


@pytest.mark.parametrize("dp,sp", [(2, 2), (1, 4)])
def test_packed_ring_matches_jax(packed_case, dp, sp):
    """``dp_sp_epoch_packed`` (the ring of K2 raw-int32 shard GEMMs) over 2
    copies of the batch == JAX ``qgcn_forward`` (PACKED-RING-{2,8}BIT-OK)."""
    bits, words, x, ws, ref = packed_case
    mesh = make_mesh(dp, sp, _cpu(dp * sp))
    a_sh, x_sh = shard_packed_batches(mesh, torch.stack([words] * 2), torch.stack([x.digits] * 2))
    assert a_sh.parts[0][0].is_contiguous() and a_sh.parts[0][0].shape == (2 // dp, sp, 1, 1024 // sp // 32,
                                                                            1024 // sp)
    out = dp_sp_epoch_packed(mesh, a_sh, x_sh, ws, bits, x_bits=bits, x_cols=128).gather()
    assert out.shape == (2, 1024, 128)
    for o in out:
        np.testing.assert_array_equal(o.numpy(), ref[:1024, :128])


@pytest.fixture(scope="module")
def dense_case():
    """A random 512-node batch at 2 and 8 bits, JAX's GCN and GIN over it."""
    out = {}
    for bits in (2, 8):
        qa, qx, qws = _operands(bits, 512, 10 + bits)
        ja, jx = jdigits.digit_pack(jnp.asarray(qa), 1), jdigits.digit_pack(jnp.asarray(qx), bits)
        jws = [jdigits.digit_pack(jnp.asarray(w), bits) for w in qws]
        refs = {m: np.asarray(f(ja, jx, jws, out_bits=bits))
                for m, f in (("gcn", jqmodels.qgcn_forward), ("gin", jqmodels.qgin_forward))}
        out[bits] = (digit_pack(torch.from_numpy(qa), 1), digit_pack(torch.from_numpy(qx), bits),
                     [digit_pack(torch.from_numpy(w), bits) for w in qws], refs)
    return out


@pytest.mark.parametrize("fn,model,bits", [
    (sp_gcn_forward, "gcn", 2), (sp_gcn_forward_ring, "gcn", 2), (sp_gin_forward, "gin", 2),
    (sp_gin_forward_ring, "gin", 2), (sp_gcn_forward_ring, "gcn", 8), (sp_gin_forward_ring, "gin", 8),
])
def test_sp_forwards_match_jax(dense_case, fn, model, bits):
    """The dense digit-plane forwards over sp 4 == JAX's single-device
    forwards (SP-OK, RING-OK, RING-GIN-OK, RING-8BIT-OK)."""
    a, x, ws, refs = dense_case[bits]
    got = fn(make_mesh(1, 4, _cpu(4)), a, x, ws, bits)
    np.testing.assert_array_equal(got.numpy(), refs[model][:512, :128])


@pytest.mark.parametrize("agg_mode", ["ring", "gather"])
@pytest.mark.parametrize("model", ["gcn", "gin"])
def test_dp_sp_epoch_step_matches_jax(dense_case, agg_mode, model):
    """``dp_sp_epoch_step`` at (2, 2) over 4 copies, both aggregations ==
    JAX's forwards (DP-SP-OK)."""
    a, x, ws, refs = dense_case[2]
    out = dp_sp_epoch_step(make_mesh(2, 2, _cpu(4)), torch.stack([a.digits] * 4), torch.stack([x.digits] * 4), ws,
                           2, x_bits=2, model=model, agg_mode=agg_mode).gather()
    assert out.shape == (4, 512, 128)
    for o in out:
        np.testing.assert_array_equal(o.numpy(), refs[model][:512, :128])


def test_dp_mega_compacted_schedule_matches_golden():
    """dp 4 over a block-sparse 1024-node A, 8 batches, with the
    occupancy-compacted schedule sharded with the batches == the port's
    golden (DP-COMPACT-OK, JAX ``tests/test_parallel.py:188-215``)."""
    rng = np.random.default_rng(3)
    pn, xdim, hid, cls, B = 1024, 100, 16, 12, 8
    qas = []
    for _ in range(B):
        qa = np.zeros((pn, pn), np.int32)
        qa[:512, :512] = (rng.random((512, 512)) < 0.03).astype(np.int32)
        qa[512:, 512:] = (rng.random((512, 512)) < 0.03).astype(np.int32)
        qas.append(qa)
    qx = rng.integers(0, 4, (pn, xdim)).astype(np.int32)
    qws = [(rng.random(s) < 0.1).astype(np.int32) for s in ((xdim, hid), (hid, hid), (hid, cls))]
    ws = [digit_pack(torch.from_numpy(w), 2) for w in qws]
    words = [pack_rows_np(q, 1) for q in qas]
    sched = torch.from_numpy(np.stack([mega_block_sched(w, 512, mega_colblock(pn)) for w in words]))
    x = digit_pack(torch.from_numpy(qx), 2).digits[0]
    x_st = x[None, None].expand(B, 1, pn, 128).contiguous()
    a_st = torch.from_numpy(np.stack([w[0] for w in words]))
    out = dp_mega_epoch_packed(make_mesh(4, 1, _cpu(4)), a_st, x_st, ws, 2, model="gcn", resident_a=True,
                               blk_sched=sched, out_cols=cls, x_cols=xdim).gather()
    assert sched[:, :, 0].sum() < sched.shape[0] * sched.shape[1] * (sched.shape[2] - 1)  # blocks are skipped
    for o, qa in zip(out, qas):
        gold = qmodels.qgcn_golden(qa, qx, qws, 2, 2)
        np.testing.assert_array_equal(o[:, :cls].numpy(), gold[:, :cls].astype(np.float32))


# -- MeshEngine against JAX's single-device engine ------------------------------


@pytest.fixture(scope="module", params=["gcn", "gin"])
def engines(request):
    """Proteins at scale 0.05, psize 8, batch 2 (one bucket, 4 batches at pn 1024),
    the JAX engine's logits and accuracy, and its float weights."""
    model = request.param
    ds, jds = graph.synthesize("Proteins", scale=0.05, seed=0), jgraph.synthesize("Proteins", scale=0.05, seed=0)
    kw = dict(psize=8, batch_size=2, bit_width=2, shuffle=False, partition_method="bfs")
    it, jit = graph.ClusterBatcher(ds, **kw), jgraph.ClusterBatcher(jds, **kw)
    je = JaxEngine(jit.feat_dim, jds.num_classes, model=model, bit_width=2, seed=0)
    refs = [np.asarray(je.forward_batch(b))[: b.num_nodes, : jds.num_classes] for b in jit.batches]
    correct = sum(int((r.argmax(1) == jds.labels[b.nodes]).sum()) for r, b in zip(refs, jit.batches))
    acc = correct / sum(b.num_nodes for b in jit.batches)
    return model, ds, it, [np.asarray(w) for w in je.float_weights], refs, acc


@pytest.mark.parametrize("dp,sp", [(1, 1), (4, 1), (2, 2)])
def test_mesh_engine_matches_jax_engine(engines, dp, sp):
    """``MeshEngine`` fed JAX's integer weight levels == JAX's
    ``QGTCEngine.forward_batch`` on every batch; modes mega at sp 1 (K1
    accepts every bucket, as JAX's VMEM plan does) and ring at sp 2;
    ``evaluate`` scores as JAX's logits do (MESH-ENGINE-*-OK)."""
    model, ds, it, fws, refs, acc = engines
    eng = MeshEngine(it.feat_dim, ds.num_classes, dp=dp, sp=sp, model=model, bit_width=2, seed=0, devices=_cpu(dp * sp))
    eng.weights = qmodels.weights_from_jax(fws, 2)
    outs = eng.forward_batches(it)
    assert len(outs) == len(refs) == 4
    for o, r in zip(outs, refs):
        np.testing.assert_array_equal(o.numpy(), r)
    assert set(eng.modes) == ({"mega"} if sp == 1 else {"ring"})
    assert [s.padded for s in eng._staged] == [-(-len(s.batches) // dp) * dp for s in eng._staged]
    assert eng.evaluate(it, ds.labels) == acc


def test_mesh_engine_run_epochs_and_k1_refusal(engines, capsys, monkeypatch):
    """``run_epochs`` times every bucket; a bucket K1 refuses runs the packed
    ring at sp 1, loudly, its mode ``ring``, and its logits still equal JAX's
    engine's."""
    model, ds, it, fws, refs, _ = engines
    eng = MeshEngine(it.feat_dim, ds.num_classes, dp=2, model=model, bit_width=2, seed=0, devices=_cpu(2))
    eng.weights = qmodels.weights_from_jax(fws, 2)
    stats = eng.run_epochs(it, n_epochs=2)
    assert stats.n_batches == 4 and stats.avg_ms > 0 and set(eng.modes) == {"mega"}
    from qgtc_ppopp22_tpu_torch.ops import fused_model

    real, refused = fused_model.plan, it.batches[-1].padded_nodes

    def refuse(a_shape, *a, **k):
        if a_shape[2] == refused:
            raise ValueError("refused for the test")
        return real(a_shape, *a, **k)

    monkeypatch.setattr(fused_model, "plan", refuse)
    eng.stage(it)
    assert eng.modes == ["ring" if s.pn == refused else "mega" for s in eng._staged]
    assert all(s.info["fallback"] == (s.pn == refused) for s in eng._staged)
    assert "K1 refuses it, running the packed ring at sp 1" in capsys.readouterr().out
    for o, r in zip(eng.forward_batches(it), refs):
        np.testing.assert_array_equal(o.numpy(), r)


@pytest.mark.parametrize("engine", ["mesh", "mega"])
def test_staging_errors_are_not_refusals(engine, capsys, monkeypatch):
    """Only K1's plan refusing a bucket sends it to an engine's fallback: a
    ``ValueError`` raised while staging a planned bucket propagates, from
    ``MeshEngine.stage`` and from the single-device mega engine alike."""
    from qgtc_ppopp22_tpu_torch.ops import fused_model

    ds = graph.synthesize("Proteins", scale=0.05, seed=0)
    it = graph.ClusterBatcher(ds, psize=8, batch_size=2, bit_width=2, shuffle=False)

    def broken(*a, **k):
        raise ValueError("a staging fault")

    monkeypatch.setattr(fused_model, "pack_mega_weights", broken)
    with pytest.raises(ValueError, match="a staging fault"):
        if engine == "mesh":
            MeshEngine(it.feat_dim, ds.num_classes, dp=2, seed=0, devices=_cpu(2)).stage(it)
        else:
            QGTCEngine(it.feat_dim, ds.num_classes, seed=0, device="cpu", fmt="digits")._stage_mega(it)
    out = capsys.readouterr().out
    assert "falling back" not in out and "K1 refuses" not in out


def test_make_mesh_and_cuda_refusals():
    mesh = make_mesh(2, 2, _cpu(5))
    assert mesh.shape == {"dp": 2, "sp": 2} and mesh.distinct() == [torch.device("cpu")]
    with pytest.raises(ValueError, match="need 4 devices, have 3"):
        make_mesh(2, 2, _cpu(3))
    if not torch.cuda.is_available():
        for fn in (lambda: make_mesh(1, 1), lambda: make_mesh(2, 1, ["cuda:0"] * 2),
                   lambda: MeshEngine(16, 4, dp=1)):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                fn()


def test_dryrun_multichip_and_entry(capsys):
    """``dryrun_multichip(4)`` over a repeated CPU device: (4, 1) mega and
    (2, 2) ring, each bit-exact against the single-device engine; and
    ``entry``'s step."""
    dryrun_multichip(4, _cpu(4))
    out = capsys.readouterr().out
    assert "dp=4 sp=1 (K1 per dp row): bit-exact, bucket modes ['mega', 'mega']" in out
    assert "dp=2 sp=2 (packed ring): bit-exact, bucket modes ['ring', 'ring']" in out
    fn, args = entry("cpu")
    assert tuple(fn(*args).shape) == (args[0].shape[0], 2)


# -- the CLI's --mesh -----------------------------------------------------------

_ARGV = ["--dataset", "ppi", "--dataset-scale", "0.01", "--psize", "4", "--batch-size", "2", "--n-epochs", "1",
         "--device", "cpu"]


@pytest.mark.parametrize("mesh,modes", [("2,1", {"mega"}), ("1,2", {"ring"})])
def test_cli_mesh_record(capsys, mesh, modes):
    """``--mesh`` over a CPU mesh: exit 0 and JAX's record (``engine``
    ``qgtc-mesh-dp{dp}-sp{sp}``, ``mesh_modes``); sp 2 rounds the buckets up
    to 512 rows; the flags the mesh does not read warn."""
    with contextlib.redirect_stderr(io.StringIO()) as err:
        rc = cli.main([*_ARGV, "--mesh", mesh, "--eval-accuracy", "--mode", "mega", "--bucket-rows", "256"])
    assert rc == 0 and "warning: --mode has no effect with --mesh" in err.getvalue()
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    dp, sp = mesh.split(",")
    assert record["engine"] == f"qgtc-mesh-dp{dp}-sp{sp}" and record["mesh"] == mesh
    assert set(record["mesh_modes"]) == modes and 0.0 <= record["accuracy"] <= 1.0
    assert record["bucket_rows"] == (512 if sp == "2" else 256)


@pytest.mark.parametrize("bad", ["2", "2,x", "0,1", "1,2,3"])
def test_cli_bad_mesh_exits_2(capsys, bad):
    with pytest.raises(SystemExit) as exc:
        cli.main(["--mesh", bad, "--device", "cpu"])
    assert exc.value.code == 2 and "bad --mesh" in capsys.readouterr().err
