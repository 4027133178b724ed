"""Zero-tile jumping in the PyTorch port against the JAX package.

The ``TileMap`` K skip of ``packmm`` and ``digitmm`` (their plain
versions here, on the CPU), the map builders, both models with a map,
``fused_model_epoch(chunk_occ=)`` and the CLI's tile counters, against
the JAX ops in Pallas interpret mode. Inputs come from NumPy seeds.
Tolerance: exact equality, padding included. Hand-made maps stay inside
the tile grid: JAX leaves an index outside it undefined.
"""

import json
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgtc_ppopp22_tpu import cli as jcli
from qgtc_ppopp22_tpu import runtime as jruntime
from qgtc_ppopp22_tpu.models import qmodels as jqmodels
from qgtc_ppopp22_tpu.ops import digitmm as jdigitmm
from qgtc_ppopp22_tpu.ops import digits as jdigits
from qgtc_ppopp22_tpu.ops import packmm as jpackmm
from qgtc_ppopp22_tpu.ops.bitgemm import TileMap as JaxTileMap
from qgtc_ppopp22_tpu.ops.fused_model import fused_model_epoch as jax_fused_model_epoch
from qgtc_ppopp22_tpu_torch import cli
from qgtc_ppopp22_tpu_torch.models import qmodels
from qgtc_ppopp22_tpu_torch.ops import _gemm, digitmm, digits, fused_model, packmm
from qgtc_ppopp22_tpu_torch.ops.bitgemm import TileMap
from torch_cases import mega_case, operands
from torch_threads import one_thread  # noqa: F401  (an autouse fixture: one torch thread)


def _jmap(tm):
    return JaxTileMap(kidx=jnp.asarray(tm.kidx.numpy()), kcnt=jnp.asarray(tm.kcnt.numpy()),
                      tile_m=tm.tile_m, tile_k=tm.tile_k)


def _same_map(tm, jtm):
    assert (tm.tile_m, tm.tile_k) == (jtm.tile_m, jtm.tile_k)
    assert tm.kidx.dtype == tm.kcnt.dtype == torch.int32
    np.testing.assert_array_equal(tm.kidx.numpy(), np.asarray(jtm.kidx))
    np.testing.assert_array_equal(tm.kcnt.numpy(), np.asarray(jtm.kcnt))


def _hand(tm, rows):
    """A copy of ``tm`` with ``rows[i] = list of K tiles`` for row tile i:
    occupied tiles left out, a tile listed twice, a row of kcnt 0."""
    kidx, kcnt = tm.kidx.clone(), tm.kcnt.clone()
    nk = kidx.shape[1]
    for i, ks in rows.items():
        kidx[i] = torch.tensor((list(ks) + [ks[-1] if ks else 0] * nk)[:nk], dtype=torch.int32)
        kcnt[i] = len(ks)
    return TileMap(kidx, kcnt, tm.tile_m, tm.tile_k)


def _blocky(seed, m, k, bits, keep):
    """Levels A (m x k) at ``bits`` whose occupied 256 x 256 tiles are
    exactly ``keep`` (a set of (row tile, K tile)), at a linear-range
    density."""
    qa, _ = operands(seed, m, k, 16, bits, 2, 2, 0)
    mask = np.zeros((m, k), bool)
    for i, j in keep:
        mask[i * 256:(i + 1) * 256, j * 256:(j + 1) * 256] = True
        qa[i * 256, j * 256] = 1  # occupied for sure
    return np.where(mask, qa, 0).astype(np.int32)


# row tiles of 256 over M = 1024, K tiles of 256 over K = 768: row tile 3
# is empty, row tile 0 holds two of three
KEEP = {(0, 0), (0, 2), (1, 1), (2, 0), (2, 1), (2, 2)}
HAND = {0: [2, 2], 1: [], 2: [1]}  # a duplicate, an empty row, occupied tiles left out


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_build_tile_map_packed_matches_jax(bits):
    qa = _blocky(bits, 1024, 768, bits, KEEP)
    a = packmm.pack_rows(torch.from_numpy(qa), bits)
    ja = jpackmm.pack_rows(jnp.asarray(qa), bits)
    for tiles in ((None, None), (256, 256), (512, 256), (256, 128)):
        _same_map(packmm.build_tile_map_packed(a, *tiles), jpackmm.build_tile_map_packed(ja, *tiles))
    tm = packmm.build_tile_map_packed(a, 256, 256)
    assert tm.kcnt.tolist() == [2, 1, 3, 0]
    # the batcher's host builder agrees with the device builder
    kidx, kcnt = packmm.build_tile_map_packed_np(a.words.numpy(), bits)
    assert np.array_equal(kidx, tm.kidx.numpy()) and np.array_equal(kcnt, tm.kcnt.numpy())
    with pytest.raises(ValueError):
        packmm.build_tile_map_packed(a, 384, 256)


@pytest.mark.parametrize("mk", [(512, 768), (384, 640)])
def test_digit_tile_builders_match_jax(mk):
    m, k = mk
    qa = _blocky(7, m, k, 2, {(0, 0), (1, 2)} if m == 512 else {(0, 0), (1, 1)})
    da = digits.digit_pack(torch.from_numpy(qa), 2)
    jda = jdigits.digit_pack(jnp.asarray(qa), 2)
    assert digitmm.digit_lhs_tiles(da) == tuple(jdigitmm.digit_lhs_tiles(jda))
    for tiles in ((None, None), (128, 128), (None, 128)):
        _same_map(digitmm.build_tile_map_digits(da, *tiles), jdigitmm.build_tile_map_digits(jda, *tiles))
        assert digitmm.zero_tile_stats_digits(da, *tiles) == jdigitmm.zero_tile_stats_digits(jda, *tiles)


def _packmm_forms(lib, a, b, tm):
    """Every output form of a packed-A product with the map ``tm``."""
    return [lib.packmm_to_digits(a, b, 2, tile_map=tm, shift=1), lib.packmm_to_f32(a, b, tile_map=tm),
            lib.packmm_to_i32(a, b, tile_map=tm), lib.packmm_to_packed(a, b, 2, tile_map=tm),
            lib.packmm_to_packed(a, b, 8, tile_map=tm, out_cols=40)]


def _same(got, ref):
    if hasattr(got, "words"):
        assert got.shape == ref.shape and got.bits == ref.bits
        want = np.asarray(ref.words)
        np.testing.assert_array_equal(got.words.numpy(), want.view(np.int32) if want.dtype == np.uint32 else want)
    elif hasattr(got, "digits"):
        np.testing.assert_array_equal(got.digits.numpy(), np.asarray(ref.digits))
    else:
        assert got.dtype == (torch.int32 if np.asarray(ref).dtype == np.int32 else torch.float32)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("kind", ["real", "hand"])
@pytest.mark.parametrize("bits", [1, 8])
def test_packmm_tile_map_matches_jax(bits, kind):
    qa = _blocky(bits + 3, 1024, 768, bits, KEEP)
    qb = operands(bits, 768, 768, 40, 1, 2, 2, 0)[1]
    a = packmm.pack_rows(torch.from_numpy(qa), bits)
    b = digits.digit_pack(torch.from_numpy(qb), 2)
    ja, jb = jpackmm.pack_rows(jnp.asarray(qa), bits), jdigits.digit_pack(jnp.asarray(qb), 2)
    tm = packmm.build_tile_map_packed(a, 256, 256)
    if kind == "hand":
        tm = _hand(tm, HAND)
    for got, ref in zip(_packmm_forms(packmm, a, b, tm), _packmm_forms(jpackmm, ja, jb, _jmap(tm))):
        _same(got, ref)
    dense = packmm.packmm_to_f32(a, b)
    sparse = packmm.packmm_to_f32(a, b, tm)
    # a real map changes nothing; a hand-made one masks and doubles tiles
    assert torch.equal(sparse, dense) == (kind == "real")
    assert torch.equal(packmm.packmm_plain(a, b, tile_map=tm), sparse)


@pytest.mark.parametrize("kind", ["real", "hand"])
@pytest.mark.parametrize("bits", [2, 8])
def test_digitmm_tile_map_matches_jax(bits, kind):
    qa = _blocky(bits + 5, 768, 768, bits, {(0, 0), (0, 2), (1, 1), (2, 2)})
    qb = operands(bits + 1, 768, 768, 40, 1, bits, bits, 0)[1]
    da, b = digits.digit_pack(torch.from_numpy(qa), bits), digits.digit_pack(torch.from_numpy(qb), bits)
    jda, jb = jdigits.digit_pack(jnp.asarray(qa), bits), jdigits.digit_pack(jnp.asarray(qb), bits)
    tm = digitmm.build_tile_map_digits(da)
    if kind == "hand":
        tm = _hand(tm, {0: [2, 2, 1], 1: []})
    jtm = _jmap(tm)
    _same(digitmm.digitmm_to_digits(da, b, bits, tm, shift=2),
          jdigitmm.digitmm_to_digits(jda, jb, bits, tile_map=jtm, shift=2))
    _same(digitmm.digitmm_to_f32(da, b, tm), jdigitmm.digitmm_to_f32(jda, jb, tile_map=jtm))
    _same(digitmm.digitmm_to_i32(da, b, tm), jdigitmm.digitmm_to_i32(jda, jb, tile_map=jtm))


def test_tile_map_checks():
    a = packmm.pack_rows(torch.ones((512, 512), dtype=torch.int32), 1)
    b = digits.digit_pack(torch.ones((512, 16), dtype=torch.int32), 2)
    tm = packmm.build_tile_map_packed(a, 256, 256)
    for bad, match in (
        (TileMap(tm.kidx, tm.kcnt, 128, 256), "tile_m must be a multiple of 256"),
        (TileMap(tm.kidx, tm.kcnt, 256, 96), "do not divide"),
        (TileMap(tm.kidx[:, :1], tm.kcnt, 256, 256), "tile grid"),
        (TileMap(tm.kidx, tm.kcnt[:1], 256, 256), "tile grid"),
    ):
        with pytest.raises(ValueError, match=match):
            packmm.packmm_to_f32(a, b, bad)
    da = digits.digit_pack(torch.ones((256, 512), dtype=torch.int32), 2)
    with pytest.raises(ValueError, match="tile grid"):
        digitmm.digitmm_to_f32(da, b, digitmm.build_tile_map_digits(digits.digit_pack(
            torch.ones((512, 512), dtype=torch.int32), 2)))
    # the map of a visit count: each element's tile counted per listing
    w = _gemm.tile_weights(_hand(tm, {0: [1, 1], 1: []}), 512, 512)
    assert w[:256, :256].eq(0).all() and w[:256, 256:].eq(2).all() and w[256:].eq(0).all()


@pytest.mark.parametrize("a_kind", ["packed", "digits"])
@pytest.mark.parametrize("model", ["gcn", "gin"])
def test_models_with_tile_map_match_jax(model, a_kind):
    """JAX ``tests/test_models.py:119-143``: both forwards with a map, over
    the packed adjacency (K2) and over a digit-plane adjacency (K3)."""
    rng = np.random.default_rng(11 + (model == "gin"))
    n, feat, hidden, ncls = 768, 128, 16 if model == "gcn" else 64, 40
    qa = _blocky(13, n, n, 1, {(0, 0), (0, 1), (1, 1), (2, 2)})
    qx = rng.integers(0, 4, (n, feat)).astype(np.int32)
    dims = [feat, hidden, hidden, ncls]
    qws = [(rng.random((dims[i], dims[i + 1])) < 0.08).astype(np.int32) * rng.integers(1, 4, (dims[i], dims[i + 1]))
           for i in range(3)]
    ws = [digits.digit_pack(torch.from_numpy(w), 2) for w in qws]
    jws = [jdigits.digit_pack(jnp.asarray(w), 2) for w in qws]
    x, jx = digits.digit_pack(torch.from_numpy(qx), 2), jdigits.digit_pack(jnp.asarray(qx), 2)
    if a_kind == "packed":
        a, ja = packmm.pack_rows(torch.from_numpy(qa), 1), jpackmm.pack_rows(jnp.asarray(qa), 1)
        tm = packmm.build_tile_map_packed(a, 256, 256)
    else:
        a, ja = digits.digit_pack(torch.from_numpy(qa), 1), jdigits.digit_pack(jnp.asarray(qa), 1)
        tm = digitmm.build_tile_map_digits(a)
    assert tm.kcnt.tolist() == [2, 1, 1]
    fwd = qmodels.qgcn_forward if model == "gcn" else qmodels.qgin_forward
    jfwd = jqmodels.qgcn_forward if model == "gcn" else jqmodels.qgin_forward
    got = fwd(a, x, ws, 2, tile_map=tm)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jfwd(ja, jx, jws, 2, tile_map=_jmap(tm))))
    np.testing.assert_array_equal(got.numpy(), (jqmodels.qgcn_golden if model == "gcn"
                                                else jqmodels.qgin_golden)(qa, qx, qws, 2, 2))
    assert torch.equal(fwd(a, x, ws, 2, tile_map=tm, plain=True), got)
    assert len(np.unique(got.numpy())) > 4  # the chain neither saturated nor vanished


# -- fused_model_epoch(chunk_occ=): compacted onto the block-schedule launch --


def _jax_occ(occ):
    return jnp.asarray(occ.numpy())


@pytest.mark.parametrize("form", ["1d", "1d-hand", "2d", "2d-hand"])
@pytest.mark.parametrize("model", ["gcn", "gin"])
def test_fused_model_chunk_occ_matches_jax(model, form):
    """JAX ``tests/test_signed_mega.py:168`` at 2 bits: real occupancy
    maps (equal to dense) and hand-made ones that flag occupied chunks or
    blocks 0 (equal to the adjacency with those blocks zeroed)."""
    pn, chunk = 1024, 512
    keep = [[[0, 1, 2, 3], []], [[1], [0, 2, 3]]]  # batch 0: chunk 1 empty
    qa, qx, qws, aw, xd = mega_case(31 + len(form), 2, pn, 2, 16 if model == "gcn" else 64, keep=keep)
    if form.startswith("1d"):
        occ = np.stack([jruntime.mega_chunk_occ(w[None], chunk) for w in aw])
        if form == "1d-hand":
            occ[1, 1] = 0  # batch 1's second chunk holds edges
    else:
        occ = np.stack([jruntime.mega_block_occ(w[None], chunk, 256) for w in aw])
        if form == "2d-hand":
            occ[0, 0, 2] = 0
            occ[1, 1, 0] = 0
    occ = torch.from_numpy(occ.astype(np.int32))
    ws = [digits.digit_pack(torch.from_numpy(w), 2) for w in qws]
    jws = [jdigits.digit_pack(jnp.asarray(w), 2) for w in qws]
    args = (torch.from_numpy(aw), torch.from_numpy(xd), ws, 2)
    got = fused_model.fused_model_epoch(*args, model=model, chunk_occ=occ)
    ref = np.asarray(jax_fused_model_epoch(jnp.asarray(aw), jnp.asarray(xd), jws, 2, model=model,
                                           chunk_occ=_jax_occ(occ)))
    np.testing.assert_array_equal(got.numpy(), ref)
    dense = fused_model.fused_model_epoch(*args, model=model)
    assert torch.equal(got, dense) == (not form.endswith("hand"))
    # the compacted schedule runs the same as the map
    sched = fused_model.chunk_occ_sched(occ, 2, pn, chunk)
    assert torch.equal(fused_model.fused_model_epoch(*args, model=model, blk_sched=sched), got)


def test_chunk_occ_sched_and_refusals():
    occ2 = torch.tensor([[1, 0], [0, 1]], dtype=torch.int32)
    assert fused_model.chunk_occ_sched(occ2, 2, 1024, 512).tolist() == [[[1, 0], [0, 0]], [[0, 0], [1, 0]]]
    occ3 = torch.tensor([[[0, 1, 0, 1], [0, 0, 0, 0]]], dtype=torch.int32)
    assert fused_model.chunk_occ_sched(occ3, 1, 1024, 512).tolist() == [[[2, 1, 3, 0, 0], [0, 0, 0, 0, 0]]]
    _, _, qws, aw, xd = mega_case(0, 1, 1024, 2, 16)
    args = (torch.from_numpy(aw), torch.from_numpy(xd), [digits.digit_pack(torch.from_numpy(w), 2) for w in qws], 2)
    sched = torch.zeros((1, 2, 3), dtype=torch.int32)
    for kw, match in (
        (dict(chunk_occ=torch.ones((1, 3), dtype=torch.int32)), r"chunk_occ shape \(1, 3\) != \(1, 2\)"),
        (dict(chunk_occ=torch.ones((1, 2, 3), dtype=torch.int32)), "incompatible"),
        (dict(chunk_occ=torch.ones((1, 2), dtype=torch.int32), blk_sched=sched), "exclusive"),
        (dict(blk_sched=sched, resident_a=False), "requires the resident kernel"),
    ):
        with pytest.raises(ValueError, match=match):
            fused_model.fused_model_epoch(*args, **kw)
    # resident_a=False is the same launch as the resident form
    assert torch.equal(fused_model.fused_model_epoch(*args, resident_a=False), fused_model.fused_model_epoch(*args))


# -- the CLI -------------------------------------------------------------------

PPI = ["--dataset", "ppi", "--dataset-scale", "0.01", "--n-epochs", "1", "--partition-method", "bfs"]


def _counters(out):
    m = re.search(r"zero-tile: processed (\d+)/(\d+)", out)
    return int(m[1]), int(m[2])


def test_cli_tile_counters_match_jax(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    argv = [*PPI, "--psize", "8", "--batch-size", "2", "--zerotile_jump"]  # batches of ~140 in 512 rows
    assert jcli.main([*argv, "--use_QGTC", "--cache-dir", str(tmp_path)]) == 0
    ref = _counters(capsys.readouterr().out)
    assert cli.main([*argv, "--data-dir", str(tmp_path), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    record = json.loads(out.strip().splitlines()[-1])
    assert _counters(out) == ref == (record["tiles_processed"], record["tiles_total"])
    assert 0 < ref[0] < ref[1]  # zero tiles exist and are counted


@pytest.mark.parametrize("mode", ["mega", "step"])
def test_cli_zerotile_jump_evaluates(tmp_path, monkeypatch, capsys, mode):
    """``--mode mega --zerotile_jump --eval-accuracy`` used to stop after
    the timed epochs; skipping zero tiles never changes the accuracy."""
    monkeypatch.chdir(tmp_path)
    argv = [*PPI, "--psize", "4", "--batch-size", "2", "--data-dir", str(tmp_path), "--device", "cpu",
            "--mode", mode, "--eval-accuracy"]
    records = []
    for flags in ([], ["--zerotile_jump"]):
        assert cli.main(argv + flags) == 0
        records.append(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
    plain, skip = records
    assert "tiles_total" in skip and "tiles_total" not in plain
    assert [skip[k] for k in ("accuracy", "f1_micro", "f1_macro")] == \
        [plain[k] for k in ("accuracy", "f1_micro", "f1_macro")]
