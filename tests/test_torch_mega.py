"""The mega engine of the PyTorch port against the JAX package.

``fused_model_epoch`` (its plain version here, on the CPU) against the
JAX ``fused_model_epoch`` in Pallas interpret mode and against the NumPy
golden chains; the occupancy builders and the feature staging against
their JAX counterparts (the engine, ``QGTCEngine.run_epochs_mega``, and
its CLI: ``test_torch_mega_engine.py``). Inputs come from NumPy seeds;
weights are the same integer levels in both packages. Tolerance: exact
equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgtc_ppopp22_tpu import runtime as jruntime
from qgtc_ppopp22_tpu.models.qmodels import qgcn_golden, qgin_golden
from qgtc_ppopp22_tpu.ops import digits as jdigits
from qgtc_ppopp22_tpu.ops.fused_model import fused_model_epoch as jax_fused_model_epoch
from qgtc_ppopp22_tpu_torch import graph, runtime
from qgtc_ppopp22_tpu_torch.ops import digits
from qgtc_ppopp22_tpu_torch.ops.fused_model import (
    fused_model_epoch,
    fused_model_epoch_plain,
    mega_colblock,
)
from torch_cases import mega_case
from torch_threads import one_thread  # noqa: F401  (an autouse fixture: one torch thread)

SHIFTS = [1, 2, 1, 2, 1]
# keep[b][c]: occupied column blocks of row chunk c in batch b
KEEP_512 = [[[0, 1]], [[1]]]  # pn 512: one chunk, 2 blocks of 256
KEEP_1024 = [[[0, 1, 2, 3], [2]], [[], [0, 2, 3]]]  # all, 1, none, 3


def _port_ws(qws, bits):
    return [digits.digit_pack(torch.from_numpy(w), bits) for w in qws]


def _jax_ws(qws, bits):
    return [jdigits.digit_pack(jnp.asarray(w), bits) for w in qws]


def _sched(a_words, chunk, cb):
    return np.stack([runtime.mega_block_sched(w[None], chunk, cb) for w in a_words])


# (pn, keep, compact, shifts, out_cols)
VARIANTS = {
    "dense": (512, KEEP_512, False, None, None),
    "compact-shifts-outcols": (512, KEEP_512, True, SHIFTS, 40),
    "compact-4blocks": (1024, KEEP_1024, True, None, None),
    "dense-shifts-outcols": (1024, KEEP_1024, False, SHIFTS, 40),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("model", ["gcn", "gin"])
def test_fused_model_matches_jax(model, bits, variant):
    pn, keep, compact, shifts, out_cols = VARIANTS[variant]
    hidden = 16 if model == "gcn" else 64
    qa, qx, qws, aw, xd = mega_case(bits + pn + len(variant), 2, pn, bits, hidden,
                                    keep=keep, shift=1 if shifts else 0)
    sched = _sched(aw, 512, 256) if compact else None
    kw = dict(model=model, shifts=shifts, out_cols=out_cols, x_cols=128)
    got = fused_model_epoch(
        torch.from_numpy(aw), torch.from_numpy(xd), _port_ws(qws, bits), bits,
        blk_sched=None if sched is None else torch.from_numpy(sched), **kw)
    ref = np.asarray(jax_fused_model_epoch(
        jnp.asarray(aw), jnp.asarray(xd), _jax_ws(qws, bits), bits,
        blk_sched=None if sched is None else jnp.asarray(sched), **kw))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert got.shape == (2, pn, 40 if out_cols else 128)
    np.testing.assert_array_equal(got.numpy(), ref)
    # the chain neither saturated nor vanished
    assert len(np.unique(ref)) > (2 if bits == 1 else 4)


@pytest.mark.parametrize("bits", [2, 8])
@pytest.mark.parametrize("model", ["gcn", "gin"])
def test_fused_model_golden_nine_blocks(model, bits):
    """pn = 2304: chunks of 256 rows, 9 column blocks of 256, chunks
    with all 9 blocks, none, one, and odd and even counts."""
    pn = 2304
    counts = [9, 0, 1, 5, 8, 3, 9, 7, 2]
    keep = [[list(range(c)) if i % 2 else list(range(9 - c, 9)) for i, c in enumerate(counts)]]
    qa, qx, qws, aw, xd = mega_case(bits, 1, pn, bits, 16, keep=keep, chunk=256, cb=256)
    sched = _sched(aw, 256, 256)
    assert sched.shape == (1, 9, 10) and sched[0, :, 0].tolist() == counts
    ws = _port_ws(qws, bits)
    args = (torch.from_numpy(aw), torch.from_numpy(xd), ws, bits)
    got = fused_model_epoch(*args, model=model, blk_sched=torch.from_numpy(sched))
    gold = (qgcn_golden if model == "gcn" else qgin_golden)(qa[0], qx[0], qws, bits, bits)
    np.testing.assert_array_equal(got[0, :, :40].numpy(), gold)
    assert not got[0, :, 40:].any()
    assert torch.equal(got, fused_model_epoch(*args, model=model))


def test_schedule_drops_unlisted_blocks():
    """A schedule that leaves out occupied blocks multiplies only the
    listed ones: the plain version zeroes the rest of the adjacency."""
    qa, qx, qws, aw, xd = mega_case(1, 1, 512, 2, 16)
    ws = _port_ws(qws, 2)
    sched = torch.tensor([[[1, 1, 0]]], dtype=torch.int32)  # block 1 only
    got = fused_model_epoch(torch.from_numpy(aw), torch.from_numpy(xd), ws, 2,
                            blk_sched=sched)
    qa_kept = qa.copy()
    qa_kept[:, :, :256] = 0
    gold = qgcn_golden(qa_kept[0], qx[0], qws, 2, 2)
    np.testing.assert_array_equal(got[0, :, :40].numpy(), gold)
    with pytest.raises(ValueError, match="not a schedule"):
        fused_model_epoch(torch.from_numpy(aw), torch.from_numpy(xd), ws, 2,
                          blk_sched=torch.tensor([[[2, 1, 1]]], dtype=torch.int32))


@pytest.mark.parametrize("chunk,cb", [(512, 512), (512, 256), (256, 256)])
def test_occupancy_builders_match_jax(chunk, cb):
    keep = [[[0, 3], [1], [], [0, 1, 2, 3]]]
    _, _, _, aw, _ = mega_case(4, 1, 1024, 2, 16, keep=keep, chunk=256, cb=256)
    w = aw[0][None]
    for name in ("mega_block_occ", "mega_block_sched"):
        port, ref = getattr(runtime, name)(w, chunk, cb), getattr(jruntime, name)(w, chunk, cb)
        assert port.dtype == ref.dtype and port.tobytes() == ref.tobytes()
    port, ref = runtime.mega_chunk_occ(w, chunk), jruntime.mega_chunk_occ(w, chunk)
    assert port.dtype == ref.dtype and port.tobytes() == ref.tobytes()
    assert mega_colblock(2560) == 512 and mega_colblock(2304) == 768 and mega_colblock(512) == 256


@pytest.mark.parametrize("bits", [2, 8])
def test_planes_stack_to_digits_matches_jax(bits):
    rng = np.random.default_rng(bits)
    q = rng.integers(0, 1 << bits, (3, 300, 100))
    planes = np.stack([graph.batching.pack_bits_np(x, bits).planes.numpy() for x in q])
    got = digits.planes_stack_to_digits(torch.from_numpy(planes), (300, 100), bits)
    ref = jdigits.planes_stack_to_digits(jnp.asarray(planes.view(np.uint32)), (300, 100), bits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("kwargs", [
    dict(x_levels_bits=8), dict(chunk_occ=torch.ones((1, 1), dtype=torch.int32)), dict(resident_a=False),
    dict(unpack_once=True),
])
def test_fused_model_refuses_unported_forms(kwargs):
    """The TPU's unpack-once tier is refused by name; the JAX kernel's
    predicated occupancy map, its streamed-A tier and levels-form X run
    (a full map and ``resident_a=False`` give the dense logits; the digit
    plane read as byte levels takes the signed chain to the same logits,
    padded columns included)."""
    _, _, qws, aw, xd = mega_case(0, 1, 512, 2, 16)
    args = (torch.from_numpy(aw), torch.from_numpy(xd), _port_ws(qws, 2), 2)
    if "unpack_once" not in kwargs:
        assert torch.equal(fused_model_epoch(*args, **kwargs), fused_model_epoch(*args))
        return
    with pytest.raises(NotImplementedError, match="not yet ported: .*unpack-once"):
        fused_model_epoch(*args, **kwargs)


def test_fused_model_refuses_bad_shapes():
    _, _, qws, aw, xd = mega_case(0, 1, 512, 2, 16)
    ws = _port_ws(qws, 2)
    a, x = torch.from_numpy(aw), torch.from_numpy(xd)
    with pytest.raises(ValueError, match="stacked shapes"):
        fused_model_epoch(a[:, :, :384], x, ws, 2)
    with pytest.raises(ValueError, match="blk_sched"):
        fused_model_epoch(a, x, ws, 2, blk_sched=torch.zeros((1, 2, 3), dtype=torch.int32))
    with pytest.raises(ValueError, match="shifts"):
        fused_model_epoch(a, x, ws, 2, shifts=[1, 2])


def test_plain_is_the_cpu_path():
    _, _, qws, aw, xd = mega_case(2, 1, 512, 2, 16)
    args = (torch.from_numpy(aw), torch.from_numpy(xd), _port_ws(qws, 2), 2)
    assert torch.equal(fused_model_epoch(*args), fused_model_epoch_plain(*args))
