"""The port's layer API against the JAX package's layers and the goldens.

``QLinear``, ``QAggregation``, ``QGCNConv`` and ``QGINConv`` composed
into 3-layer GCN and GIN models over each adjacency container the port
has (the packed words that reach K2, digit planes that reach K3, bit
planes that reach K6), with and without a zero-tile map, held against
JAX's layer objects (Pallas interpret mode) on the same float weights,
against ``qgcn_forward`` / ``qgin_forward`` and against the NumPy
goldens. Inputs come from NumPy seeds. Tolerance: exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgtc_ppopp22_tpu.models import layers as jlayers
from qgtc_ppopp22_tpu.ops import bitpack as jbitpack
from qgtc_ppopp22_tpu.ops import digits as jdigits
from qgtc_ppopp22_tpu_torch.models import qmodels
from qgtc_ppopp22_tpu_torch.models.golden import bitmm_np, quantize_np
from qgtc_ppopp22_tpu_torch.models.layers import QAggregation, QGCNConv, QGINConv, QLinear
from qgtc_ppopp22_tpu_torch.ops.bitgemm import build_tile_map
from qgtc_ppopp22_tpu_torch.ops.bitpack import BitTensor, pack_bits, unpack_bits
from qgtc_ppopp22_tpu_torch.ops.digitmm import build_tile_map_digits
from qgtc_ppopp22_tpu_torch.ops.digits import digit_pack, digit_unpack
from qgtc_ppopp22_tpu_torch.ops.packmm import build_tile_map_packed, pack_rows
from torch_threads import one_thread  # noqa: F401  (an autouse fixture: one torch thread)

N, DIM, HIDDEN, CLASSES = 512, 40, 16, 8


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(11)
    a = (rng.random((N, N)) < 0.02).astype(np.int32)
    a[256:, :256] = 0  # an all-zero tile for the maps to skip
    x = rng.uniform(-1, 5, (N, DIM)).astype(np.float32)
    dims = [DIM, HIDDEN, HIDDEN, CLASSES]
    ws = [rng.uniform(0, 4, (dims[i], dims[i + 1])).astype(np.float32) for i in range(3)]
    return a, x, ws


def _containers(a, qx, bits, kind):
    """(adjacency, features) in the container ``kind`` and its map."""
    ta, tx = torch.from_numpy(a), torch.from_numpy(qx)
    if kind == "packed":
        pa = pack_rows(ta, 1)
        return pa, digit_pack(tx, bits), build_tile_map_packed(pa)
    if kind == "digits":
        da = digit_pack(ta, 1)
        return da, digit_pack(tx, bits), build_tile_map_digits(da)
    ba = pack_bits(ta, 1)
    return ba, pack_bits(tx, bits), build_tile_map(ba)


def _compose(conv, ws, bits, fmt, a, h, tile_map=None):
    layers = [conv.create(w, bits, tile_map=tile_map, fmt=fmt) for w in ws]
    for lay in layers[:-1]:
        h = lay(a, h)
    return layers[-1](a, h, final=True)


@pytest.mark.parametrize("kind", ["packed", "digits", "bits"])
@pytest.mark.parametrize("model", ["gcn", "gin"])
@pytest.mark.parametrize("mapped", [False, True])
def test_layers_compose_to_the_forwards_and_goldens(inputs, kind, model, mapped):
    a, x, ws = inputs
    bits = 2
    qx = quantize_np(x, bits)
    qws = [quantize_np(w, bits) for w in ws]
    fa, fx, tm = _containers(a, qx, bits, kind)
    tm = tm if mapped else None
    fmt = "bits" if kind == "bits" else "digits"
    conv = QGCNConv if model == "gcn" else QGINConv
    got = _compose(conv, [torch.from_numpy(w) for w in ws], bits, fmt, fa, fx, tm)
    fwd = qmodels.qgcn_forward if model == "gcn" else qmodels.qgin_forward
    want = fwd(fa, fx, qmodels.pack_weights([torch.from_numpy(w) for w in ws], bits, fmt=fmt), bits, tm)
    gold = (qmodels.qgcn_golden if model == "gcn" else qmodels.qgin_golden)(a, qx, qws, bits, bits)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got[:N, :CLASSES].numpy(), gold.astype(np.float32))


@pytest.mark.parametrize("fmt", ["digits", "bits"])
@pytest.mark.parametrize("model", ["gcn", "gin"])
def test_layers_match_jax_layers(inputs, fmt, model):
    a, x, ws = inputs
    bits = 2
    qx = quantize_np(x, bits)
    if fmt == "digits":
        ja, jx = jdigits.digit_pack(jnp.asarray(a), 1), jdigits.digit_pack(jnp.asarray(qx), bits)
    else:
        ja, jx = jbitpack.pack_bits(jnp.asarray(a), 1), jbitpack.pack_bits(jnp.asarray(qx), bits)
    jconv = jlayers.QGCNConv if model == "gcn" else jlayers.QGINConv
    want = np.asarray(_compose(jconv, [jnp.asarray(w) for w in ws], bits, fmt, ja, jx))
    fa, fx, _ = _containers(a, qx, bits, "digits" if fmt == "digits" else "bits")
    conv = QGCNConv if model == "gcn" else QGINConv
    got = _compose(conv, ws, bits, fmt, fa, fx)  # JAX's float weights, as NumPy arrays
    np.testing.assert_array_equal(got[:N, :CLASSES].numpy(), want[:N, :CLASSES])


@pytest.mark.parametrize("fmt", ["digits", "bits"])
def test_primitives_match_golden(inputs, fmt):
    """QLinear and QAggregation one product at a time, to levels (wrapped
    at ``out_bits``) and to float, at 4-bit weights and 1-bit outputs."""
    a, x, ws = inputs
    qx = quantize_np(x, 4)
    fa, fx, tm = _containers(a, qx, 4, "digits" if fmt == "digits" else "bits")
    lin = QLinear.create(ws[0] * 4, 4, out_bits=1, fmt=fmt)
    qw = quantize_np(ws[0] * 4, 4)
    assert lin.out_bits == 1
    h = lin(fx)
    np.testing.assert_array_equal(_levels(h), bitmm_np(qx, qw, 4, 4, 1))
    np.testing.assert_array_equal(lin.to_float(fx)[:N, :HIDDEN].numpy(), bitmm_np(qx, qw, 4, 4))
    agg = QAggregation(out_bits=1, tile_map=tm)
    np.testing.assert_array_equal(_levels(agg(fa, h)), bitmm_np(a, _levels(h), 1, 1, 1))
    np.testing.assert_array_equal(agg.to_float(fa, h)[:N, :HIDDEN].numpy(), bitmm_np(a, _levels(h), 1, 1))
    with pytest.raises(ValueError):
        QLinear.create(ws[0], 2, fmt="words")


def _levels(t):
    v = unpack_bits(t) if isinstance(t, BitTensor) else digit_unpack(t)
    return v.numpy()[:N, :HIDDEN]
