"""The port's native host library against the JAX package's.

The port carries a byte-for-byte copy of ``qgtc_native.cpp`` with its own
ctypes binding and build; these tests hold its partitioner, the default
(``auto``) partition and the default batcher to the JAX package's bytes,
the native densify / quantize / pack to the port's NumPy paths, and check
that two processes building the library at once both load a whole one.
Tolerance: exact equality throughout.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from qgtc_ppopp22_tpu import graph as jgraph
from qgtc_ppopp22_tpu import native as jnative
from qgtc_ppopp22_tpu_torch import graph, native
from qgtc_ppopp22_tpu_torch.graph import batching
from qgtc_ppopp22_tpu_torch.ops.bitpack import pack_bits_np

ROOT = Path(__file__).resolve().parents[1]

if not (native.available() and jnative.available()):
    pytest.skip("no C++ toolchain: the native library cannot be built", allow_module_level=True)


@pytest.fixture(scope="module")
def datasets():
    return (graph.synthesize("ogbn-arxiv", scale=0.01, seed=4),
            jgraph.synthesize("ogbn-arxiv", scale=0.01, seed=4))


def _j(planes):
    return np.asarray(planes).view(np.int32)


def test_source_is_the_jax_source():
    assert native.SRC.read_bytes() == (ROOT / "qgtc_ppopp22_tpu/native/qgtc_native.cpp").read_bytes()


@pytest.mark.parametrize("psize", [7, 24])
def test_partition_native_matches_jax(datasets, psize):
    ds, jds = datasets
    parts = graph.get_partition_list(ds.graph, psize, method="native")
    jparts = jgraph.get_partition_list(jds.graph, psize, method="native")
    assert len(parts) == len(jparts) == psize
    for p, q in zip(parts, jparts):
        np.testing.assert_array_equal(p, q)
    assert np.array_equal(np.sort(np.concatenate(parts)), np.arange(ds.num_nodes))


def test_auto_resolves_as_jax(datasets, tmp_path):
    ds, jds = datasets
    assert graph.partition.resolve_method("auto") == "native"
    parts = graph.get_partition_list(ds.graph, 12, cache_dir=str(tmp_path), cache_name="a")
    jparts = jgraph.get_partition_list(jds.graph, 12)
    for p, q in zip(parts, jparts):
        np.testing.assert_array_equal(p, q)
    assert [f.name for f in tmp_path.iterdir()][0].endswith("_12_native.npz")


@pytest.mark.parametrize("bit_width", [2, 8])
def test_batcher_defaults_match_jax(datasets, bit_width):
    ds, jds = datasets
    it = graph.ClusterBatcher(ds, 12, 3, bit_width=bit_width)
    jit = jgraph.ClusterBatcher(jds, 12, 3, bit_width=bit_width)
    assert it.partition_method == "native" and it.buckets() == jit.buckets() and len(it) == len(jit) == 4
    for b, jb in zip(it.batches, jit.batches):
        assert (b.num_nodes, b.padded_nodes, b.nbytes()) == (jb.num_nodes, jb.padded_nodes, jb.nbytes())
        np.testing.assert_array_equal(b.nodes, jb.nodes)
        np.testing.assert_array_equal(b.a_words.numpy(), jb.a_words)
        np.testing.assert_array_equal(b.bit_X.planes.numpy(), _j(jb.bit_X.planes))
        np.testing.assert_array_equal(b.bit_A.planes.numpy(), _j(jb.bit_A.planes))
        np.testing.assert_array_equal(b.tile_kidx.numpy(), jb.tile_kidx)
        np.testing.assert_array_equal(b.tile_kcnt.numpy(), jb.tile_kcnt)
    assert [list(b.nodes) for b in it] == [list(b.nodes) for b in jit]  # the epoch order


@pytest.mark.parametrize("kw", [dict(bit_width=2), dict(bit_width=8, quant_bits=3, feature_scale=4.0),
                                dict(bit_width=4, precalc=True, reorder="none")])
def test_native_paths_equal_numpy_paths(datasets, monkeypatch, kw):
    ds, _ = datasets
    fast = graph.ClusterBatcher(ds, 12, 3, partition_method="bfs", **kw)
    native_bit_a = fast.batches[0].bit_A.planes.numpy()
    monkeypatch.setattr(batching, "_native_or_none", lambda: None)
    slow = graph.ClusterBatcher(ds, 12, 3, partition_method="bfs", **kw)
    assert fast._native is native and slow._native is None
    for b, s in zip(fast.batches, slow.batches):
        np.testing.assert_array_equal(b.nodes, s.nodes)
        np.testing.assert_array_equal(b.a_words.numpy(), s.a_words.numpy())
        np.testing.assert_array_equal(b.bit_X.planes.numpy(), s.bit_X.planes.numpy())
    np.testing.assert_array_equal(native_bit_a, slow.batches[0].bit_A.planes.numpy())


def test_native_false_keeps_numpy_paths(datasets, monkeypatch):
    """``native=False`` builds the same bytes through the NumPy paths,
    which a host without g++ takes too."""
    ds, _ = datasets
    fast = graph.ClusterBatcher(ds, 12, 3, bit_width=4, partition_method="bfs")
    called = []
    monkeypatch.setattr(native, "subgraph_dense_native", lambda *a: called.append(a))
    slow = graph.ClusterBatcher(ds, 12, 3, bit_width=4, partition_method="bfs", native=False)
    assert fast._native is native and slow._native is None and not called
    for b, s in zip(fast.batches, slow.batches):
        np.testing.assert_array_equal(b.nodes, s.nodes)
        np.testing.assert_array_equal(b.a_words.numpy(), s.a_words.numpy())
        np.testing.assert_array_equal(b.bit_X.planes.numpy(), s.bit_X.planes.numpy())
        np.testing.assert_array_equal(b.tile_kidx.numpy(), s.tile_kidx.numpy())


def test_native_functions_match_numpy(datasets):
    ds, _ = datasets
    rng = np.random.default_rng(2)
    src, dst = rng.integers(0, 300, 2000), rng.integers(0, 300, 2000)
    ref = graph.from_edges(src, dst, 300)
    indptr, indices = native.csr_from_edges_native(src, dst, 300)
    np.testing.assert_array_equal(indptr, ref.indptr)
    np.testing.assert_array_equal(indices, ref.indices)
    nodes = np.sort(rng.choice(ds.num_nodes, 200, replace=False))
    want = np.zeros((256, 256), np.uint8)
    want[:200, :200] = ds.graph.subgraph_dense(nodes)
    np.testing.assert_array_equal(native.subgraph_dense_native(ds.graph.indptr, ds.graph.indices, nodes, 256),
                                  want)
    x = (rng.standard_normal((300, 70)) * 3 + 1).astype(np.float32)
    for bits in (1, 2, 4, 8):
        q = native.quantize_native(x, bits)
        np.testing.assert_array_equal(q, batching.quantize_np(x, bits))
        np.testing.assert_array_equal(native.pack_bits_u32_2d(q, bits, 512, 256).view(np.int32),
                                      pack_bits_np(q, bits).planes.numpy())


def test_concurrent_first_build(tmp_path):
    """Two processes that build the library into one path at once each load
    a whole library and leave no temporary file behind."""
    lib = tmp_path / "libqgtc_native.so"
    code = textwrap.dedent(f"""
        import sys
        from pathlib import Path
        sys.path.insert(0, {str(ROOT)!r})
        import numpy as np
        from qgtc_ppopp22_tpu_torch import native
        path = Path({str(lib)!r})
        native.build(path)
        native._lib = native.load(path)
        x = np.array([-1.0, 0.4, 2.5, 3.5, 9.0], np.float32)
        print(native.quantize_native(x, 2).tolist())
    """)
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == "[1, 0, 2, 4, 3]"
    assert [f.name for f in tmp_path.iterdir()] == [lib.name]
