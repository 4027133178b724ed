"""Host-layer parity: the port's graph modules against the JAX package's.

The port carries its own copy of the NumPy host layer (the JAX package
imports jax on import); these tests hold it to the same bytes.
"""

import numpy as np
import pytest

from qgtc_ppopp22_tpu import graph as jgraph
from qgtc_ppopp22_tpu_torch import graph
from qgtc_ppopp22_tpu_torch.graph import partition


@pytest.fixture(scope="module")
def datasets():
    return (
        graph.synthesize("Proteins", scale=0.02, seed=5),
        jgraph.synthesize("Proteins", scale=0.02, seed=5),
    )


def _j(planes):
    a = np.asarray(planes)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def test_synthesize_matches_jax(datasets):
    ds, jds = datasets
    assert ds.num_nodes == jds.num_nodes and ds.num_classes == jds.num_classes
    np.testing.assert_array_equal(ds.graph.indptr, jds.graph.indptr)
    np.testing.assert_array_equal(ds.graph.indices, jds.graph.indices)
    np.testing.assert_array_equal(ds.features, jds.features)
    np.testing.assert_array_equal(ds.labels, jds.labels)
    np.testing.assert_array_equal(ds.train_mask, jds.train_mask)


def test_synthesize_ppi_multilabels_match_jax():
    ds = graph.synthesize("ppi", scale=0.01, seed=2)
    jds = jgraph.synthesize("ppi", scale=0.01, seed=2)
    np.testing.assert_array_equal(ds.multilabels, jds.multilabels)
    np.testing.assert_array_equal(ds.features, jds.features)


def test_dataset_stats_match_jax():
    assert graph.DATASET_STATS == jgraph.DATASET_STATS
    assert graph.DATASET_STATS["ogbn-arxiv"] == (169_343, 1_166_243, 128, 40)


def test_load_npz_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    src, dst = rng.integers(0, 300, 900), rng.integers(0, 300, 900)
    np.savez(tmp_path / "toy.npz", src_li=src, dst_li=dst)
    ds = graph.load_dataset("toy", data_dir=str(tmp_path))
    jds = jgraph.load_dataset("toy", data_dir=str(tmp_path))
    np.testing.assert_array_equal(ds.graph.indices, jds.graph.indices)
    np.testing.assert_array_equal(ds.features, jds.features)
    assert ds.name == "toy" and ds.feat_dim == 128


def test_subgraph_dense_matches_jax(datasets):
    ds, jds = datasets
    nodes = np.sort(np.random.default_rng(1).choice(ds.num_nodes, 200, replace=False))
    np.testing.assert_array_equal(ds.graph.subgraph_dense(nodes), jds.graph.subgraph_dense(nodes))


@pytest.mark.parametrize("method", ["bfs", "rcm"])
def test_partition_matches_jax(datasets, method):
    ds, jds = datasets
    parts = graph.get_partition_list(ds.graph, 12, method=method)
    jparts = jgraph.get_partition_list(jds.graph, 12, method=method)
    assert len(parts) == len(jparts) == 12
    for p, q in zip(parts, jparts):
        np.testing.assert_array_equal(p, q)
    assert graph.edge_cut_fraction(ds.graph, parts) == jgraph.edge_cut_fraction(jds.graph, jparts)


def test_partition_auto_is_bfs_and_cached(datasets, tmp_path):
    """``auto`` resolves as JAX's does (native when the library builds,
    else bfs), the cache file is keyed by the resolved method and read back,
    and ``method='native'`` equals JAX's."""
    from qgtc_ppopp22_tpu import native as jnative

    ds, jds = datasets
    resolved = partition.resolve_method("auto")
    assert resolved == ("native" if jnative.available() else "bfs")
    parts = graph.get_partition_list(ds.graph, 6, cache_dir=str(tmp_path), cache_name="p")
    files = list(tmp_path.iterdir())
    assert len(files) == 1 and files[0].name.endswith(f"_6_{resolved}.npz")
    again = partition.get_partition_list(ds.graph, 6, cache_dir=str(tmp_path), cache_name="p")
    for p, q, r in zip(parts, again, jgraph.get_partition_list(jds.graph, 6, method="auto")):
        np.testing.assert_array_equal(p, q)
        np.testing.assert_array_equal(p, r)
    if jnative.available():
        for p, q in zip(graph.get_partition_list(ds.graph, 6, method="native"),
                        jgraph.get_partition_list(jds.graph, 6, method="native")):
            np.testing.assert_array_equal(p, q)
    with pytest.raises(ValueError):
        graph.get_partition_list(ds.graph, 6, method="metis")


@pytest.mark.parametrize("bit_width", [1, 2, 8])
def test_cluster_batcher_matches_jax(datasets, bit_width):
    ds, jds = datasets
    kw = dict(bit_width=bit_width, seed=5, bucket_rows=256, partition_method="bfs")
    it = graph.ClusterBatcher(ds, 8, 2, **kw)
    jit = jgraph.ClusterBatcher(jds, 8, 2, **kw)
    assert len(it) == len(jit) == 4 and it.buckets() == jit.buckets()
    for b, jb in zip(it.batches, jit.batches):
        assert (b.num_nodes, b.padded_nodes) == (jb.num_nodes, jb.padded_nodes)
        np.testing.assert_array_equal(b.nodes, jb.nodes)
        np.testing.assert_array_equal(b.a_words.numpy(), jb.a_words)
        np.testing.assert_array_equal(b.bit_X.planes.numpy(), _j(jb.bit_X.planes))
        assert b.bit_X.shape == jb.bit_X.shape and b.bit_X.bits == jb.bit_X.bits
        np.testing.assert_array_equal(b.tile_kidx.numpy(), jb.tile_kidx)
        np.testing.assert_array_equal(b.tile_kcnt.numpy(), jb.tile_kcnt)
        lab, mask = graph.batch_labels(ds, b)
        jlab, jmask = jgraph.batch_labels(jds, jb)
        np.testing.assert_array_equal(lab, jlab)
        np.testing.assert_array_equal(mask, jmask)
    # the same seed gives the same epoch order
    assert [b.nodes.tolist() for b in it] == [b.nodes.tolist() for b in jit]
