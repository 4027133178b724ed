"""The frozen generators give what the port's stand-ins give."""

import numpy as np
import pytest

from h100bench import graphs
from qgtc_ppopp22_tpu_torch.graph import synthesize
from qgtc_ppopp22_tpu_torch.graph.datasets import DATASET_STATS


@pytest.mark.parametrize("name, scale", [("ogbn-arxiv", 0.01), ("ogbn-products", 0.001)])
def test_graph_is_the_ports_stand_in(name, scale, tmp_path):
    n0, m0, dim, ncls = DATASET_STATS[name]
    n, m = max(64, int(n0 * scale)), max(4 * max(64, int(n0 * scale)), int(m0 * scale))
    traffic = {"dataset": name, "nodes": n, "edges": m, "graph_seed": 0}
    port = synthesize(name, scale=scale, seed=0)
    for _ in range(2):  # built, then read from the cache
        indptr, indices = graphs.graph(traffic, tmp_path)
        np.testing.assert_array_equal(indptr, port.graph.indptr)
        np.testing.assert_array_equal(indices, port.graph.indices)
    feats, labels = graphs.node_data(n, dim, ncls, 0)
    np.testing.assert_array_equal(feats, port.features)
    np.testing.assert_array_equal(labels, port.labels)


def test_features_follow_the_seed():
    a, _ = graphs.node_data(100, 8, 4, 2**31 + 17)
    b, _ = graphs.node_data(100, 8, 4, 2**31 + 17)
    c, _ = graphs.node_data(100, 8, 4, 2**31 + 18)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
