"""The plain reference against the port's plain CPU path, batch by batch,
and its independence from the program."""

import ast
from pathlib import Path

import pytest
import torch

from h100bench import run
from h100bench.reference import qgnn
from h100bench.tests.conftest import small


@pytest.mark.parametrize("cell_name", ["qgcn2.arxiv", "qgin2.arxiv"])
def test_reference_equals_the_ports_plain_path(cell_name, cache):
    cell = small(cell_name)
    dev = torch.device("cpu")
    data = run.inputs(cell, 2**31 + 5, dev)
    entry = run.make_entry(cell, data, dev)
    ref = dict(qgnn.batch_logits(data["indptr"], data["indices"], data["features"], data["float_weights"],
                                 cell["config"], entry.batches, dev))
    assert len(ref) == len(entry.batches) == 10
    classes = cell["traffic"]["classes"]
    for i, batch in enumerate(entry.batcher.batches):
        plain = entry.engine.forward_batch(batch, plain=True)[: batch.num_nodes, :classes]
        assert torch.equal(plain.double(), ref[i])
        assert ref[i].abs().sum() > 0


def test_requantize_rule():
    acc = torch.tensor([-3.0, 0.0, 1.0, 3.0, 4.0, 5.0, 900.0], dtype=torch.float64)
    assert qgnn.requantize(acc, 2).tolist() == [1.0, 0.0, 1.0, 3.0, 0.0, 3.0, 3.0]


def test_quantize_rule():
    x = torch.tensor([-0.2, 0.5, 1.5, 2.5, 3.6, 4.0, 4.2])
    assert qgnn.quantize(x, 2).tolist() == [1.0, 0.0, 2.0, 2.0, 0.0, 0.0, 3.0]


def test_reference_imports_neither_the_port_nor_jax():
    for path in (Path(qgnn.__file__).parent).glob("*.py"):
        tree = ast.parse(path.read_text())
        names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
        names |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
        assert {n.split(".")[0] for n in names} <= {"__future__", "typing", "numpy", "torch"}, path
