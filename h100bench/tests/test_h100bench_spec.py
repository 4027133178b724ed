"""Every name BENCHMARK.json and the harness's files use resolves, and
BENCHMARK.json keeps to the contract's shape."""

import json
import re

import pytest

from h100bench import spec

BENCH = spec.benchmark()
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


@pytest.mark.parametrize("path", sorted((spec.HERE / "workloads").glob("*.json")), ids=lambda p: p.stem)
def test_every_workload_file_resolves(path):
    cell = spec.cell(path.stem)
    assert cell["chips"] in (1, 4)
    for key in ("model", "hidden", "num_layers", "bit_width", "entry", "reference", "limits"):
        assert key in cell["config"]
    for key in ("dataset", "nodes", "edges", "features", "classes", "graph_seed", "psize", "batch_size",
                "shuffle_seed", "partition"):
        assert key in cell["traffic"]
    assert (spec.HERE / "entries" / f"{cell['config']['entry']}.py").exists()
    assert (spec.HERE / "reference" / f"{cell['config']['reference']}.py").exists()


def test_benchmark_cells_are_the_workload_files():
    for w in BENCH["workloads"]:
        f = json.loads((spec.HERE / "workloads" / f"{w['name']}.json").read_text())
        assert {k: w[k] for k in ("config", "traffic", "chips", "why")} == f
    names = {c["name"] for c in BENCH["configs"]}
    assert names == {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        cfg = json.loads((spec.ROOT / c["file"]).read_text())
        assert c["source"] == cfg["source"]
        assert all(k in cfg for k in c["reduced"])


def test_every_metric_has_a_reader():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        mod = spec.module("metrics", m["name"])
        assert callable(mod.read)
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m["workloads"]) <= cells
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.fullmatch(n) for n in names)
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("bad", ["../x", "a/b", "", ".hidden", "x" * 65])
def test_names_outside_the_rule_are_refused(bad):
    with pytest.raises(ValueError):
        spec.cell(bad)


def test_metrics_for_a_cell():
    bench = {"end_to_end": [{"name": "a"}, {"name": "b", "workloads": ["other"]}],
             "per_layer": [{"name": "x", "moves": "a"}, {"name": "y", "moves": "b"},
                           {"name": "z", "moves": "a", "workloads": ["other"]}]}
    assert [m["name"] for m in spec.metrics_for(bench, "c", False)] == ["a"]
    assert [m["name"] for m in spec.metrics_for(bench, "c", True)] == ["x"]
