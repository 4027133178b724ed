"""What a run reads by name: the cell, its configuration and traffic mix, the
metrics ``BENCHMARK.json`` lists for it, and the modules those name.

* ``workloads/<cell>.json``: ``config``, ``traffic``, ``chips``, ``why``;
* ``configs/<config>.json``: the model as it is run, with ``entry`` (the
  module under ``entries/`` that drives the program), ``reference`` (the
  module under ``reference/``) and ``limits`` (each compared number's limit);
* ``traffic/<mix>.json``: the graph stand-in and how it is batched;
* ``metrics/<metric>.py``: a ``read(ctx)`` per metric, returning its value or
  None where it finds nothing to read.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def _name(name: str) -> str:
    if not NAME.fullmatch(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def _load_json(kind: str, name: str) -> dict:
    path = HERE / kind / f"{_name(name)}.json"
    if not path.exists():
        raise FileNotFoundError(f"no {kind[:-1]} {name!r} ({path.relative_to(ROOT)})")
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def cell(name: str) -> dict:
    """The cell with its configuration and traffic mix resolved."""
    w = _load_json("workloads", name)
    return dict(w, name=name, config=_load_json("configs", w["config"]), traffic=_load_json("traffic", w["traffic"]),
                config_name=w["config"], traffic_name=w["traffic"])


def metrics_for(bench: dict, cell_name: str, trace: bool) -> list:
    """The metric entries a run of ``cell_name`` reports: with ``trace`` the
    per-layer ones, else the end-to-end ones."""
    e2e = [m for m in bench["end_to_end"] if cell_name in m.get("workloads", [cell_name])]
    if not trace:
        return e2e
    moves = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m else m["moves"] in moves)]


def module(kind: str, name: str) -> ModuleType:
    """``<kind>/<name>.py`` of the harness, loaded by its path once a process."""
    path = HERE / kind / f"{_name(name)}.py"
    if not path.exists():
        raise FileNotFoundError(f"no {kind} module {name!r} ({path.relative_to(ROOT)})")
    qualname = f"h100bench.{kind}.{name.replace('.', '_').replace('-', '_')}"
    if qualname not in sys.modules:
        spec = importlib.util.spec_from_file_location(qualname, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[qualname] = mod
    return sys.modules[qualname]
