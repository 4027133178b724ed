"""A run loads no module of JAX or of the JAX package, compared by whole
top-level names."""

import json
import subprocess
import sys

from h100bench import run
from h100bench.tests.conftest import small  # noqa: F401  (the child imports it)

CHILD = """
import json, sys, tempfile, torch
from pathlib import Path
from h100bench import run, spec
from h100bench.tests.conftest import small
run.CACHE = Path(tempfile.mkdtemp())
res = run.run_cell(small("qgcn2.arxiv"), 3, 0.2, False, torch.device("cpu"), spec.benchmark())
print(json.dumps({"correct": res["correct"], "bad": sorted(run.loaded_forbidden()),
                  "port": "qgtc_ppopp22_tpu_torch" in sys.modules}))
"""


def test_a_run_loads_no_jax(tmp_path):
    out = subprocess.run([sys.executable, "-c", CHILD], capture_output=True, text=True, timeout=300,
                         cwd=run.HERE.parent, env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
                                                   "TMPDIR": str(tmp_path)})
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"correct": True, "bad": [], "port": True}


def test_names_are_compared_whole(monkeypatch):
    before = run.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "qgtc_ppopp22_tpu_torch_fake", sys)
    monkeypatch.setitem(sys.modules, "jaxlike.sub", sys)
    assert run.loaded_forbidden() == before
    monkeypatch.setitem(sys.modules, "qgtc_ppopp22_tpu.runtime", sys)
    assert "qgtc_ppopp22_tpu" in run.loaded_forbidden()
