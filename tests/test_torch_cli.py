"""The port's CLI flags against the JAX package's CLI.

``--sparse``, ``--use-pp``, ``--json-out``, ``--profile-dir``,
``--bucket-rows`` and ``--cache-dir`` on a small synthetic dataset: the
port's record carries every key of the JAX record for the same command
line, with the same dataset, sizes and buckets, and names the partition
method that ran; ``--sparse`` warns about the same flags as JAX's;
``--json-out`` appends the printed record; no flag is refused as not yet
ported (``--mesh`` runs).
"""

import json

import numpy as np
import pytest

from qgtc_ppopp22_tpu import cli as jcli
from qgtc_ppopp22_tpu_torch import cli
from torch_threads import one_thread  # noqa: F401  (an autouse fixture: one torch thread)

SHARED = ("dataset", "bit_width", "psize", "batch_size", "n_epochs", "zerotile_jump", "resident", "mode",
          "mesh")


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    d = tmp_path_factory.mktemp("toy")
    rng = np.random.default_rng(0)
    np.savez(d / "toy.npz", src_li=rng.integers(0, 600, 3000), dst_li=rng.integers(0, 600, 3000))
    return d


def _run(main, argv, capsys):
    assert main(argv) == 0
    cap = capsys.readouterr()
    return json.loads(cap.out.strip().splitlines()[-1]), cap


@pytest.mark.parametrize("flags", [
    ["--use-pp"],
    ["--bucket-rows", "256", "--mode", "mega"],
    ["--regular", "--use-pp", "--mode", "mega"],
    ["--sparse", "--eval-accuracy", "--run_GIN"],
])
def test_record_has_the_jax_keys(toy, tmp_path, monkeypatch, capsys, flags):
    monkeypatch.chdir(tmp_path)
    argv = ["--dataset", "toy", "--data-dir", str(toy), "--psize", "4", "--batch-size", "2", "--n-epochs", "1",
            "--cache-dir", str(tmp_path / "cache"), *flags]
    want, jcap = _run(jcli.main, argv, capsys)
    got, cap = _run(cli.main, [*argv, "--device", "cpu"], capsys)
    assert set(want) <= set(got), set(want) - set(got)
    for k in SHARED:
        assert got.get(k) == want.get(k), k
    if "--sparse" in flags:
        assert got["engine"] == want["engine"] == "sparse-full-graph" and "partition_method" not in got
        assert 0.0 <= got["accuracy"] <= 1.0
        return
    assert got["partition_method"] == "native"
    assert got["use_pp"] == ("--use-pp" in flags) and got["bucket_rows"] == (256 if "256" in flags else 512)
    assert "shape buckets " + cap.out.split("shape buckets ")[1].split("\n")[0] in jcap.out
    assert sorted(p.name for p in (tmp_path / "cache").iterdir()) == ["toy_n600_e5959_4_native.npz"]


def test_sparse_warns_as_jax(toy, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    argv = ["--dataset", "toy", "--data-dir", str(toy), "--n-epochs", "1", "--sparse", "--zerotile_jump",
            "--use-pp", "--resident", "--mode", "fused"]
    _, jcap = _run(jcli.main, argv, capsys)
    _, cap = _run(cli.main, [*argv, "--device", "cpu"], capsys)
    warned = [line for line in cap.err.splitlines() if "has no effect with --sparse" in line]
    assert warned == [line for line in jcap.err.splitlines() if "has no effect with --sparse" in line]
    assert len(warned) == 4


def test_json_out_and_profile_dir(toy, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "records.jsonl"
    argv = ["--dataset", "toy", "--data-dir", str(toy), "--psize", "4", "--batch-size", "2", "--n-epochs", "1",
            "--device", "cpu", "--json-out", str(out)]
    first, _ = _run(cli.main, [*argv, "--profile-dir", str(tmp_path / "prof")], capsys)
    second, _ = _run(cli.main, [*argv, "--sparse"], capsys)
    assert [json.loads(line) for line in out.read_text().splitlines()] == [first, second]
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]


def test_only_weights_and_mesh_not_ported(capsys):
    """No flag of the JAX CLI is refused any more: ``--weights``
    (``tests/test_torch_train.py``) and ``--mesh`` are offered, and
    ``--mesh`` runs (``tests/test_torch_parallel.py`` checks its record)."""
    assert cli.NOT_PORTED == ()
    help_text = cli.build_parser().format_help()
    assert "--weights" in help_text and "--mesh DP,SP" in help_text
    rc = cli.main(["--dataset", "ppi", "--dataset-scale", "0.01", "--psize", "4", "--batch-size", "2",
                   "--n-epochs", "1", "--device", "cpu", "--mesh", "2,1"])
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and record["engine"] == "qgtc-mesh-dp2-sp1" and record["mesh"] == "2,1"
