"""The fused engines' CLI flags and the port's bench script, on the CPU.

``cli.main`` with the fused, quant-in-loop, timing-split and mega flags
on a toy graph (each run's JSON record), the combinations the CLI refuses,
and ``bench.bench`` in each mode on the Proteins stand-in (scale 0.02) at
a small scale: one record a call, its fields and its ratio to the
baseline. Split from ``test_torch_fused.py``, whose engines these drive.
"""

import json

import numpy as np
import pytest

from qgtc_ppopp22_tpu_torch import bench, cli, graph
from torch_threads import one_thread  # noqa: F401  (an autouse fixture: one torch thread)

_KW = dict(seed=5, bucket_rows=256, partition_method="bfs")


@pytest.fixture(scope="module")
def proteins():
    """The Proteins stand-in the fused tests batch (scale 0.02, seed 5)."""
    return graph.synthesize("Proteins", scale=0.02, seed=5)


def _toy_npz(path):
    rng = np.random.default_rng(0)
    np.savez(path / "toy.npz", src_li=rng.integers(0, 600, 3000), dst_li=rng.integers(0, 600, 3000))


@pytest.mark.parametrize("flags,engine", [
    (["--mode", "fused"], "qgtc-fused"),
    (["--mode", "fused", "--zerotile_jump", "--sync-every-epoch"], "qgtc-fused"),
    (["--quant-in-loop", "--timing-split"], "qgtc-quant-in-loop"),
    (["--timing-split"], "qgtc-step"),
    (["--mode", "mega", "--timing-split", "--sync-every-epoch"], "qgtc-mega"),
    (["--regular", "--mode", "fused", "--sync-every-epoch"], "regular-fused"),
])
def test_cli_fused_modes_and_timing(tmp_path, monkeypatch, capsys, flags, engine):
    _toy_npz(tmp_path)
    monkeypatch.chdir(tmp_path)
    rc = cli.main(["--dataset", "toy", "--data-dir", str(tmp_path), "--psize", "4", "--batch-size", "2",
                   "--n-epochs", "2", "--device", "cpu", *flags])
    assert rc == 0
    out = capsys.readouterr().out
    record = json.loads(out.strip().splitlines()[-1])
    sync = "--sync-every-epoch" in flags
    assert record["engine"] == engine and record["avg_epoch_ms"] > 0 and record["sync_every_epoch"] == sync
    assert len(record["epoch_ms"]) == (2 if sync else 1)
    assert (record["launch_sync_ms"] == 0) == sync
    if "--timing-split" in flags:
        assert record["transfer_ms"] >= 0 and record["compute_ms"] > 0
        assert f"timing split ({engine.split('-', 1)[1]}): transfer" in out


@pytest.mark.parametrize("argv,msg", [
    (["--regular", "--quant-in-loop"], "--quant-in-loop is the quantized engine's option"),
    (["--regular", "--timing-split"], "--timing-split is the quantized engine's option"),
    (["--quant-in-loop", "--fmt", "bits"], "quant-in-loop mode requires fmt='digits'"),
    (["--mode", "fused", "--fmt", "bits"], "fused mode requires fmt='digits'"),
    (["--quant-in-loop", "--resident"], "--resident"),
])
def test_cli_refuses_fused_combinations(capsys, argv, msg):
    with pytest.raises(SystemExit) as exc:
        cli.main(argv)
    assert exc.value.code == 2 and msg in capsys.readouterr().err


@pytest.mark.parametrize("mode", ["mega", "fused", "step"])
def test_bench_prints_one_record(proteins, capsys, mode):
    ds = proteins
    batcher = graph.ClusterBatcher(ds, 4, 2, bit_width=2, **_KW)
    rec = bench.bench(batcher, "cpu", mode, n_epochs=2, repeats=3)
    (line,) = capsys.readouterr().out.strip().splitlines()
    assert json.loads(line) == rec
    assert rec["metric"] == bench.METRIC and rec["unit"] == "ms" and rec["value"] > 0
    assert rec["vs_baseline"] == pytest.approx(bench.BASELINE_MS / rec["value"])
    d = rec["detail"]
    assert len(d["epoch_ms"]) == len(d["launch_sync_ms"]) == 3 and d["median_ms"] == rec["value"]
    assert d["spread_ms"] == max(d["epoch_ms"]) - min(d["epoch_ms"]) and d["transfer_inclusive_ms"] > 0
    assert d["mode"] == mode and d["card"] == "cpu" and "PCIe" in d["transfer_note"]
    assert d["partition_method"] == batcher.partition_method
    assert "tunnel" not in line


def test_bench_refuses_an_unknown_mode(proteins):
    ds = proteins
    with pytest.raises(ValueError, match="unknown mode"):
        bench.bench(graph.ClusterBatcher(ds, 4, 2, bit_width=2, **_KW), "cpu", "step-fallback")
