"""The check catches what it must: the control (the program one bit below
the configuration) and the timed path broken underneath in each way a cell
can break: a launch that leaves its output unwritten, half of a bucket's
batches left out, one answer altered where it is produced. A cell on one
chip has no exchange between chips to leave out. The look for the chip is
skipped; the rest of a run is driven on the CPU's plain versions."""

import pytest
import torch

from h100bench import control, run, spec
from h100bench.tests.conftest import small
from qgtc_ppopp22_tpu_torch.ops import fused_model

REAL = fused_model.fused_model_epoch


def unwritten(*a, **k):
    out = REAL(*a, **k)
    return torch.zeros_like(out)


def half_left_out(*a, **k):
    out = REAL(*a, **k)
    out[out.shape[0] // 2:] = 0
    return out


def altered(*a, **k):
    out = REAL(*a, **k)
    out[0, 0, 0] += 1
    return out


@pytest.mark.parametrize("cell_name", ["qgcn2.arxiv", "qgin2.arxiv"])
def test_a_sound_run_is_correct(cell_name, cache):
    res = run.run_cell(small(cell_name), 2**31 + 99, 0.2, False, torch.device("cpu"), spec.benchmark())
    assert res["correct"] is True
    assert list(res)[-1] == "checks"
    assert res["checks"]["wrong_logits"] == {"value": 0, "limit": 0}
    assert set(res["metrics"]) == {"epoch_ms", "epoch_p95_ms", "setup_s"}
    assert res["attempted"] >= 1


@pytest.mark.parametrize("fault", [unwritten, half_left_out, altered], ids=lambda f: f.__name__)
def test_a_broken_path_is_not_correct(fault, cache, monkeypatch):
    monkeypatch.setattr(fused_model, "fused_model_epoch", fault)
    res = run.run_cell(small("qgcn2.arxiv"), 11, 0.2, False, torch.device("cpu"), spec.benchmark())
    assert res["correct"] is False
    assert res["checks"]["wrong_logits"]["value"] > 0


def test_a_batch_dropped_from_the_partition_is_not_correct(cache, monkeypatch):
    from h100bench.entries import qgtc_mega

    init = qgtc_mega.Entry.__init__

    def drop_last(self, *a, **k):
        init(self, *a, **k)
        self.batches = self.batches[:-1]
        self.buckets[-1]["index"] = self.buckets[-1]["index"][:-1]

    monkeypatch.setattr(qgtc_mega.Entry, "__init__", drop_last)
    res = run.run_cell(small("qgcn2.arxiv"), 12, 0.2, False, torch.device("cpu"), spec.benchmark())
    assert res["correct"] is False


@pytest.mark.parametrize("cell_name", ["qgcn2.arxiv", "qgin2.arxiv"])
def test_the_control_is_not_correct(cell_name, cache):
    r = control.readings(small(cell_name), 21, 0.1, torch.device("cpu"))
    assert r["sound"] == {"wrong_logits": 0, "max_logit_gap": 0.0}
    assert r["control"]["wrong_logits"] > 0 and r["control"]["max_logit_gap"] > 0


def test_the_control_on_the_card(cache, cuda):
    """The same control on the card, at the test's size."""
    r = control.readings(small("qgcn2.arxiv"), 22, 0.2, cuda)
    assert r["sound"] == {"wrong_logits": 0, "max_logit_gap": 0.0}
    assert r["control"]["wrong_logits"] > 0
