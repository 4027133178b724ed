"""Small cells for the harness's CPU tests: the arxiv stand-in at a
hundredth of its nodes and edges, 10 batches of ~170 nodes (one 512 bucket),
every cache in a test's own directory."""

import pytest
import torch

from h100bench import run, spec


def small(cell_name: str, **traffic) -> dict:
    cell = spec.cell(cell_name)
    cell["traffic"] = dict(cell["traffic"], nodes=1693, edges=11662, psize=40, batch_size=4, **traffic)
    return cell


@pytest.fixture
def cache(tmp_path, monkeypatch):
    monkeypatch.setattr(run, "CACHE", tmp_path)
    return tmp_path


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 has no interpret mode")
    return torch.device("cuda:0")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
