"""Multi-process execution of the PyTorch port (``parallel/multihost.py``),
the counterpart of JAX's ``test_multihost_helpers_single_process`` and
``test_two_process_distributed_forward``: the helpers in one process, then
one real two-process ``gloo`` run on the CPU, where each process's gathered
logits must equal the single-process engine's exactly.
"""

import os
import socket
import subprocess
import sys

import pytest
import torch

from qgtc_ppopp22_tpu_torch.parallel import host_batch_slice, initialize, pod_mesh, process_allgather
from qgtc_ppopp22_tpu_torch.parallel.multihost import process_count, process_index

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_multihost_helpers_single_process():
    """``initialize(num_processes=1)`` is a no-op, ``pod_mesh`` spans the
    local devices, one process takes every batch, a gather returns its
    input."""
    initialize(num_processes=1)
    assert not torch.distributed.is_initialized()
    assert (process_count(), process_index()) == (1, 0)
    mesh = pod_mesh(devices=["cpu"] * 8)
    assert mesh.shape == {"dp": 1, "sp": 8}
    mesh = pod_mesh(sp_per_host=3, devices=["cpu"] * 8)  # halved until it divides the local count
    assert mesh.shape == {"dp": 8, "sp": 1} and mesh.shape["dp"] * mesh.shape["sp"] == 8
    assert pod_mesh(sp_per_host=2, devices=["cpu"] * 8).shape == {"dp": 4, "sp": 2}
    assert host_batch_slice(75) == slice(0, 75)
    t = torch.arange(6).reshape(2, 3)
    assert torch.equal(process_allgather(t), t)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pod_mesh()


def test_two_process_gloo_run():
    """Two processes of ``parallel/multihost_worker.py`` on the CPU: the dense
    step over their shares of 8 batches on a (2, 2) mesh each, and the packed
    ``MeshEngine`` over their shares of each bucket (padded to dp 2 times 2
    processes) at (dp 2, sp 1), every bucket K1 (``mega``), and at (dp 2, sp
    2), the ring; every process's gathered logits equal to the
    single-process forward / engine (MULTIHOST-OK, MESH-EPOCH-OK)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-m", "qgtc_ppopp22_tpu_torch.parallel.multihost_worker", str(r), "2",
                               str(port), "--device", "cpu", "--epochs", "2"],
                              cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        finally:
            p.kill()
        outs.append(out)
        assert p.returncode == 0, out[-3000:]
    for r, out in enumerate(outs):
        assert f"p{r}: MULTIHOST-OK out=(8, 1024, 128)" in out, out[-3000:]
        assert f"p{r}: MESH-EPOCH-OK dp=2 sp=1 modes=['mega', 'mega']" in out, out[-3000:]
        assert f"p{r}: MESH-EPOCH-OK dp=2 sp=2 modes=['ring', 'ring']" in out, out[-3000:]
        for sp in (1, 2):
            assert f"p{r}: EPOCH-WALL dp=2 sp={sp} " in out and "nproc=2" in out
