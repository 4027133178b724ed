"""Multi-process bring-up: dp across processes, sp inside each one.

Counterpart of ``qgtc_ppopp22_tpu/parallel/multihost.py``. The JAX
package spans hosts with ``jax.distributed``: ``dp`` crosses hosts
(cluster batches are independent), ``sp`` stays on one host's chips. This
package does the same over ``torch.distributed``:

1. every process runs the same program and calls :func:`initialize`
   first (``tcp://`` rendezvous at a given address, or ``env://`` as
   ``torchrun`` sets it);
2. :func:`pod_mesh` builds the process's own (dp, sp) mesh of its local
   devices; the global dp is the process count times its dp;
3. the mesh engine stages only :func:`host_batch_slice`'s share of every
   bucket (``parallel/engine.MeshEngine.stage``), runs it, and
   :func:`process_allgather` joins the processes' outputs.

No tensor crosses processes on the data path: the process group is a
control plane (bring-up, barrier, the final gather of host arrays), so
its backend is ``gloo`` on the CPU and on the card alike, and two
processes can share one GPU (NCCL would refuse that).

Scaling expectation, an arithmetic model and not a measurement: dp over
processes moves nothing at steady state, so an epoch is bounded by the
batch count's imbalance (75 batches over N processes): at 2 processes
``ceil(75 / 2) / 75 * 2`` = 98.7% efficiency at best.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from qgtc_ppopp22_tpu_torch.parallel.sharded import Mesh, make_mesh


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: str = "gloo",
) -> None:
    """``torch.distributed.init_process_group``; a no-op for one process.

    ``coordinator_address`` is ``host:port`` (or an ``init_method`` URL);
    without one the rendezvous is ``env://`` (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, as ``torchrun`` sets them)."""
    if num_processes is not None and num_processes <= 1:
        return
    if coordinator_address is None:
        method = "env://"
    elif "://" in coordinator_address:
        method = coordinator_address
    else:
        method = f"tcp://{coordinator_address}"
    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    dist.init_process_group(backend, init_method=method, **kwargs)


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def pod_mesh(sp_per_host: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """This process's (dp, sp) mesh over its local devices (``devices``, else
    every visible GPU). ``sp`` defaults to the local device count, halved
    until it divides it, so the ring stays inside the process; ``dp`` takes
    the rest, and spans processes (the global dp is ``process_count()``
    times it)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("pod_mesh over CUDA devices requested but CUDA is not available")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    n = len(devices)
    sp = sp_per_host or n
    while n % sp:
        sp //= 2
    sp = max(sp, 1)
    return make_mesh(dp=n // sp, sp=sp, devices=devices)


def host_batch_slice(n_batches: int) -> slice:
    """This process's share of the epoch's cluster batches: contiguous
    ``ceil(n / processes)`` batches each, as JAX's."""
    p, n_p = process_index(), process_count()
    per = -(-n_batches // n_p)
    return slice(p * per, min((p + 1) * per, n_batches))


def process_allgather(t: torch.Tensor) -> torch.Tensor:
    """Every process's ``t`` (the same shape in each), joined along axis 0
    in process order, on the CPU (JAX ``multihost_utils.process_allgather(x,
    tiled=True)``); ``t`` itself for one process. A failed gather raises."""
    t = t.detach().cpu().contiguous()
    if process_count() == 1:
        return t
    out = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(out, t)
    return torch.cat(out, dim=0)


def barrier() -> None:
    if process_count() > 1:
        dist.barrier()
