"""Multi-device execution on a (dp, sp) mesh: the counterpart of
``qgtc_ppopp22_tpu/parallel/``, with its names."""

from qgtc_ppopp22_tpu_torch.parallel.sharded import (
    Mesh,
    Sharded,
    dp_sp_epoch_step,
    make_mesh,
    shard_batches,
    sp_gcn_forward,
    sp_gcn_forward_ring,
    sp_gin_forward,
    sp_gin_forward_ring,
)
from qgtc_ppopp22_tpu_torch.parallel.multihost import (
    host_batch_slice,
    initialize,
    pod_mesh,
    process_allgather,
)
from qgtc_ppopp22_tpu_torch.parallel.packed import (
    dp_mega_epoch_packed,
    dp_sp_epoch_packed,
    shard_packed_batches,
)
from qgtc_ppopp22_tpu_torch.parallel.engine import MeshEngine, x_digits_np
