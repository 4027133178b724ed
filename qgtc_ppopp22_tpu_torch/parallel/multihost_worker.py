"""One process of a multi-process mesh run (counterpart of the JAX
repository's two-process worker)::

    python -m qgtc_ppopp22_tpu_torch.parallel.multihost_worker RANK NPROC PORT \
        [--device cuda:0|cpu] [--epochs N]

Every process of the run starts it with its rank, the process count and a
free ``localhost`` port. Each process:

1. joins the ``gloo`` process group (``parallel/multihost.initialize``);
2. runs the dense digit-plane step (``dp_sp_epoch_step``, 2 copies of a
   random 1024-node batch per dp row) on its share of the batches over a
   (2, 2) mesh of ``--device`` repeated, gathers every process's logits
   (``process_allgather``) and checks each against the single-device
   ``qgcn_forward``: ``p{rank}: MULTIHOST-OK``;
3. for each of its meshes, (dp 2, sp 1), where every dp row runs K1 on its
   share as JAX's worker's dp-only mesh does, and (dp 2, sp 2), the ring:
   stages its ``host_batch_slice`` share of every bucket of a synthetic
   Proteins stand-in (scale 0.05, psize 8, batch 2) into a ``MeshEngine``,
   runs ``--epochs`` epochs, gathers every bucket and checks each batch's
   logits against the single-process ``QGTCEngine`` bit for bit, every
   bucket's mode (``mega`` at sp 1, ``ring`` at sp 2) and, on a GPU, that
   the mesh's kernels launched: ``p{rank}: MESH-EPOCH-OK dp=2 sp=1
   modes=[...] launches={...}``;
4. times ``--epochs`` more epochs of its share of each mesh: ``p{rank}:
   EPOCH-WALL dp=2 sp=1 ms=... local_batches=... nproc=...``.

Any mismatch exits non-zero. Every process may use the same GPU: the
process group carries only the gathers.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

# Each process's meshes (dp rows, sp): K1 a dp row, then the ring.
MESHES = ((2, 1), (2, 2))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("rank", type=int)
    p.add_argument("nproc", type=int)
    p.add_argument("port", type=int)
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--epochs", type=int, default=3)
    args = p.parse_args(argv)

    from qgtc_ppopp22_tpu_torch.graph import ClusterBatcher, synthesize
    from qgtc_ppopp22_tpu_torch.models.qmodels import qgcn_forward
    from qgtc_ppopp22_tpu_torch.ops import digitmm, fused_model, packmm
    from qgtc_ppopp22_tpu_torch.ops.digits import digit_pack
    from qgtc_ppopp22_tpu_torch.ops.packmm import pack_rows
    from qgtc_ppopp22_tpu_torch.parallel import MeshEngine, dp_sp_epoch_step, host_batch_slice, initialize, pod_mesh
    from qgtc_ppopp22_tpu_torch.parallel.multihost import barrier, process_allgather
    from qgtc_ppopp22_tpu_torch.runtime import QGTCEngine

    pid, dev = args.rank, torch.device(args.device)
    initialize(f"localhost:{args.port}", args.nproc, pid)
    mesh = pod_mesh(sp_per_host=2, devices=[dev] * 4)
    print(f"p{pid}: processes={args.nproc} local mesh {mesh.shape} on {dev}", flush=True)

    # the dense digit-plane step, batches over every process's dp rows
    rng = np.random.default_rng(0)
    bits, n, d = 2, 1024, 128
    qa = torch.from_numpy((rng.random((n, n)) < 0.01).astype(np.int32))
    qx = torch.from_numpy(rng.integers(0, 4, (n, d)).astype(np.int32))
    qws = [torch.from_numpy(rng.integers(0, 4, (d, 128)).astype(np.int32)) for _ in range(3)]
    a, x = digit_pack(qa, 1), digit_pack(qx, bits)
    ws = [digit_pack(w, bits) for w in qws]
    B = 2 * args.nproc * mesh.shape["dp"]
    sl = host_batch_slice(B)
    n_local = sl.stop - sl.start
    out = dp_sp_epoch_step(mesh, torch.stack([a.digits] * n_local), torch.stack([x.digits] * n_local), ws, bits,
                           x_bits=bits).gather("cpu")
    full = process_allgather(out)
    ref = qgcn_forward(pack_rows(qa.to(dev), 1), x.to(dev), [w.to(dev) for w in ws], bits).cpu()
    ok = full.shape[0] == B and all(torch.equal(full[i], ref) for i in range(B))
    print(f"p{pid}: MULTIHOST-{'OK' if ok else 'FAIL'} out={tuple(full.shape)}", flush=True)

    # the packed mesh engine over every process's share of each bucket
    ds = synthesize("Proteins", scale=0.05, seed=0)
    ref_eng = None
    for dp, sp in MESHES:
        batcher = ClusterBatcher(ds, psize=8, batch_size=2, bit_width=2, shuffle=False,
                                 bucket_rows=max(512, 256 * sp))
        eng = MeshEngine(batcher.feat_dim, ds.num_classes, dp=dp, sp=sp, model="gcn", bit_width=2, seed=0,
                         devices=[dev] * (dp * sp))
        eng.stage(batcher)
        fused_model.LAUNCHES = packmm.LAUNCHES = digitmm.LAUNCHES = 0
        outs = None
        for _ in range(args.epochs):
            outs = eng._epoch()
        eng._sync()
        launches = {"K1": fused_model.LAUNCHES, "K2": packmm.LAUNCHES, "K3": digitmm.LAUNCHES}
        gathered = [process_allgather(o) for o in eng.local_logits(outs)]
        ref_eng = ref_eng or QGTCEngine(batcher.feat_dim, ds.num_classes, model="gcn", bit_width=2, seed=0,
                                        device=dev)
        ok_mesh = eng.modes == ["mega" if sp == 1 else "ring"] * len(eng._staged)
        if dev.type == "cuda":  # the mesh's own kernels launched
            ok_mesh = ok_mesh and (launches["K1"] > 0 if sp == 1 else launches["K2"] > 0 and launches["K3"] > 0)
        for s, g in zip(eng._staged, gathered):
            for i, b in enumerate(s.batches):
                r = ref_eng.forward_batch(b)[: b.num_nodes, : ds.num_classes].cpu()
                ok_mesh = ok_mesh and torch.equal(r, g[i, : b.num_nodes, : ds.num_classes])
        ok = ok and ok_mesh
        print(f"p{pid}: MESH-EPOCH-{'OK' if ok_mesh else 'FAIL'} dp={dp} sp={sp} modes={eng.modes} "
              f"launches={launches}", flush=True)

        # this process's epoch wall over its own share
        barrier()
        eng._epoch()
        eng._sync()
        t0 = time.perf_counter()
        for _ in range(args.epochs):
            eng._epoch()
        eng._sync()
        wall = (time.perf_counter() - t0) * 1e3 / args.epochs
        local_batches = sum(s.local.stop - s.local.start for s in eng._staged)
        print(f"p{pid}: EPOCH-WALL dp={dp} sp={sp} ms={wall:.3f} local_batches={local_batches} "
              f"nproc={args.nproc}", flush=True)
    barrier()
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
