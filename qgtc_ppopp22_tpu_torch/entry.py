"""Entry points: one forward step of the flagship model, and a multi-device
dry run.

Counterpart of the JAX repository's ``__graft_entry__.py`` (``entry`` and
``dryrun_multichip``)::

    python -m qgtc_ppopp22_tpu_torch.entry [--devices N] [--device cuda:0|cpu]

runs ``entry()``'s step once, then ``dryrun_multichip(N)`` (distinct GPUs,
or the one ``--device`` repeated N times).
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import torch


def entry(device="cuda"):
    """``(fn, example_args)``: the forward step of the flagship model, QGCN
    (2-bit, digit compute format, zero-tile jumping) on one synthetic
    cluster batch, consuming the packed storage format as the engines do;
    the arguments on ``device``."""
    from qgtc_ppopp22_tpu_torch.graph import ClusterBatcher, synthesize
    from qgtc_ppopp22_tpu_torch.models.qmodels import QModelConfig, init_weights, pack_weights, qgcn_forward
    from qgtc_ppopp22_tpu_torch.ops.bitgemm import TileMap
    from qgtc_ppopp22_tpu_torch.ops.digits import to_digit_tensor
    from qgtc_ppopp22_tpu_torch.ops.packmm import PACK_GROUP, PackedTensor

    bits, dev = 2, torch.device(device)
    ds = synthesize("Proteins", scale=0.02, seed=0)
    batcher = ClusterBatcher(ds, psize=4, batch_size=2, bit_width=bits, shuffle=False)
    cfg = QModelConfig(batcher.feat_dim, 16, ds.num_classes, bit_width=bits)
    ws = [w.to(dev) for w in pack_weights(init_weights(torch.Generator().manual_seed(0), cfg), bits)]
    batch = batcher.batches[0]
    pn = batch.padded_nodes
    a = PackedTensor(words=batch.a_words.to(dev), shape=(pn, pn), bits=1)
    tm = TileMap(kidx=batch.tile_kidx.to(dev), kcnt=batch.tile_kcnt.to(dev), tile_m=PACK_GROUP, tile_k=256)

    def step(a, bit_x, tm, ws):
        return qgcn_forward(a, to_digit_tensor(bit_x), ws, bits, tile_map=tm)

    return step, (a, batch.bit_X.to(dev), tm, ws)


def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None) -> None:
    """Run the packed mesh engine over ``n_devices`` devices (``devices``,
    which may repeat one, else ``cuda:0 ... cuda:n-1``) in two shardings,
    each checked bit for bit against the single-device step engine
    (``QGTCEngine.forward_batch``) on the first device:

    * dp = n, sp = 1: every dp row runs the whole-model kernel on its share;
    * dp = n / 2, sp = 2 (n even): rows over sp, the ring of packed shard
      GEMMs.

    Prints each mesh's bucket modes; raises on a mismatch."""
    from qgtc_ppopp22_tpu_torch.graph import ClusterBatcher, synthesize
    from qgtc_ppopp22_tpu_torch.parallel import MeshEngine
    from qgtc_ppopp22_tpu_torch.runtime import QGTCEngine

    bits = 2
    devs = list(devices) if devices is not None else [f"cuda:{i}" for i in range(n_devices)]
    sp = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    dp = n_devices // sp
    ds = synthesize("Proteins", scale=0.05, seed=0)
    batcher = ClusterBatcher(ds, psize=8, batch_size=2, bit_width=bits, shuffle=False, bucket_rows=max(512, 256 * sp))
    ref = QGTCEngine(batcher.feat_dim, ds.num_classes, model="gcn", bit_width=bits, seed=0, device=devs[0])
    refs = [ref.forward_batch(b)[: b.num_nodes, : ds.num_classes].cpu() for b in batcher.batches]

    def check(eng, tag):
        for i, (r, o) in enumerate(zip(refs, eng.forward_batches(batcher))):
            if not torch.equal(r, o):
                raise AssertionError(f"dryrun_multichip {tag}: batch {i} differs from the single-device engine")
        print(f"dryrun_multichip {tag}: bit-exact, bucket modes {eng.modes}")

    check(MeshEngine(batcher.feat_dim, ds.num_classes, dp=n_devices, sp=1, model="gcn", bit_width=bits, seed=0,
                     devices=devs), f"dp={n_devices} sp=1 (K1 per dp row)")
    if sp > 1:
        check(MeshEngine(batcher.feat_dim, ds.num_classes, dp=dp, sp=sp, model="gcn", bit_width=bits, seed=0,
                         devices=devs), f"dp={dp} sp={sp} (packed ring)")
    print(f"dryrun_multichip ok: {n_devices} devices")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the flagship step once, then the multi-device dry run")
    p.add_argument("--devices", type=int, default=None, help="mesh size (default: every GPU)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda: distinct GPUs; cuda:K or cpu: that device repeated")
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    fn, ex = entry(dev if dev.index is not None or dev.type != "cuda" else "cuda:0")
    print(f"entry output shape: {tuple(fn(*ex).shape)}")
    n = args.devices or (torch.cuda.device_count() if dev.type == "cuda" else 1)
    dryrun_multichip(n, None if dev.type == "cuda" and dev.index is None else [dev] * n)
    return 0


if __name__ == "__main__":
    sys.exit(main())
