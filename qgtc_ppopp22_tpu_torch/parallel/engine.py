"""MeshEngine: the packed engine on a (dp, sp) mesh of devices.

Counterpart of ``qgtc_ppopp22_tpu/parallel/engine.py``. It runs what the
single-device engines run:

* batches stay in the packed storage format (M-packed adjacency words,
  ``graph/batching.ClusterBatch.a_words``) end to end;
* at ``sp == 1`` each dp row runs the whole-model kernel K1 on its share of
  every stacked bucket (``parallel/packed.dp_mega_epoch_packed``), staged by
  the code that stages the single-device mega engine
  (``runtime.plan_mega_shards`` and ``stage_mega_shards``: the same
  zero-block gates, the same 5-8-bit levels form). A bucket K1's plan
  refuses runs the packed ring at sp 1 and says so: its mode reads
  ``"ring"``;
* at ``sp > 1`` the adjacency word rows are sharded and every aggregation
  is the ring of K2 raw-int32 shard GEMMs
  (``parallel/packed.dp_sp_epoch_packed``);
* the CLI reaches it with ``--mesh DP,SP``, and its epochs are timed as
  every engine's (``runtime._Engine._timed_epochs``).

A bucket's B is padded to a multiple of the global dp by repeating its last
batch; the padded outputs are dropped, and every bucket's output is
returned by the epoch. In a multi-process run (``parallel/multihost.py``)
each process stages only its ``host_batch_slice`` share of every padded
bucket.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from qgtc_ppopp22_tpu_torch.graph.batching import ClusterBatch, ClusterBatcher
from qgtc_ppopp22_tpu_torch.models.qmodels import QModelConfig, init_weights, pack_weights
from qgtc_ppopp22_tpu_torch.ops.bitpack import DIGIT_BITS, LANE, BitTensor, num_digits, round_up
from qgtc_ppopp22_tpu_torch.ops.digits import planes_stack_to_digits
from qgtc_ppopp22_tpu_torch.ops.packmm import PACK_GROUP
from qgtc_ppopp22_tpu_torch.parallel.multihost import host_batch_slice, process_allgather, process_count
from qgtc_ppopp22_tpu_torch.parallel.packed import dp_mega_epoch_packed, dp_sp_epoch_packed, shard_packed_batches
from qgtc_ppopp22_tpu_torch.parallel.sharded import Sharded, make_mesh, replicate
from qgtc_ppopp22_tpu_torch.runtime import EpochStats, _Engine, _threshold_f1, plan_mega_shards, stage_mega_shards

__all__ = ["MeshEngine", "MeshBucket", "x_digits_np"]


def x_digits_np(bit_x: BitTensor, pn: int) -> np.ndarray:
    """Packed feature planes -> int8 digit planes on the host (JAX
    ``parallel/engine.py:62``): words [bits, Mw, Kp] -> int8[nd, pn,
    round_up(K, 128)], the trim ``ops/digits.to_digit_tensor`` applies on
    the device, so a host-built stack holds the same operands."""
    planes = bit_x.planes.cpu().numpy().view(np.uint32)
    bits, (_, K) = bit_x.bits, bit_x.shape
    kp = round_up(K, LANE)
    j = np.arange(32, dtype=np.uint32)[None, None, :, None]
    ones = ((planes[:, :, None, :] >> j) & np.uint32(1)).reshape(bits, -1, planes.shape[2])  # [bits, Mw*32, Kp]
    out = []
    for d in range(num_digits(bits)):
        lo = d * DIGIT_BITS
        acc = ones[lo].copy()
        for b in range(lo + 1, min(lo + DIGIT_BITS, bits)):
            acc |= ones[b] << np.uint32(b - lo)
        out.append(acc[:pn, :kp].astype(np.int8))
    return np.stack(out)


@dataclasses.dataclass
class MeshBucket:
    """One staged shape bucket: ``fn()`` runs its epoch on the mesh and
    returns this process's share of its logits (:class:`Sharded`);
    ``batches`` its real batches, ``local`` this process's slice of the
    bucket padded to ``padded`` batches, ``mode`` ``"mega"`` or ``"ring"``,
    ``info`` what the staging chose."""

    fn: Callable[[], Sharded]
    batches: List[ClusterBatch]
    pn: int
    padded: int
    local: slice
    mode: str
    info: dict


class MeshEngine(_Engine):
    """Quantized GNN engine over a ``(dp, sp)`` mesh (:func:`make_mesh`:
    ``devices`` may repeat a device; by default distinct GPUs), packed
    format. Construction mirrors :class:`~qgtc_ppopp22_tpu_torch.runtime.
    QGTCEngine`: the same seeded weights, so its logits equal that engine's
    bit for bit; :meth:`set_float_weights` or assigning ``weights`` (e.g.
    ``models.qmodels.weights_from_jax``) runs others."""

    def __init__(
        self,
        feat_dim: int,
        num_classes: int,
        dp: int = 1,
        sp: int = 1,
        model: str = "gcn",
        bit_width: int = 2,
        hidden: Optional[int] = None,
        num_layers: int = 3,
        seed: int = 0,
        shifts: Optional[Sequence[int]] = None,
        clamp_bits: Optional[int] = None,
        zerotile_jump: Optional[bool] = None,
        devices: Optional[Sequence] = None,
    ):
        if model not in ("gcn", "gin"):
            raise ValueError(f"unknown model {model!r}")
        if clamp_bits is not None and clamp_bits > bit_width:
            raise ValueError("clamp_bits must be <= bit_width")
        if hidden is None:
            hidden = 16 if model == "gcn" else 64
        self.mesh = make_mesh(dp, sp, devices)
        self.device = self.mesh.devices[0][0]
        self.dp, self.sp = dp, sp
        self.model = model
        self.bit_width = bit_width
        self.clamp_bits = clamp_bits or bit_width
        self.zerotile_jump = zerotile_jump
        self.shifts = tuple(shifts) if shifts is not None else None
        self.cfg = QModelConfig(in_dim=feat_dim, hidden=hidden, out_dim=num_classes, bit_width=bit_width,
                                num_layers=num_layers)
        self.set_float_weights(init_weights(torch.Generator().manual_seed(seed), self.cfg))
        self._staged: List[MeshBucket] = []
        self._staged_for = None

    def set_float_weights(self, float_weights: Sequence[torch.Tensor], quant_bits: Optional[int] = None) -> None:
        """Run ``float_weights`` (CPU float32), quantized and packed as digit
        planes (``weights``, on the CPU; :meth:`stage` puts them on every
        device of the mesh)."""
        self.float_weights = list(float_weights)
        self.weights = pack_weights(self.float_weights, self.bit_width, fmt="digits", quant_bits=quant_bits)

    def _sync(self) -> None:
        self.mesh.synchronize()

    @property
    def modes(self) -> List[str]:
        """Each staged bucket's mode, ``"mega"`` or ``"ring"``."""
        return [s.mode for s in self._staged]

    # -- staging ---------------------------------------------------------

    def stage(self, batcher: ClusterBatcher) -> None:
        """Put every shape bucket's share on the mesh once, with the weights
        on every device, and choose each bucket's mode."""
        if batcher.bit_width != self.bit_width:
            raise ValueError(f"batcher bit width {batcher.bit_width} != engine {self.bit_width}")
        mesh, dp, sp = self.mesh, self.dp, self.sp
        ws = replicate(self.weights, mesh.distinct())
        dp_total = dp * process_count()
        groups: dict = {}
        for b in batcher.batches:
            groups.setdefault((b.padded_nodes, b.bit_X.shape[1]), []).append(b)
        prepared: dict = {}  # K1's weight operands by (device, form)
        self._staged = []
        for (pn, _), bs in groups.items():
            if pn % (sp * PACK_GROUP):
                raise ValueError(f"bucket pn={pn} not divisible by sp*{PACK_GROUP}={sp * PACK_GROUP}; rebuild the "
                                 f"batcher with bucket_rows a multiple of {sp * PACK_GROUP}")
            padded_n = round_up(len(bs), dp_total)
            padded = bs + [bs[-1]] * (padded_n - len(bs))
            sl = host_batch_slice(padded_n)
            local = padded[sl]
            a_words = torch.stack([b.a_words for b in local])
            x_planes = torch.stack([b.bit_X.planes for b in local])
            info = dict(pn=pn, batches=len(bs), padded=padded_n, fallback=False, compact=False, chunk_occ=False,
                        resident_a=None, skippable=None, form=None)
            fn = None
            if sp == 1:
                bl = len(local) // dp
                shards = [(mesh.devices[i][0], slice(i * bl, (i + 1) * bl)) for i in range(dp)]
                try:
                    geos = plan_mega_shards(local, ws.__getitem__, shards, model=self.model,
                                            clamp_bits=self.clamp_bits, shifts=self.shifts, cfg=self.cfg)
                except ValueError as e:
                    # Loudly, and never the plain version: the bucket's mode says "ring".
                    print(f"[mesh] bucket pn={pn}: K1 refuses it, running the packed ring at sp 1 "
                          f"({type(e).__name__}: {e})")
                    info["fallback"] = True
                else:
                    st = stage_mega_shards(local, a_words, x_planes, ws.__getitem__, shards, geos, info, prepared,
                                           model=self.model, shifts=self.shifts, cfg=self.cfg,
                                           zerotile_jump=self.zerotile_jump, resident_a=None)
                    fn = functools.partial(
                        dp_mega_epoch_packed, mesh, _rows(st.a), _rows(st.x), ws, self.clamp_bits,
                        blk_sched=_rows(st.blk_sched), chunk_occ=_rows(st.chunk_occ),
                        packed={dev: p for (dev, _), p in zip(shards, st.packed)}, **st.kw)
            if fn is None:
                xshape = local[0].bit_X.shape
                x_digits = torch.cat([planes_stack_to_digits(x_planes[i:i + 16], xshape, self.bit_width)
                                      for i in range(0, len(local), 16)])  # bounds the unpack intermediate
                a_sh, x_sh = shard_packed_batches(mesh, a_words, x_digits)
                fn = functools.partial(dp_sp_epoch_packed, mesh, a_sh, x_sh, ws, self.clamp_bits,
                                       x_bits=self.bit_width, model=self.model, shifts=self.shifts,
                                       x_cols=self.cfg.in_dim)
            mode = "mega" if fn.func is dp_mega_epoch_packed else "ring"
            self._staged.append(MeshBucket(fn, bs, pn, padded_n, sl, mode, info))
        self._staged_for = batcher

    def _epoch(self) -> List[Sharded]:
        """One epoch over every staged bucket; every bucket's output is
        returned (the JAX engine's guard, ``engine.py:297-301``)."""
        return [s.fn() for s in self._staged]

    # -- epochs ----------------------------------------------------------

    def run_epochs(self, batcher: ClusterBatcher, n_epochs: int = 20, sync_every_epoch: bool = False) -> EpochStats:
        """Stage (outside the timed region), then time ``n_epochs`` epochs
        after one untimed one, as every engine's: all launched, one
        synchronize of every device of the mesh, divided."""
        self.stage(batcher)
        return self._run_staged(self._epoch, n_epochs, len(batcher), sync_every_epoch)

    # -- exactness / accuracy ---------------------------------------------

    def local_logits(self, outs: Optional[List[Sharded]] = None) -> List[torch.Tensor]:
        """This process's share of each bucket's logits, on the CPU:
        float32[padded / processes, pn, classes or more] per bucket, from
        ``outs`` (one :meth:`_epoch`'s) or a new epoch."""
        return [o.gather("cpu") for o in (self._epoch() if outs is None else outs)]

    def forward_batches(self, batcher: ClusterBatcher) -> List[torch.Tensor]:
        """Logits of every real batch, [num_nodes, num_classes] each on the
        CPU, in ``batcher.batches`` order (padding dropped). In a
        multi-process run every process gathers every bucket."""
        if self._staged_for is not batcher:
            self.stage(batcher)
        per_batch = {}
        for s, local in zip(self._staged, self.local_logits()):
            full = process_allgather(local)
            for i, b in enumerate(s.batches):
                per_batch[id(b)] = full[i, : b.num_nodes, : self.cfg.out_dim]
        return [per_batch[id(b)] for b in batcher.batches]

    def evaluate(self, batcher: ClusterBatcher, labels: np.ndarray) -> float:
        """Masked argmax accuracy over every batch's real nodes."""
        correct = total = 0
        for b, logits in zip(batcher.batches, self.forward_batches(batcher)):
            correct += int((logits.argmax(dim=1).numpy() == labels[b.nodes]).sum())
            total += b.num_nodes
        return correct / max(total, 1)

    def evaluate_f1(self, batcher: ClusterBatcher, multilabels: np.ndarray) -> dict:
        """Multilabel micro / macro F1, thresholds as in
        ``runtime._threshold_f1`` (the single-device engines')."""
        logits = self.forward_batches(batcher)
        return _threshold_f1(torch.cat(logits).numpy(), np.concatenate([multilabels[b.nodes] for b in batcher.batches]))


def _rows(parts: Sequence[Optional[torch.Tensor]]) -> Optional[Sharded]:
    """Per-dp-row tensors as a batch-axis :class:`Sharded` (None if absent)."""
    if parts[0] is None:
        return None
    return Sharded(tuple((t,) for t in parts), None)
