"""Single-device inference engine: the step engine and its epoch loop.

Counterpart of ``qgtc_ppopp22_tpu/runtime.py::QGTCEngine`` (the
reference's epoch machinery, ``main_qgtc.py:112-159``): iterate
pre-packed cluster batches, move each packed batch to the device (the
reference's ``cluster.cuda()`` boundary, ``main_qgtc.py:115``), convert
the features to digit planes there, run the quantized GEMM chain, and
synchronize once after all epochs.

The engine runs on the ``device`` it is given and nowhere else. On a
CUDA device every GEMM launches its kernel; on the CPU every GEMM runs
its plain PyTorch version. Ported so far: ``fmt='digits'`` with dense
GEMMs; the zero-tile, fused, mega and quant-in-loop engines are not.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from qgtc_ppopp22_tpu_torch.graph.batching import ClusterBatch, ClusterBatcher
from qgtc_ppopp22_tpu_torch.models.qmodels import (
    QModelConfig,
    init_weights,
    pack_weights,
    qgcn_forward,
    qgin_forward,
)
from qgtc_ppopp22_tpu_torch.ops.bitpack import BitTensor
from qgtc_ppopp22_tpu_torch.ops.digits import to_digit_tensor
from qgtc_ppopp22_tpu_torch.ops.packmm import PackedTensor


@dataclasses.dataclass
class EpochStats:
    """``epoch_ms`` holds per-epoch wall times when ``sync_every_epoch``
    was requested, else the one launch-all-then-synchronize window
    divided by the epoch count (``main_qgtc.py:157-159``)."""

    epoch_ms: List[float]
    n_batches: int

    @property
    def avg_ms(self) -> float:
        return float(np.mean(self.epoch_ms)) if self.epoch_ms else 0.0


class QGTCEngine:
    """Quantized GNN inference engine (reference ``main_qgtc.py`` role).

    ``model``: ``'gcn'`` (update then aggregate, hidden 16 by default) or
    ``'gin'`` (aggregate then update, hidden 64), ``main_qgtc.py:127-154``.
    Weights are drawn from ``torch.Generator().manual_seed(seed)``;
    assign ``self.weights`` (e.g. from ``models.qmodels.weights_from_jax``)
    to run other weights.
    """

    def __init__(
        self,
        feat_dim: int,
        num_classes: int,
        model: str = "gcn",
        bit_width: int = 2,
        hidden: Optional[int] = None,
        num_layers: int = 3,
        zerotile_jump: Optional[bool] = None,
        fmt: str = "digits",
        seed: int = 0,
        device="cpu",
    ):
        if model not in ("gcn", "gin"):
            raise ValueError(f"unknown model {model!r}")
        if zerotile_jump:
            raise NotImplementedError("zerotile_jump is not yet ported")
        if fmt != "digits":
            raise NotImplementedError(f"fmt={fmt!r} is not yet ported")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {self.device} requested but CUDA is not available")
        if hidden is None:
            hidden = 16 if model == "gcn" else 64  # 0_7a…py:6 / 0_7b…py:6
        self.model = model
        self.bit_width = bit_width
        self.cfg = QModelConfig(
            in_dim=feat_dim, hidden=hidden, out_dim=num_classes,
            bit_width=bit_width, num_layers=num_layers,
        )
        self.float_weights = init_weights(torch.Generator().manual_seed(seed), self.cfg)
        self.weights = [w.to(self.device) for w in pack_weights(self.float_weights, bit_width)]
        self._fwd = qgcn_forward if model == "gcn" else qgin_forward

    # -- single batch ---------------------------------------------------

    def put_batch(self, batch: ClusterBatch) -> Tuple[PackedTensor, BitTensor]:
        """Host -> device transfer of the packed storage format."""
        pn = batch.padded_nodes
        a = PackedTensor(words=batch.a_words.to(self.device), shape=(pn, pn), bits=1)
        return a, batch.bit_X.to(self.device)

    def _step(self, a: PackedTensor, bit_x: BitTensor, plain: bool = False) -> torch.Tensor:
        x = to_digit_tensor(bit_x)
        return self._fwd(a, x, self.weights, self.bit_width, plain=plain)

    def forward_batch(self, batch: ClusterBatch, plain: bool = False) -> torch.Tensor:
        """Logits [padded_nodes, num_classes] on the engine's device.
        ``plain=True`` runs the GEMMs' plain PyTorch versions instead of
        the kernels (the on-device reference)."""
        return self._step(*self.put_batch(batch), plain=plain)

    def forward_all(self, batcher: ClusterBatcher, plain: bool = False) -> List[torch.Tensor]:
        """Logits of every batch, in ``batcher.batches`` order."""
        return [self.forward_batch(b, plain=plain) for b in batcher.batches]

    # -- epoch loop (reference timing semantics) ------------------------

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warmup(self, batcher: ClusterBatcher) -> None:
        """Run one batch of every shape bucket outside the timed region
        (on CUDA this builds and loads the kernel library)."""
        seen = set()
        for b in batcher.batches:
            key = (b.padded_nodes, b.bit_X.shape[1])
            if key not in seen:
                seen.add(key)
                self.forward_batch(b)
        self._sync()

    def run_epochs(
        self,
        batcher: ClusterBatcher,
        n_epochs: int = 20,
        resident: bool = False,
        sync_every_epoch: bool = False,
    ) -> EpochStats:
        """Timed epochs over all cluster batches.

        ``resident=False`` is the reference's measured region: per-batch
        host -> device transfer of the packed tensors included, all
        epochs launched, one synchronize at the end. ``resident=True``
        moves the packed batches to the device once, before the timed
        region, and times compute only."""
        self.warmup(batcher)
        staged = [self.put_batch(b) for b in batcher.batches] if resident else None

        def one_epoch():
            if resident:
                for a, bit_x in staged:
                    self._step(a, bit_x)
            else:
                for batch in batcher:
                    self.forward_batch(batch)

        if sync_every_epoch:
            times = []
            for _ in range(n_epochs):
                t0 = time.perf_counter()
                one_epoch()
                self._sync()
                times.append((time.perf_counter() - t0) * 1e3)
            return EpochStats(epoch_ms=times, n_batches=len(batcher))
        t0 = time.perf_counter()
        for _ in range(n_epochs):
            one_epoch()
        self._sync()
        per_epoch = (time.perf_counter() - t0) * 1e3 / max(n_epochs, 1)
        return EpochStats(epoch_ms=[per_epoch], n_batches=len(batcher))

    # -- accuracy -------------------------------------------------------

    def evaluate(self, batcher: ClusterBatcher, labels: np.ndarray) -> float:
        """Masked node-classification accuracy over all batches."""
        correct = total = 0
        for batch, logits in zip(batcher.batches, self.forward_all(batcher)):
            pred = logits[: batch.num_nodes].argmax(dim=1).cpu().numpy()
            correct += int((pred == labels[batch.nodes]).sum())
            total += batch.num_nodes
        return correct / max(total, 1)
