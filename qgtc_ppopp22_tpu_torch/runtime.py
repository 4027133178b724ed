"""Single-device inference engines: the quantized engine and the baseline.

Counterpart of ``qgtc_ppopp22_tpu/runtime.py::QGTCEngine`` (the
reference's epoch machinery, ``main_qgtc.py:112-159``): iterate
pre-packed cluster batches, move each packed batch to the device (the
reference's ``cluster.cuda()`` boundary, ``main_qgtc.py:115``), convert
the features to digit planes there (``fmt='digits'``) or keep them as
bit planes (``fmt='bits'``), run the quantized GEMM chain, and
synchronize once after all epochs.

An engine runs on the ``device`` it is given (CUDA unless the caller
asks for the CPU) and nowhere else. On a CUDA device every GEMM launches
its kernel; on the CPU every GEMM runs its plain PyTorch version. Ported
so far: the step engine in both formats, ``fmt='digits'`` (packmm and
digitmm; with ``zerotile_jump=True`` the aggregations skip the
adjacency's all-zero 256 x 256 tiles through the batch's pack-time
``TileMap``) and ``fmt='bits'`` (the bit-plane GEMM ``bitgemm`` on the
one-bit tensor cores); the mega engine (``run_epochs_mega``, digits
only: one whole-model kernel launch per shape bucket,
``ops/fused_model.py``, 5-8-bit features staged as one plane of byte
levels); the fused and quant-in-loop engines (``run_epochs_fused``,
``run_epochs_quant_in_loop``: every bucket staged on the device once, the
whole epoch's chains captured into one CUDA graph, one replay an epoch,
JAX's ``lax.scan`` in one dispatch); and the full-precision
``BaselineEngine`` (step, fused and mega modes, the fused loop captured
likewise, the mega mode through the ``fused_baseline`` kernel); and the
full-graph ``SparseEngine`` (``models/sparse.py`` over the whole CSR
graph: no clustering, no densification).
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from qgtc_ppopp22_tpu_torch.graph.batching import ClusterBatch, ClusterBatcher
from qgtc_ppopp22_tpu_torch.models.baselines import gin_forward, init_mlp_weights, sage_forward
from qgtc_ppopp22_tpu_torch.models.golden import quantize_np
from qgtc_ppopp22_tpu_torch.models.qmodels import (
    QModelConfig,
    init_weights,
    pack_weights,
    qgcn_forward,
    qgin_forward,
)
from qgtc_ppopp22_tpu_torch.models.sparse import sparse_q_forward
from qgtc_ppopp22_tpu_torch.ops import fused_model
from qgtc_ppopp22_tpu_torch.ops.bitgemm import TileMap
from qgtc_ppopp22_tpu_torch.ops.bitpack import LANE, BitTensor, num_digits, pack_bits, round_up
from qgtc_ppopp22_tpu_torch.ops.digits import planes_stack_to_digits, to_digit_tensor
from qgtc_ppopp22_tpu_torch.ops.packmm import PACK_GROUP, PackedTensor
from qgtc_ppopp22_tpu_torch.ops.quantize import quantize
from qgtc_ppopp22_tpu_torch.utils.metrics import multilabel_f1


@dataclasses.dataclass
class EpochStats:
    """``epoch_ms`` holds per-epoch wall times when ``sync_every_epoch``
    was requested, else the one launch-all-then-synchronize window
    divided by the epoch count (``main_qgtc.py:157-159``), which is also
    ``launch_sync_ms``."""

    epoch_ms: List[float]
    n_batches: int
    launch_sync_ms: float = 0.0

    @property
    def avg_ms(self) -> float:
        return float(np.mean(self.epoch_ms)) if self.epoch_ms else 0.0


class _Engine:
    """What both engines share: the device, its synchronize, and the
    reference's epoch timing."""

    device: torch.device

    def _set_device(self, device) -> None:
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {self.device} requested but CUDA is not available")

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _capture(self, fn: Callable[[], list]) -> Callable[[], list]:
        """``fn``, an epoch that returns every batch's output, made
        replayable. On a CUDA device ``fn`` runs once on a side stream (the
        kernel library is built and loaded at first use, the launch plans
        are cached per shape), is then captured once into a
        ``torch.cuda.CUDAGraph``, and the result replays the graph and
        returns the graph's static outputs, which each replay overwrites in
        place. Every output ``fn`` returned is one the graph writes, so no
        batch's work can be left out of an epoch (the JAX engine's guard,
        ``runtime.py:334-339``). A capture or replay that fails raises. On
        the CPU there is nothing to capture: ``fn`` itself runs, on the
        plain versions."""
        if self.device.type != "cuda":
            return fn
        with torch.cuda.device(self.device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                fn()
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                outs = fn()
        return _Replay(fn, graph, outs)

    def _capture_epoch(self, staged: List[tuple], n_batches: int) -> Callable[[], list]:
        """The captured epoch (:meth:`_capture`) of every bucket of
        ``staged`` ([(indices, fn)], ``fn()`` a bucket's per-batch
        outputs): its replay returns each batch's output in batch order."""

        def epoch():
            out: List[Optional[torch.Tensor]] = [None] * n_batches
            for idx, fn in staged:
                for i, logits in zip(idx, fn()):
                    out[i] = logits
            return out

        return self._capture(epoch)

    def _timed_epochs(
        self, one_epoch: Callable[[], object], n_epochs: int, n_batches: int,
        sync_every_epoch: bool,
    ) -> EpochStats:
        if sync_every_epoch:
            times = []
            for _ in range(n_epochs):
                t0 = time.perf_counter()
                one_epoch()
                self._sync()
                times.append((time.perf_counter() - t0) * 1e3)
            return EpochStats(epoch_ms=times, n_batches=n_batches)
        t0 = time.perf_counter()
        for _ in range(n_epochs):
            one_epoch()
        self._sync()
        per_epoch = (time.perf_counter() - t0) * 1e3 / max(n_epochs, 1)
        return EpochStats(epoch_ms=[per_epoch], n_batches=n_batches, launch_sync_ms=per_epoch)

    def _run_staged(self, one_epoch: Callable[[], object], n_epochs: int, n_batches: int,
                    sync_every_epoch: bool) -> EpochStats:
        """:meth:`_timed_epochs` of an epoch whose inputs are already on the
        device, after one untimed epoch (on CUDA: the kernel library's
        build and load, a graph's first replay)."""
        one_epoch()
        self._sync()
        return self._timed_epochs(one_epoch, n_epochs, n_batches, sync_every_epoch)


class _Replay:
    """A captured epoch: calling it replays the graph and returns its
    static outputs. It holds the captured function, whose staged inputs
    the graph reads, for as long as the graph lives."""

    def __init__(self, fn: Callable[[], list], graph, outs: list):
        self.fn, self.graph, self.outs = fn, graph, outs

    def __call__(self) -> list:
        self.graph.replay()
        return self.outs


class QGTCEngine(_Engine):
    """Quantized GNN inference engine (reference ``main_qgtc.py`` role).

    ``model``: ``'gcn'`` (update then aggregate, hidden 16 by default) or
    ``'gin'`` (aggregate then update, hidden 64), ``main_qgtc.py:127-154``.
    ``fmt``: ``'digits'`` (packed adjacency x digit planes, the step,
    fused and mega engines) or ``'bits'`` (bit planes throughout, the reference's
    bit-serial form; step engine only). Weights are drawn from ``torch.Generator().manual_seed(seed)``;
    :meth:`set_float_weights` runs other float weights (trained ones, a
    checkpoint's), and assigning ``self.weights`` (e.g. from
    ``models.qmodels.weights_from_jax``) other packed ones.

    ``shifts``: per-GEMM requantize shifts in ``qgcn_forward`` /
    ``qgin_forward`` order (None: the reference's unscaled requantize),
    passed to every engine mode; the bit-plane GEMM refuses a non-zero
    shift, as JAX's does. ``clamp_bits`` (default ``bit_width``, at most
    it): the width every intermediate is requantized to, so a wide
    datapath reproduces a narrower model exactly (JAX
    ``runtime.py:97-111``).
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
        device="cuda",
        shifts: Optional[Sequence[int]] = None,
        clamp_bits: Optional[int] = None,
    ):
        if model not in ("gcn", "gin"):
            raise ValueError(f"unknown model {model!r}")
        if fmt not in ("digits", "bits"):
            raise ValueError(f"unknown fmt {fmt!r}")
        if clamp_bits is not None and clamp_bits > bit_width:
            raise ValueError("clamp_bits must be <= bit_width")
        self._set_device(device)
        if hidden is None:
            hidden = 16 if model == "gcn" else 64  # 0_7a…py:6 / 0_7b…py:6
        self.model = model
        self.bit_width = bit_width
        self.clamp_bits = clamp_bits or bit_width
        self.shifts = tuple(shifts) if shifts is not None else None
        # Tri-state, as in the JAX engine: True forces zero-tile skipping
        # (the digit step engine's TileMap K skip, the mega kernel's
        # compacted block schedule), False forbids it, None = auto: off in
        # the step engine, the gate of run_epochs_mega in mega mode. The
        # bits step engine passes no map, as JAX's (runtime.py:158-163).
        self.zerotile_jump = zerotile_jump
        self.fmt = fmt
        self.mega_buckets: List[dict] = []  # what run_epochs_mega staged
        self.cfg = QModelConfig(
            in_dim=feat_dim, hidden=hidden, out_dim=num_classes,
            bit_width=bit_width, num_layers=num_layers,
        )
        self.set_float_weights(init_weights(torch.Generator().manual_seed(seed), self.cfg))
        self._fwd = qgcn_forward if model == "gcn" else qgin_forward

    def set_float_weights(self, float_weights: Sequence[torch.Tensor], quant_bits: Optional[int] = None) -> None:
        """Run ``float_weights`` (CPU float32 tensors, e.g. trained by
        ``models.train`` or read by ``load_checkpoint``): kept as
        ``float_weights``, quantized and packed in the engine's format onto
        its device as ``weights``. ``quant_bits`` (default ``bit_width``): the
        weights' quantization grid (``pack_weights``)."""
        self.float_weights = list(float_weights)
        self.weights = [w.to(self.device) for w in pack_weights(self.float_weights, self.bit_width, fmt=self.fmt,
                                                                quant_bits=quant_bits)]

    # -- single batch ---------------------------------------------------

    def _tile_map(self, batch: ClusterBatch) -> Optional[TileMap]:
        """The batch's pack-time zero-tile schedule on the device, for
        ``zerotile_jump=True`` and ``fmt='digits'`` only (JAX
        ``runtime.py:154-169``: the reference's Fig. 8b mechanism, built
        once on the host instead of per step on the device)."""
        if not self.zerotile_jump or self.fmt != "digits":
            return None
        return TileMap(kidx=batch.tile_kidx.to(self.device), kcnt=batch.tile_kcnt.to(self.device),
                       tile_m=PACK_GROUP, tile_k=256)

    def put_batch(
        self, batch: ClusterBatch
    ) -> Tuple[Union[PackedTensor, BitTensor], BitTensor, Optional[TileMap]]:
        """Host -> device transfer of the packed storage format: the
        M-packed adjacency words (``fmt='digits'``) or its 1-bit planes
        (``fmt='bits'``), the feature planes, and the zero-tile map
        (:meth:`_tile_map`, else None)."""
        if self.fmt == "bits":
            a = batch.bit_A.to(self.device)
        else:
            pn = batch.padded_nodes
            a = PackedTensor(words=batch.a_words.to(self.device), shape=(pn, pn), bits=1)
        return a, batch.bit_X.to(self.device), self._tile_map(batch)

    def _step(self, a, bit_x: BitTensor, tile_map: Optional[TileMap] = None,
              plain: bool = False) -> torch.Tensor:
        x = to_digit_tensor(bit_x) if self.fmt == "digits" else bit_x
        return self._fwd(a, x, self.weights, self.clamp_bits, shifts=self.shifts, plain=plain,
                         tile_map=tile_map)

    def forward_batch(self, batch: ClusterBatch, plain: bool = False) -> torch.Tensor:
        """Logits [padded_nodes, num_classes] on the engine's device.
        ``plain=True`` runs the GEMMs' plain PyTorch versions instead of
        the kernels (the on-device reference)."""
        return self._step(*self.put_batch(batch), plain=plain)

    def forward_all(self, batcher: ClusterBatcher, plain: bool = False) -> List[torch.Tensor]:
        """Logits of every batch, in ``batcher.batches`` order."""
        return [self.forward_batch(b, plain=plain) for b in batcher.batches]

    # -- epoch loop (reference timing semantics) ------------------------

    def warmup(self, batcher: ClusterBatcher) -> None:
        """Run one batch of every shape bucket outside the timed region
        (on CUDA this builds and loads the kernel library); with
        ``fmt='bits'``, first pack every batch's ``bit_A`` on the host."""
        if self.fmt == "bits":
            for b in batcher.batches:
                b.bit_A  # packed on first use, then kept
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
        region, and times compute only; each batch's zero-tile map crosses
        with it either way."""
        self.warmup(batcher)
        staged = [self.put_batch(b) for b in batcher.batches] if resident else None

        def one_epoch():
            if resident:
                for t in staged:
                    self._step(*t)
            else:
                for batch in batcher:
                    self.forward_batch(batch)

        return self._timed_epochs(one_epoch, n_epochs, len(batcher), sync_every_epoch)

    def measure_transfer_ms(self, batcher: ClusterBatcher, n_rounds: int = 3) -> float:
        """Wall milliseconds to move one epoch's packed batches to the
        device (:meth:`put_batch` for every batch, then one synchronize):
        the reference's per-step ``cluster.cuda()`` boundary
        (``main_qgtc.py:115``) alone. The minimum over ``n_rounds`` (JAX
        ``runtime.py:426-444``)."""
        times = []
        for _ in range(n_rounds):
            t0 = time.perf_counter()
            for b in batcher.batches:
                self.put_batch(b)
            self._sync()
            times.append((time.perf_counter() - t0) * 1e3)
        return min(times)

    # -- fused engine: every bucket staged once, one captured epoch ------

    def _fused_groups(self, batcher: ClusterBatcher):
        """Stack the batches by shape bucket -> [(key, indices, a_stack,
        x_stack, kidx_stack, kcnt_stack)]: ``a_stack`` int32[B, 1, pn/32,
        pn] packed adjacency words, ``x_stack`` int32[B, bits, Mw, Kp]
        feature planes, and with ``zerotile_jump`` set each batch's
        zero-tile map (``tile_kidx`` int32[B, nm, nk], ``tile_kcnt``
        int32[B, nm]; else None), all on the CPU (JAX ``runtime.py:239-257``);
        ``indices`` into ``batcher.batches``."""
        groups: dict = {}
        for i, b in enumerate(batcher.batches):
            groups.setdefault((b.padded_nodes, b.bit_X.shape[1]), []).append(i)
        out = []
        for key, idx in groups.items():
            bs = [batcher.batches[i] for i in idx]
            kidx = kcnt = None
            if self.zerotile_jump:
                kidx = torch.stack([b.tile_kidx for b in bs])
                kcnt = torch.stack([b.tile_kcnt for b in bs])
            out.append((key, idx, torch.stack([b.a_words for b in bs]),
                        torch.stack([b.bit_X.planes for b in bs]), kidx, kcnt))
        return out

    def _fused_bucket(self, bs: Sequence[ClusterBatch], a_stack: torch.Tensor, x_stack: torch.Tensor,
                      kidx: Optional[torch.Tensor], kcnt: Optional[torch.Tensor],
                      features: Optional[np.ndarray] = None) -> Callable[[], List[torch.Tensor]]:
        """Stage one bucket on the device -> ``fn()``, which runs each of its
        batches' chains (``to_digit_tensor``, then the forward with the
        batch's ``TileMap`` when maps are given) and returns their logits.
        With ``features`` (the batcher's float features) the batches' float
        features [pn, feat] are staged instead of their planes, and each
        chain first quantizes and packs them on the device (JAX
        ``runtime.py:349-424``). Nothing in ``fn`` copies from the host or
        waits for the device, so it can be captured."""
        dev, bw, pn = self.device, self.bit_width, bs[0].padded_nodes
        xshape = bs[0].bit_X.shape
        if features is None:
            xs = [BitTensor(planes=p, shape=xshape, bits=bw) for p in _aligned_rows(x_stack, dev)]
        else:
            xf = np.zeros((len(bs),) + tuple(xshape), np.float32)
            for i, b in enumerate(bs):
                xf[i, :b.num_nodes] = features[b.nodes]
            xs = _aligned_rows(torch.from_numpy(xf), dev)
        tms = [None] * len(bs)
        if kidx is not None:
            tms = [TileMap(kidx=k, kcnt=c, tile_m=PACK_GROUP, tile_k=256)
                   for k, c in zip(_aligned_rows(kidx, dev), _aligned_rows(kcnt, dev))]
        staged = [(PackedTensor(words=a, shape=(pn, pn), bits=1), x, tm)
                  for a, x, tm in zip(_aligned_rows(a_stack, dev), xs, tms)]

        def run() -> List[torch.Tensor]:
            if features is None:
                return [self._step(a, x, tm) for a, x, tm in staged]
            return [self._step(a, pack_bits(quantize(x, bw), bw), tm) for a, x, tm in staged]

        return run

    def _stage_fused(self, batcher: ClusterBatcher, quant_in_loop: bool = False) -> List[tuple]:
        """Every bucket on the device once -> [(indices, fn)], ``fn`` as
        :meth:`_fused_bucket` gives it (with the batcher's float features
        under ``quant_in_loop``)."""
        if self.fmt != "digits":
            raise ValueError(f"{'quant-in-loop' if quant_in_loop else 'fused'} mode requires fmt='digits'")
        feats = batcher.features if quant_in_loop else None
        return [(idx, self._fused_bucket([batcher.batches[i] for i in idx], a, x, kidx, kcnt, feats))
                for _, idx, a, x, kidx, kcnt in self._fused_groups(batcher)]

    def _fused_epoch(self, batcher: ClusterBatcher, quant_in_loop: bool = False) -> Callable[[], list]:
        """The fused (or quant-in-loop) epoch, captured (:meth:`_capture`):
        each call is one epoch and returns every batch's logits [pn,
        classes] in ``batcher.batches`` order."""
        return self._capture_epoch(self._stage_fused(batcher, quant_in_loop), len(batcher.batches))

    def _fused_logits(self, batcher: ClusterBatcher, quant_in_loop: bool = False) -> List[torch.Tensor]:
        """Each batch's logits from one fused (or quant-in-loop) epoch, in
        ``batcher.batches`` order (on a CUDA device, the graph's outputs)."""
        return self._fused_epoch(batcher, quant_in_loop)()

    def run_epochs_fused(
        self,
        batcher: ClusterBatcher,
        n_epochs: int = 20,
        sync_every_epoch: bool = False,
    ) -> EpochStats:
        """Timed epochs of the fused engine (JAX ``runtime.py:303-347``):
        the buckets are staged on the device once, outside the timed
        region, and each epoch is one replay of the captured chains of
        every batch. Timing as in ``run_epochs``."""
        return self._run_staged(self._fused_epoch(batcher), n_epochs, len(batcher), sync_every_epoch)

    def run_epochs_quant_in_loop(
        self,
        batcher: ClusterBatcher,
        n_epochs: int = 20,
        sync_every_epoch: bool = False,
    ) -> EpochStats:
        """Timed epochs that quantize and pack the features on the device
        inside the epoch, as the reference's in-loop ``val2bit`` variant
        does (``cluster_gcn.py:181-182,205-206``; JAX ``runtime.py:349-424``):
        the float features are staged per bucket, and the captured chain of
        each batch runs ``quantize``, ``pack_bits`` and ``to_digit_tensor``
        before its forward. Against :meth:`run_epochs_fused` the difference
        is the in-loop quantization alone."""
        return self._run_staged(self._fused_epoch(batcher, quant_in_loop=True), n_epochs,
                                len(batcher), sync_every_epoch)

    # -- mega engine: one whole-model kernel launch per bucket ----------

    def _stage_mega(self, batcher: ClusterBatcher, resident_a: Optional[bool] = None) -> List[tuple]:
        """Move every bucket to the device once -> [(indices, fn)]: ``fn()``
        runs the bucket's epoch and returns its logits, float32[B, pn, oc]
        from one fused_model kernel launch, or, for a bucket the kernel
        refuses, a list of per-batch logits from the bucket's captured
        fused epoch (:meth:`_fused_bucket`, :meth:`_capture`). Records
        each bucket's choices in ``self.mega_buckets``: ``form`` is the
        kernel's (``MegaPlan.form``), ``"signed"`` or ``"split"`` for 5-8-bit
        features, which cross as one plane of byte levels (JAX
        ``runtime.py:504-516``), else ``"digits"``. The weights' operands
        (:func:`fused_model.pack_mega_weights`) are built here once for
        each form the buckets take, and every launch is given them.

        ``resident_a`` is JAX's residency tier (``runtime.py:531-613``):
        ``False`` (streamed A) never takes the compacted block schedule and
        passes the occupancy map as ``chunk_occ`` when ``zerotile_jump`` is
        True or, with it None, at >= 30% skippable blocks; ``True`` and
        ``None`` take the resident kernel's compact gate. On the card both
        tiers are the same launch. On a CUDA device a bucket whose launch
        plan (:func:`fused_model.fused_model_plan`: the shared-memory
        budget, JAX's VMEM probe) refuses it falls back too."""
        if self.fmt != "digits":
            raise ValueError("mega mode requires fmt='digits'")
        staged, self.mega_buckets = [], []
        prepared: dict = {}  # K1's weight operands, built once for each form the buckets take
        for (pn, _), idx, a_np, x_np, kidx, kcnt in self._fused_groups(batcher):
            bs = [batcher.batches[i] for i in idx]
            info = dict(pn=pn, batches=len(idx), fallback=False, compact=False, chunk_occ=False,
                        resident_a=resident_a, skippable=None, form=None)
            self.mega_buckets.append(info)
            weights_on, shards = (lambda _dev: self.weights), [(self.device, slice(None))]
            try:
                geos = plan_mega_shards(bs, weights_on, shards, model=self.model, clamp_bits=self.clamp_bits,
                                        shifts=self.shifts, cfg=self.cfg)
            except ValueError as e:
                # Loudly: a silent fallback would turn a "mega" measurement
                # into a fused-engine one.
                print(f"[mega] bucket pn={pn}: falling back to the captured fused epoch "
                      f"({type(e).__name__}: {e})")
                info["fallback"] = True
                staged.append((idx, self._capture(self._fused_bucket(bs, a_np, x_np, kidx, kcnt))))
                continue
            st = stage_mega_shards(bs, a_np, x_np, weights_on, shards, geos, info, prepared, model=self.model,
                                   shifts=self.shifts, cfg=self.cfg, zerotile_jump=self.zerotile_jump,
                                   resident_a=resident_a)
            tier = {} if resident_a is None else dict(resident_a=resident_a)
            if st.chunk_occ[0] is not None:
                tier["chunk_occ"] = st.chunk_occ[0]
            staged.append((idx, functools.partial(
                fused_model.fused_model_epoch, st.a[0], st.x[0], self.weights, self.clamp_bits,
                blk_sched=st.blk_sched[0], packed=st.packed[0], **st.kw, **tier,
            )))
        return staged

    def _mega_logits(self, batcher: ClusterBatcher, resident_a: Optional[bool] = None) -> List[torch.Tensor]:
        """Each batch's mega-engine logits, in ``batcher.batches`` order
        ([pn, oc] from the kernel, [pn, classes] from a fallback)."""
        out: List[Optional[torch.Tensor]] = [None] * len(batcher.batches)
        for idx, fn in self._stage_mega(batcher, resident_a):
            for i, logits in zip(idx, fn()):
                out[i] = logits
        return out

    def run_epochs_mega(
        self,
        batcher: ClusterBatcher,
        n_epochs: int = 20,
        sync_every_epoch: bool = False,
        resident_a: Optional[bool] = None,
    ) -> EpochStats:
        """Timed epochs of the mega engine: the buckets are staged on the
        device once (outside the timed region), and each epoch launches
        one fused_model kernel per bucket. Every bucket's output is kept
        by the epoch, so no bucket's work can be dropped (the JAX
        engine's guard, runtime.py:659-666). Timing as in ``run_epochs``:
        all epochs launched, one synchronize, divided. ``resident_a``: the
        JAX engine's tier choice (:meth:`_stage_mega`)."""
        staged = self._stage_mega(batcher, resident_a)
        fns = [fn for _, fn in staged]

        def one_epoch():
            return [fn() for fn in fns]

        return self._run_staged(one_epoch, n_epochs, len(batcher), sync_every_epoch)

    # -- accuracy -------------------------------------------------------

    def _real_logits(self, batcher: ClusterBatcher, mode: str):
        """(batch, logits [num_nodes, num_classes]) of every batch, the
        logits from ``mode``'s engine: ``"step"`` (:meth:`forward_all`),
        ``"fused"`` (one captured epoch) or ``"mega"`` (one ``fused_model``
        launch a bucket, :meth:`_mega_logits`)."""
        engines = {"step": self.forward_all, "fused": self._fused_logits, "mega": self._mega_logits}
        if mode not in engines:
            raise ValueError(f"unknown mode {mode!r}: {sorted(engines)}")
        for batch, logits in zip(batcher.batches, engines[mode](batcher)):
            yield batch, logits[: batch.num_nodes, : self.cfg.out_dim]

    def evaluate(self, batcher: ClusterBatcher, labels: np.ndarray, mode: str = "step") -> float:
        """Masked node-classification accuracy over all batches, the logits
        from ``mode``'s engine (:meth:`_real_logits`)."""
        correct = total = 0
        for batch, logits in self._real_logits(batcher, mode):
            pred = logits.argmax(dim=1).cpu().numpy()
            correct += int((pred == labels[batch.nodes]).sum())
            total += batch.num_nodes
        return correct / max(total, 1)

    def evaluate_f1(self, batcher: ClusterBatcher, multilabels: np.ndarray, mode: str = "step") -> dict:
        """Multilabel micro / macro F1 (reference ``calc_f1`` /
        ``evaluate``, ``utils.py:43-60``, used for ppi), the logits from
        ``mode``'s engine. The engine's logits are unsigned integers, so
        the reference's threshold at 0 becomes the per-class mean logit
        (``_threshold_f1``), as in the JAX engine."""
        rows, labs = [], []
        for batch, logits in self._real_logits(batcher, mode):
            rows.append(logits.cpu().numpy())
            labs.append(multilabels[batch.nodes])
        return _threshold_f1(np.concatenate(rows), np.concatenate(labs))


class SparseEngine(_Engine):
    """Full-graph sparse quantized engine (``models/sparse.py`` over the
    whole CSR graph: no clustering, no densification), the counterpart of
    JAX ``runtime.SparseEngine`` (``runtime.py:747-830``).

    The same run / record interface as :class:`QGTCEngine`, so the CLI
    treats every engine alike. ``float_weights`` (e.g. a JAX engine's, as
    NumPy arrays) and ``shifts`` replace the seeded weights and the
    unscaled requantize; the result is the exact-integer equivalent of the
    dense engines on the full graph. The graph, the feature levels and the
    weight levels are put on ``device`` once, at construction."""

    def __init__(
        self,
        dataset,
        model: str = "gcn",
        bit_width: int = 2,
        hidden: Optional[int] = None,
        num_layers: int = 3,
        seed: int = 0,
        shifts: Optional[Sequence[int]] = None,
        float_weights: Optional[Sequence] = None,
        device="cuda",
    ):
        if model not in ("gcn", "gin"):
            raise ValueError(f"unknown model {model!r}")
        self._set_device(device)
        if hidden is None:
            hidden = 16 if model == "gcn" else 64
        self.model = model
        self.bit_width = bit_width
        self.dataset = dataset
        self.cfg = QModelConfig(in_dim=dataset.feat_dim, hidden=hidden, out_dim=dataset.num_classes,
                                bit_width=bit_width, num_layers=num_layers)
        if float_weights is None:
            float_weights = init_weights(torch.Generator().manual_seed(seed), self.cfg)
        self.float_weights = [w.cpu().numpy() if isinstance(w, torch.Tensor) else np.asarray(w, np.float32)
                              for w in float_weights]
        self.shifts = tuple(shifts) if shifts is not None else None
        dev = self.device
        self._qws = [torch.from_numpy(quantize_np(w, bit_width)).to(dev) for w in self.float_weights]
        self._indptr = torch.from_numpy(np.asarray(dataset.graph.indptr, np.int64)).to(dev)
        self._indices = torch.from_numpy(np.asarray(dataset.graph.indices, np.int64)).to(dev)
        self._qx = torch.from_numpy(quantize_np(dataset.features, bit_width)).to(dev)

    def forward(self) -> torch.Tensor:
        """float32 logits [num_nodes, num_classes] on the engine's device."""
        return sparse_q_forward(self._indptr, self._indices, self._qx, self._qws, out_bits=self.bit_width,
                                model=self.model, shifts=self.shifts)

    def run_epochs(self, n_epochs: int = 20, sync_every_epoch: bool = False) -> EpochStats:
        """Timed epochs, one full-graph forward each, after one untimed
        forward; timing as in :meth:`QGTCEngine.run_epochs` (one batch an
        epoch)."""
        return self._run_staged(self.forward, n_epochs, 1, sync_every_epoch)

    def evaluate(self, labels: np.ndarray) -> float:
        """Argmax accuracy over every node."""
        pred = self.forward()[: len(labels)].argmax(dim=1).cpu().numpy()
        return float((pred == labels).mean())

    def evaluate_f1(self, multilabels: np.ndarray) -> dict:
        """Multilabel micro / macro F1 (see :meth:`QGTCEngine.evaluate_f1`)."""
        return _threshold_f1(self.forward()[: len(multilabels)].cpu().numpy(), multilabels)


class BaselineEngine(_Engine):
    """Full-precision baseline engine (reference DGL-driver role,
    ``cluster_gcn_dgl.py`` / ``batched_gin_dgl.py``): dense bf16
    aggregation over the same cluster batches as :class:`QGTCEngine`.

    ``model``: ``'sage'`` (hidden 16 by default) or ``'gin'`` (hidden
    64). Weights are drawn from ``torch.Generator().manual_seed(seed)``;
    assign ``self.weights`` (e.g. from
    ``models.baselines.baseline_weights_from_jax``) to run others. Each
    batch's dense uint8 adjacency and float32 features are built once on
    the host and cached (``_batch_key``)."""

    def __init__(
        self,
        feat_dim: int,
        num_classes: int,
        model: str = "sage",
        hidden: Optional[int] = None,
        num_layers: int = 3,
        seed: int = 0,
        device="cuda",
    ):
        if model not in ("sage", "gin"):
            raise ValueError(f"unknown baseline model {model!r}")
        self._set_device(device)
        if hidden is None:
            hidden = 16 if model == "sage" else 64
        self.model = model
        dims = [feat_dim] + [hidden] * (num_layers - 1) + [num_classes]
        gen = torch.Generator().manual_seed(seed)
        self.weights = [w.to(self.device) for w in init_mlp_weights(gen, dims)]
        self._fwd = sage_forward if model == "sage" else gin_forward
        self._dense_cache: dict = {}
        self.mega_buckets: List[dict] = []  # what run_epochs_mega staged

    # -- single batch ---------------------------------------------------

    def _dense(self, batch: ClusterBatch, dataset, features=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """The batch's host tensors (uint8 A [pn, pn], float32 X [pn,
        feat]) from the cache, built on first use. ``features`` must be
        the batcher's; absent, the dataset's."""
        key = _batch_key(batch)
        if key not in self._dense_cache:
            feats = features if features is not None else dataset.features
            n, pn, f = batch.num_nodes, batch.padded_nodes, batch.bit_X.shape[1]
            a = np.zeros((pn, pn), np.uint8)
            a[:n, :n] = dataset.graph.subgraph_dense(batch.nodes)
            x = np.zeros((pn, f), np.float32)
            x[:n] = feats[batch.nodes][:, :f]
            self._dense_cache[key] = (torch.from_numpy(a), torch.from_numpy(x))
        return self._dense_cache[key]

    def forward_batch(self, batch: ClusterBatch, dataset, features=None) -> torch.Tensor:
        """Logits [padded_nodes, num_classes] on the engine's device. The
        dense A and X cross to the device on every call, as the DGL
        baseline ships each subgraph (``cluster_gcn_dgl.py:97-101``)."""
        a, x = self._dense(batch, dataset, features)
        return self._fwd(a.to(self.device), x.to(self.device), self.weights)

    # -- epoch loops ----------------------------------------------------

    def run_epochs(
        self,
        batcher: ClusterBatcher,
        dataset,
        n_epochs: int = 20,
        resident: bool = True,
        sync_every_epoch: bool = False,
    ) -> EpochStats:
        """Timed step epochs: one forward chain per batch. ``resident``
        moves every batch's dense A and X to the device before the timed
        region; otherwise each batch's copy is timed too."""
        for b in batcher.batches:  # fills the dense cache
            self.forward_batch(b, dataset, batcher.features)
        self._sync()
        ws = self.weights
        staged = None
        if resident:
            staged = [tuple(t.to(self.device) for t in self._dense(b, dataset))
                      for b in batcher.batches]

        def one_epoch():
            if resident:
                return [self._fwd(a, x, ws) for a, x in staged]
            return [self.forward_batch(b, dataset) for b in batcher]

        return self._timed_epochs(one_epoch, n_epochs, len(batcher), sync_every_epoch)

    def _stage(self, batcher: ClusterBatcher, dataset, a_dtype: torch.dtype) -> List[tuple]:
        """Every bucket's stacks on the device -> [(indices, a_stack
        [B, pn, pn] of ``a_dtype``, x_stack float32 [B, pn, feat])];
        ``indices`` into ``batcher.batches``."""
        groups: dict = {}
        for i, b in enumerate(batcher.batches):
            a, _ = self._dense(b, dataset, batcher.features)
            groups.setdefault(tuple(a.shape), []).append(i)
        staged = []
        for idx in groups.values():
            dense = [self._dense(batcher.batches[i], dataset) for i in idx]
            a_stack = torch.empty((len(idx),) + tuple(dense[0][0].shape), dtype=a_dtype,
                                  device=self.device)
            x_stack = torch.empty((len(idx),) + tuple(dense[0][1].shape), dtype=torch.float32,
                                  device=self.device)
            for j, (a, x) in enumerate(dense):
                a_stack[j].copy_(a)
                x_stack[j].copy_(x)
            staged.append((idx, a_stack, x_stack))
        return staged

    def _fused_bucket(self, a_stack: torch.Tensor, x_stack: torch.Tensor) -> List[torch.Tensor]:
        """One bucket's epoch as a loop over its staged batches, the A
        cast to bf16 inside the loop (the JAX scan's body)."""
        return [self._fwd(a_stack[i].to(torch.bfloat16), x_stack[i], self.weights)
                for i in range(a_stack.shape[0])]

    def _fused_epoch(self, batcher: ClusterBatcher, dataset) -> Callable[[], list]:
        """The fused epoch over the buckets staged on the device once, uint8
        adjacency, captured (:meth:`_capture`): each call is one epoch and
        returns every batch's logits in ``batcher.batches`` order (the JAX
        scan-fused baseline, ``runtime.py:1022-1078``, in one dispatch)."""
        staged = [(idx, functools.partial(self._fused_bucket, a, x))
                  for idx, a, x in self._stage(batcher, dataset, torch.uint8)]
        return self._capture_epoch(staged, len(batcher.batches))

    def run_epochs_fused(
        self,
        batcher: ClusterBatcher,
        dataset,
        n_epochs: int = 20,
        sync_every_epoch: bool = False,
    ) -> EpochStats:
        """Timed epochs of the captured fused loop (:meth:`_fused_epoch`),
        staged outside the timed region; one replay an epoch."""
        return self._run_staged(self._fused_epoch(batcher, dataset), n_epochs, len(batcher),
                                sync_every_epoch)

    def _stage_mega(self, batcher: ClusterBatcher, dataset) -> List[tuple]:
        """Stage every bucket as int8 stacks -> [(indices, fn)]: ``fn()``
        runs the bucket's epoch, one fused_baseline launch returning
        float32[B, pn, classes]. A bucket that ``fused_model.baseline_plan``
        refuses (or every bucket, when the kernel refuses the weights) runs
        through the fused loop instead (:meth:`_fused_bucket`, per-batch
        logits, captured as :meth:`_capture` says), and says so: JAX runs
        such a bucket through its scan epoch
        (``runtime.py:954-971``). Records each bucket in
        ``self.mega_buckets`` (``fallback``). Only the plan's refusal is
        caught: a launch that fails raises."""
        shapes = [tuple(w.shape) for w in self.weights]
        try:
            packed, refused = fused_model.pack_baseline_weights(self.weights), None
        except ValueError as e:
            packed, refused = None, e
        staged, self.mega_buckets = [], []
        for idx, a_stack, x_stack in self._stage(batcher, dataset, torch.int8):
            info = dict(pn=a_stack.shape[1], batches=len(idx), fallback=False)
            self.mega_buckets.append(info)
            try:
                if refused is not None:
                    raise refused
                fused_model.baseline_plan(a_stack.shape, x_stack.shape, shapes)
            except ValueError as e:
                # Loudly, as the quantized mega engine's fallback
                print(f"[mega] baseline bucket pn={info['pn']}: falling back to the fused loop "
                      f"({type(e).__name__}: {e})")
                info["fallback"] = True
                staged.append((idx, self._capture(functools.partial(self._fused_bucket, a_stack, x_stack))))
                continue
            staged.append((idx, functools.partial(
                fused_model.fused_baseline_epoch, a_stack, x_stack, self.weights, packed=packed)))
        return staged

    def _mega_logits(self, batcher: ClusterBatcher, dataset) -> List[torch.Tensor]:
        """Each batch's mega-engine logits, in ``batcher.batches`` order."""
        out: List[Optional[torch.Tensor]] = [None] * len(batcher.batches)
        for idx, fn in self._stage_mega(batcher, dataset):
            for i, logits in zip(idx, fn()):
                out[i] = logits
        return out

    def run_epochs_mega(
        self,
        batcher: ClusterBatcher,
        dataset,
        n_epochs: int = 20,
        sync_every_epoch: bool = False,
    ) -> EpochStats:
        """Timed epochs of one fused_baseline launch per bucket (the JAX
        mega baseline, the same whole-model fusion the quantized engine
        gets). Buckets are staged on the device before the timed region;
        every bucket's output is kept by the epoch."""
        fns = [fn for _, fn in self._stage_mega(batcher, dataset)]

        def one_epoch():
            return [fn() for fn in fns]

        return self._run_staged(one_epoch, n_epochs, len(batcher), sync_every_epoch)

    # -- accuracy -------------------------------------------------------

    def _logits_rows(self, batcher: ClusterBatcher, dataset):
        for batch in batcher.batches:
            logits = self.forward_batch(batch, dataset, batcher.features)
            yield batch, logits[: batch.num_nodes].cpu().numpy()

    def evaluate(self, batcher: ClusterBatcher, dataset, labels: np.ndarray) -> float:
        """Masked argmax accuracy (reference DGL ``evaluate`` role)."""
        correct = total = 0
        for batch, logits in self._logits_rows(batcher, dataset):
            correct += int((logits.argmax(axis=1) == labels[batch.nodes]).sum())
            total += batch.num_nodes
        return correct / max(total, 1)

    def evaluate_f1(self, batcher: ClusterBatcher, dataset, multilabels: np.ndarray) -> dict:
        """Multilabel micro / macro F1 (reference ``calc_f1``,
        ``utils.py:43-60``), thresholds as in ``_threshold_f1``."""
        rows, labs = [], []
        for batch, logits in self._logits_rows(batcher, dataset):
            rows.append(logits)
            labs.append(multilabels[batch.nodes])
        return _threshold_f1(np.concatenate(rows), np.concatenate(labs))


def _threshold_f1(logits: np.ndarray, labels: np.ndarray) -> dict:
    """Micro / macro F1 with per-class mean-logit thresholds: the
    reference thresholds at 0 (``utils.py:44-47``); the quantized
    engines' logits are unsigned, so the decision boundary is the
    per-class mean (a bias before the reference's threshold). Copy of the
    JAX package's function."""
    centered = logits - logits.mean(axis=0, keepdims=True)
    return {
        "f1_micro": multilabel_f1(centered, labels, "micro"),
        "f1_macro": multilabel_f1(centered, labels, "macro"),
    }


def _aligned_rows(stack: torch.Tensor, device: torch.device) -> List[torch.Tensor]:
    """A CPU stack [B, ...] on ``device`` as B views of its rows, each
    starting on a 16-byte boundary (every kernel operand's alignment,
    ``ops/_gemm._operand``: the rows of a stack of small maps would not
    all be)."""
    B, n = stack.shape[0], stack[0].numel()
    buf = torch.zeros((B, round_up(n, 16 // stack.element_size())), dtype=stack.dtype, device=device)
    buf[:, :n] = stack.reshape(B, n).to(device)
    return [buf[i, :n].view(stack.shape[1:]) for i in range(B)]


def _batch_key(batch: ClusterBatch):
    """Content-derived cache key (``id()`` would dangle if batches were
    rebuilt between warm-up and the timed run)."""
    return (batch.padded_nodes, batch.num_nodes, hash(batch.nodes.tobytes()))


def mega_chunk_occ(a_words: np.ndarray, chunk: int) -> np.ndarray:
    """Row-chunk occupancy int32[nch] of an M-packed adjacency
    [nd, pn/32, pn]: 1 where any word of the chunk's rows is nonzero.
    Copy of the JAX package's host-side builder."""
    chw = chunk // 32
    nd, mw, pn = a_words.shape
    return (a_words.reshape(nd, mw // chw, chw, pn) != 0).any(axis=(0, 2, 3)).astype(np.int32)


def mega_block_occ(a_words: np.ndarray, chunk: int, cb: int) -> np.ndarray:
    """2-D (row chunk x column block) occupancy int32[nch, pn/cb] of an
    M-packed adjacency. Copy of the JAX package's host-side builder."""
    chw = chunk // 32
    nd, mw, pn = a_words.shape
    return (
        (a_words.reshape(nd, mw // chw, chw, pn // cb, cb) != 0)
        .any(axis=(0, 2, 4))
        .astype(np.int32)
    )


def mega_block_sched(a_words: np.ndarray, chunk: int, cb: int) -> np.ndarray:
    """Occupancy-compacted block schedule int32[nch, nj+1]: per row chunk
    ``[count, j_0, j_1, ...]``, the occupied column blocks (unused tail
    slots 0). Copy of the JAX package's host-side builder."""
    occ = mega_block_occ(a_words, chunk, cb)
    nch, nj = occ.shape
    out = np.zeros((nch, nj + 1), np.int32)
    for c in range(nch):
        js = np.nonzero(occ[c])[0]
        out[c, 0] = len(js)
        out[c, 1:1 + len(js)] = js
    return out


def mega_zero_tile_gate(zerotile_jump: Optional[bool], skippable: float, pn: int, bit_width: int,
                        resident_a: Optional[bool]) -> Optional[str]:
    """The zero-block schedule a K1 bucket takes, by the JAX engine's gates:
    ``"chunk_occ"`` (its streaming tier, ``resident_a=False``: every skipped
    block saves its crossing, so the occupancy map is on at >= 30%
    skippable), ``"compact"`` (its resident kernel's gate,
    ``runtime.py:595-607``: >= 45% skippable, pn >= 2048, <= 4 bits) or
    None. ``zerotile_jump`` True forces the bucket's tier's schedule, False
    forbids it."""
    if resident_a is False:
        if zerotile_jump is True or (zerotile_jump is None and skippable >= 0.30):
            return "chunk_occ"
        return None
    if zerotile_jump is True or (zerotile_jump is None and skippable >= 0.45 and pn >= 2048
                                 and bit_width <= 4):
        return "compact"
    return None


@dataclasses.dataclass
class MegaShards:
    """One bucket staged for K1, split over devices: per shard its
    ``fused_model_epoch`` operands (``a``, ``x``, ``blk_sched``,
    ``chunk_occ``, ``packed``) on the shard's device, and ``kw``, the
    keywords every shard's launch shares."""

    a: List[torch.Tensor]
    x: List[torch.Tensor]
    blk_sched: List[Optional[torch.Tensor]]
    chunk_occ: List[Optional[torch.Tensor]]
    packed: list
    kw: dict


def plan_mega_shards(bs: Sequence[ClusterBatch], weights_on: Callable[[torch.device], list],
                     shards: Sequence[Tuple[torch.device, slice]], *, model: str, clamp_bits: int, shifts,
                     cfg: QModelConfig) -> list:
    """K1's plan (:func:`fused_model.plan`) for each shard ``(device, batch
    slice)`` of one shape bucket ``bs``. Raises ``ValueError`` where K1
    refuses a shard (its geometry; on a CUDA device also its launch plan,
    :func:`fused_model.fused_model_plan`) and nowhere else: that refusal is
    what sends a bucket to an engine's fallback. ``weights_on(device)``
    gives the weights on a device."""
    bw = cfg.bit_width
    pn, B, xshape = bs[0].padded_nodes, len(bs), bs[0].bit_X.shape
    levels = num_digits(bw) == 2
    x_shape = (1 if levels else num_digits(bw), round_up(xshape[0], LANE), round_up(xshape[1], LANE))
    geos = []
    for dev, sl in shards:
        n = len(range(B)[sl])
        geo = fused_model.plan((n, pn // 32, pn), (n,) + x_shape, weights_on(dev), clamp_bits, model, shifts,
                               cfg.out_dim, x_levels_bits=bw if levels else None)
        if dev.type == "cuda":
            fused_model.fused_model_plan(geo, model)
        geos.append(geo)
    return geos


def stage_mega_shards(bs: Sequence[ClusterBatch], a_words: torch.Tensor, x_planes: torch.Tensor,
                      weights_on: Callable[[torch.device], list], shards: Sequence[Tuple[torch.device, slice]],
                      geos: list, info: dict, prepared: dict, *, model: str, shifts, cfg: QModelConfig,
                      zerotile_jump: Optional[bool], resident_a: Optional[bool]) -> MegaShards:
    """Stage one shape bucket (``bs``, its stacked CPU ``a_words`` int32[B, 1,
    pn/32, pn] and feature planes ``x_planes``) for K1, each shard ``(device,
    batch slice)`` of ``shards`` on its device with its plan from
    :func:`plan_mega_shards` (``geos``): the single-device mega engine
    passes one shard, the mesh engine one per dp row. The zero-block
    schedule is chosen once, over the whole bucket
    (:func:`mega_zero_tile_gate`), and its rows go with their batches.
    ``info`` (the bucket's record) gets the form, the skippable share and the
    schedule; ``prepared`` caches K1's weight operands by (device, form);
    ``weights_on(device)`` gives the weights on a device. 5-8-bit features
    cross as one plane of byte levels (JAX ``runtime.py:504-516``)."""
    bw = cfg.bit_width
    pn, xshape = bs[0].padded_nodes, bs[0].bit_X.shape
    levels = num_digits(bw) == 2
    nd_x, xm, xp = 1 if levels else num_digits(bw), round_up(xshape[0], LANE), round_up(xshape[1], LANE)
    info["form"], chunk = geos[0].form, geos[0].chunk
    cb = fused_model.mega_colblock(pn)
    occ = np.stack([mega_block_occ(b.a_words.numpy(), chunk, cb) for b in bs])
    info["skippable"] = float(1.0 - occ.mean())
    gate = mega_zero_tile_gate(zerotile_jump, info["skippable"], pn, bw, resident_a)
    info["chunk_occ"], info["compact"] = gate == "chunk_occ", gate == "compact"
    sched = None
    if gate == "compact":
        sched = torch.from_numpy(np.stack([mega_block_sched(b.a_words.numpy(), chunk, cb) for b in bs]))
    st = MegaShards([], [], [], [], [], dict(model=model, shifts=shifts, out_cols=cfg.out_dim, x_cols=cfg.in_dim,
                                              x_levels_bits=bw if levels else None))
    for (dev, sl), geo in zip(shards, geos):
        key = (dev, geo.form == "signed")
        if key not in prepared:
            prepared[key] = fused_model.pack_mega_weights(weights_on(dev), geo.form)
        st.packed.append(prepared[key])
        st.a.append(a_words[sl, 0].to(dev).contiguous())
        planes = x_planes[sl]
        x_stack = torch.empty((planes.shape[0], nd_x, xm, xp), dtype=torch.int8, device=dev)
        for i in range(0, planes.shape[0], 16):  # bounds the unpack intermediate
            d = planes_stack_to_digits(planes[i:i + 16].to(dev), xshape, bw)
            if levels:  # the 2 digit planes collapse to one plane of byte levels
                d = (d[:, :1].to(torch.int32) | (d[:, 1:].to(torch.int32) << 4)).to(torch.uint8).view(torch.int8)
            x_stack[i:i + 16] = d
        st.x.append(x_stack)
        st.blk_sched.append(None if sched is None else sched[sl].to(dev))
        st.chunk_occ.append(torch.from_numpy(occ[sl]).to(dev) if gate == "chunk_occ" else None)
    return st
