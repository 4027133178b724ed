"""Quantization-aware fp32 training for the quantized inference engines.

Counterpart of ``qgtc_ppopp22_tpu/models/train.py``. The reference never
trains: its benchmark weights are ``torch.ones`` (``main_qgtc.py:100-102``)
and its quantized layers have no backward (``QGTC_conv.py:24-27``). This
module trains a float32 *twin* of the quantized dataflow whose activation
is the quantizer's clamp (``clip(h, 0, 2^bits)``, what the fused requantize
epilogue applies, ``kernel.h:347-351``), with every weight projected into
the quantizer's range after each step. The trained weights go straight into
:class:`QGTCEngine` (``set_float_weights``) at 1-8 bits, and
:func:`save_checkpoint` writes them in the JAX package's npz format, which
the CLI's ``--weights`` deploys.

With ``ste=True`` the twin's forward computes the deployed engine's exact
integer semantics in float32: levels and their sums are integers, exact
while every sum stays below 2^24. So the products must run at full float32
precision: on a CUDA device :func:`train_float_twin` refuses TF32 matmuls.
Each epoch steps through the batches bucket by bucket, in the order each
``padded_nodes`` first appears, as the JAX scan does; the adjacency stacks
stay uint8 on the device and each step casts its batch to float32.

Entry points run on ``device`` (CUDA unless the caller asks for the CPU)
and return weights as CPU float32 tensors.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from qgtc_ppopp22_tpu_torch.graph.batching import ClusterBatcher, batch_labels
from qgtc_ppopp22_tpu_torch.graph.datasets import GraphDataset
from qgtc_ppopp22_tpu_torch.models.golden import quantize_np
from qgtc_ppopp22_tpu_torch.models.qmodels import QModelConfig, init_weights
from qgtc_ppopp22_tpu_torch.runtime import QGTCEngine


def _device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist and run
    float32 matmuls at full precision (TF32 would round the twin's integer
    sums, and the twin would no longer equal the engine)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not available")
        if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
            raise RuntimeError("the twin needs full float32 matmuls: TF32 is allowed "
                               f"(float32 matmul precision {torch.get_float32_matmul_precision()!r})")
    return dev


def _f32(w) -> torch.Tensor:
    """A weight (torch tensor or array) as a CPU float32 tensor."""
    if isinstance(w, torch.Tensor):
        return w.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.array(w, dtype=np.float32))


def _np(w) -> np.ndarray:
    return _f32(w).numpy()


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: its value, and its gradient, which is split in halves
    where ``x`` equals a bound (``torch.clamp`` passes all of it there, and
    levels sit on the bounds often: a projected weight at 0, an accumulator
    at ``2^bits``)."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def _ste(exact: torch.Tensor, smooth: torch.Tensor) -> torch.Tensor:
    """Straight-through: forward value ``exact``, gradient of ``smooth``
    (JAX's ``smooth + stop_gradient(exact - smooth)``, the same float32
    operations in the same order)."""
    return smooth + (exact - smooth).detach()


def _quantize_ste(x: torch.Tensor, bit_width: int) -> torch.Tensor:
    """Input quantizer with STE (reference ``Quantize_val`` semantics,
    including the level-``2^bits``-wraps-to-0 pack behaviour)."""
    ub = float(1 << bit_width)
    clipped = torch.where(x < 0.0, 1.0, torch.where(x > ub, ub - 1.0, x))
    r = torch.round(clipped)
    r = torch.where(r == ub, 0.0, r)
    return _ste(r, _clip(x, 0.0, ub))


def _requant_ste(acc: torch.Tensor, bit_width: int, s: int) -> torch.Tensor:
    """Requantize with STE: forward is the exact integer epilogue
    (floor-shift, clamp, 2^bits wrap: ``kernel.h:347-351`` and the pack's
    wrap), gradient the smooth ``clip(acc / 2^s, 0, 2^bits)``."""
    ub = float(1 << bit_width)
    scaled = acc / float(1 << s)
    r = torch.floor(scaled)
    r = torch.where(r > ub, ub - 1.0, torch.where(r < 0.0, 1.0, r))
    r = torch.where(r == ub, 0.0, r)  # pack keeps low bits: 2^b wraps
    return _ste(r, _clip(scaled, 0.0, ub))


def _weights_ste(ws, bit_width: int):
    """Weight quantizer with STE (the inputs' semantics)."""
    return [_quantize_ste(w, bit_width) for w in ws]


def float_twin_forward(
    a: torch.Tensor,
    x: torch.Tensor,
    ws: Sequence[torch.Tensor],
    bit_width: int,
    model: str = "gcn",
    shifts: Optional[Sequence[int]] = None,
    ste: bool = True,
) -> torch.Tensor:
    """Trainable forward of the quantized dataflow: float32 ``a`` [pn, pn]
    (0/1), ``x`` [pn, feat] and weights, all on one device.

    With ``ste=True`` (default) the forward value is the deployed engine's
    exact integer result (weights and inputs rounded to levels, every
    accumulator floor-shifted, clamped and wrapped as the fused epilogue
    does) while gradients flow through smooth surrogates, so training
    accuracy is deployed accuracy. That holds while each product's sums stay
    below 2^24, where float32 stops being exact: levels reach 255 at 8
    bits, so an 8-bit update passes it just above 256 features (258 x
    255^2 > 2^24). ``ste=False`` gives the fully smooth relaxation.
    """
    ub = float(1 << bit_width)
    n_layers = len(ws)
    sh = iter(list(shifts) if shifts is not None else [0] * (2 * n_layers - 1))

    def rq(hacc):
        s = next(sh)
        if ste:
            return _requant_ste(hacc, bit_width, s)
        return _clip(hacc / float(1 << s), 0.0, ub)

    if ste:
        ws = _weights_ste(ws, bit_width)
        x = _quantize_ste(x, bit_width)
    h = x
    if model == "gcn":
        for l, w in enumerate(ws):
            h = rq(h @ w)
            if l < n_layers - 1:
                h = rq(a @ h)
        return a @ h
    h = rq(a @ x)
    for w in ws[:-1]:
        h = rq(h @ w)
        h = rq(a @ h)
    return h @ ws[-1]


def calibrate_shifts(
    dataset: GraphDataset,
    batcher: ClusterBatcher,
    qws: Sequence[np.ndarray],
    bit_width: int,
    model: str = "gcn",
    percentile: float = 99.0,
    max_batches: int = 2,
) -> List[int]:
    """Power-of-two requant scales from integer-forward statistics (NumPy;
    a copy of the JAX function).

    Runs the exact integer dataflow on the first ``max_batches`` batches;
    at each requant point picks ``s = max(0, round(log2(p99(acc) /
    2^bits)))`` so the clamp range is exercised instead of saturated.
    Returns the ``shifts`` list the quantized forwards take.
    """
    ub = 1 << bit_width
    n_layers = len(qws)
    shifts = [0] * (2 * n_layers - 1)
    mask_lv = (1 << bit_width) - 1

    def requant(acc, s):
        r = acc >> s
        r = np.where(r > ub, ub - 1, np.where(r < 0, 1, r))
        return r & mask_lv

    for b in batcher.batches[:max_batches]:
        qa = dataset.graph.subgraph_dense(b.nodes).astype(np.int64)
        qx = quantize_np(batcher.features[b.nodes], bit_width).astype(np.int64) & mask_lv
        si = 0

        def point(acc):
            nonlocal si
            q = float(np.percentile(acc, percentile))
            s = max(0, int(round(np.log2(max(q, 1) / ub)))) if q > ub else 0
            shifts[si] = max(shifts[si], s)
            out = requant(acc, shifts[si])
            si += 1
            return out

        h = qx
        if model == "gcn":
            for l, w in enumerate(qws):
                h = point(h @ (np.asarray(w, np.int64) & mask_lv))
                if l < n_layers - 1:
                    h = point(qa @ h)
        else:
            h = point(qa @ qx)
            for w in qws[:-1]:
                h = point(h @ (np.asarray(w, np.int64) & mask_lv))
                h = point(qa @ h)
    return shifts


def _dense_batch(dataset: GraphDataset, batcher: ClusterBatcher, b, dtype=np.float32) -> tuple:
    """One batch's dense (a [pn, pn] of ``dtype``, x float32 [pn, feat],
    labels, mask) on the host, zero-padded to ``padded_nodes``."""
    n, pn = b.num_nodes, b.padded_nodes
    a = np.zeros((pn, pn), dtype)
    a[:n, :n] = dataset.graph.subgraph_dense(b.nodes)
    x = np.zeros((pn, batcher.feat_dim), np.float32)
    x[:n] = batcher.features[b.nodes]
    labels, mask = batch_labels(dataset, b)
    return a, x, labels, mask


def _dense_batches(dataset: GraphDataset, batcher: ClusterBatcher):
    """Every batch's :func:`_dense_batch`, in ``batcher.batches`` order."""
    return [_dense_batch(dataset, batcher, b) for b in batcher.batches]


def float_twin_logits(
    dataset: GraphDataset,
    batcher: ClusterBatcher,
    ws: Sequence,
    bit_width: int,
    model: str = "gcn",
    shifts: Optional[Sequence[int]] = None,
    device="cuda",
) -> List[torch.Tensor]:
    """The STE twin's logits [pn, classes] of every batch on ``device``, in
    ``batcher.batches`` order, one batch's float32 adjacency at a time: the
    logits the deployed engine must reproduce exactly."""
    dev = _device(device)
    wd = [_f32(w).to(dev) for w in ws]
    out = []
    with torch.no_grad():
        for b in batcher.batches:
            a, x, _, _ = _dense_batch(dataset, batcher, b, np.uint8)
            out.append(float_twin_forward(torch.from_numpy(a).to(dev).float(), torch.from_numpy(x).to(dev),
                                          wd, bit_width, model, shifts))
    return out


def _grouped_stacks(
    dataset: GraphDataset,
    batcher: ClusterBatcher,
    multilabel: bool = False,
    device="cpu",
) -> List[tuple]:
    """Dense batches stacked per shape bucket on ``device`` -> [(A uint8[B,
    pn, pn], X float32[B, pn, feat], L, M float32[B, pn])], buckets in the
    order each ``padded_nodes`` first appears, batches in batcher order
    (the JAX scan's visit order). A stays uint8: a whole epoch's dense A
    in float32 would be gigabytes at large buckets. ``L`` is int64[B, pn]
    labels, or with ``multilabel`` the float32[B, pn, C] multilabel matrix
    (ppi's ``calc_f1`` task, reference ``utils.py:43-60``). Each batch is
    copied into the device stacks on its own."""
    groups: dict = {}
    for b in batcher.batches:
        groups.setdefault(b.padded_nodes, []).append(b)
    out = []
    for pn, bs in groups.items():
        B = len(bs)
        A = torch.empty((B, pn, pn), dtype=torch.uint8, device=device)
        X = torch.empty((B, pn, batcher.feat_dim), dtype=torch.float32, device=device)
        if multilabel:
            L = torch.zeros((B, pn, dataset.multilabels.shape[1]), dtype=torch.float32, device=device)
        else:
            L = torch.empty((B, pn), dtype=torch.int64, device=device)
        M = torch.empty((B, pn), dtype=torch.float32, device=device)
        for i, b in enumerate(bs):
            a, x, labels, mask = _dense_batch(dataset, batcher, b, np.uint8)
            A[i].copy_(torch.from_numpy(a))
            X[i].copy_(torch.from_numpy(x))
            if multilabel:
                L[i, :b.num_nodes].copy_(torch.from_numpy(dataset.multilabels[b.nodes].astype(np.float32)))
            else:
                L[i].copy_(torch.from_numpy(labels))
            M[i].copy_(torch.from_numpy(mask.astype(np.float32)))
        out.append((A, X, L, M))
    return out


def _class_mean(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked per-class mean logit, detached: the deployment threshold
    (``runtime._threshold_f1``)."""
    return ((logits * mask[:, None]).sum(dim=0) / torch.clamp(mask.sum(), min=1.0)).detach()


def batch_loss(
    ws: Sequence[torch.Tensor],
    a: torch.Tensor,
    x: torch.Tensor,
    labels: torch.Tensor,
    mask: torch.Tensor,
    bit_width: int,
    model: str = "gcn",
    shifts: Optional[Sequence[int]] = None,
    ste: bool = True,
    multilabel: bool = False,
) -> torch.Tensor:
    """One batch's training loss (JAX ``train_float_twin``'s ``batch_loss``):
    softmax NLL, or with ``multilabel`` per-class sigmoid BCE on centred
    logits, masked to the real rows. The logits are divided by a detached
    temperature, their population std (at least 1), for the loss only:
    integer-domain logits reach thousands and would saturate the
    softmax's and the sigmoid's gradients."""
    logits = float_twin_forward(a, x, ws, bit_width, model, shifts, ste=ste)
    tau = torch.clamp(logits.detach().std(correction=0), min=1.0)
    msum = torch.clamp(mask.sum(), min=1.0)
    if multilabel:
        z = (logits - _class_mean(logits, mask)[None, :]) / tau
        bce = F.binary_cross_entropy_with_logits(z, labels, reduction="none")
        return (bce.mean(dim=-1) * mask).sum() / msum
    logp = torch.log_softmax(logits / tau, dim=-1)
    nll = -logp.gather(1, labels[:, None])[:, 0]
    return (nll * mask).sum() / msum


def train_float_twin(
    dataset: GraphDataset,
    batcher: ClusterBatcher,
    cfg: QModelConfig,
    model: str = "gcn",
    epochs: int = 30,
    lr: float = 5e-3,
    seed: int = 0,
    shifts: Optional[Sequence[int]] = None,
    ste: bool = True,
    init_ws: Optional[Sequence] = None,
    verbose: bool = False,
    multilabel: bool = False,
    device="cuda",
) -> Tuple[List[torch.Tensor], float]:
    """Train the fp32 twin on ``device``; returns (weights as CPU float32
    tensors, final train metric).

    One Adam step (optax's defaults: betas 0.9 / 0.999, eps 1e-8) a batch,
    each followed by the projection of every weight into ``[0, 2^bits -
    0.51]``: a weight that rounds to level ``2^bits`` would wrap to 0 at
    pack time (``kernel.h:226-229``). With ``ste=True`` the metric is the
    deployed quantized one (the forward is integer-exact). ``init_ws``
    warm-starts; otherwise weights are drawn from ``seed``. With
    ``multilabel`` the loss is per-class BCE on centred logits and the
    metric micro-F1 at the per-class-mean threshold (the deployment
    threshold of ``evaluate_f1``: the unsigned weight lattice has no bias,
    so a threshold at 0, the reference ``calc_f1``'s, would label
    everything positive)."""
    dev = _device(device)
    if init_ws is None:
        init_ws = init_weights(torch.Generator().manual_seed(seed), cfg, scale=0.25)
    ws = [_f32(w).to(dev).clone().requires_grad_(True) for w in init_ws]  # the caller's stay as they are
    ub = float(1 << cfg.bit_width)
    opt = torch.optim.Adam(ws, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    kw = dict(bit_width=cfg.bit_width, model=model, shifts=shifts, ste=ste)
    groups = _grouped_stacks(dataset, batcher, multilabel, dev)
    n_batches = sum(g[0].shape[0] for g in groups)
    for ep in range(epochs):
        total = torch.zeros((), device=dev)
        for A, X, L, M in groups:
            for i in range(A.shape[0]):
                opt.zero_grad(set_to_none=True)
                loss = batch_loss(ws, A[i].float(), X[i], L[i], M[i], multilabel=multilabel, **kw)
                loss.backward()
                opt.step()
                with torch.no_grad():
                    for w in ws:
                        w.clamp_(0.0, ub - 0.51)
                total += loss.detach()
        if verbose:
            print(f"epoch {ep}: loss {float(total) / n_batches:.4f}")

    with torch.no_grad():
        counts = torch.zeros(3, device=dev)  # correct, total; or tp, fp, fn
        for A, X, L, M in groups:
            for i in range(A.shape[0]):
                logits = float_twin_forward(A[i].float(), X[i], ws, **kw)
                if multilabel:
                    pred = (logits > _class_mean(logits, M[i])[None, :]).float()
                    m = M[i][:, None]
                    counts += torch.stack([(pred * L[i] * m).sum(), (pred * (1 - L[i]) * m).sum(),
                                           ((1 - pred) * L[i] * m).sum()])
                else:
                    hit = (logits.argmax(dim=-1) == L[i]).float() * M[i]
                    counts[:2] += torch.stack([hit.sum(), M[i].sum()])
        c = counts.tolist()
    if multilabel:
        metric = 2 * c[0] / max(2 * c[0] + c[1] + c[2], 1e-9)
    else:
        metric = c[0] / max(c[1], 1.0)
    return [w.detach().cpu() for w in ws], metric


def _deployed(
    batcher: ClusterBatcher, num_classes: int, ws: Sequence, bit_width: int, model: str,
    shifts, clamp_bits, quant_bits, device,
) -> QGTCEngine:
    """The real quantized engine on ``device`` running ``ws``."""
    eng = QGTCEngine(
        feat_dim=batcher.feat_dim, num_classes=num_classes, model=model, bit_width=bit_width,
        hidden=ws[0].shape[1] if len(ws) > 1 else 16, num_layers=len(ws), shifts=shifts,
        clamp_bits=clamp_bits, device=device,
    )
    eng.set_float_weights([_f32(w) for w in ws], quant_bits=quant_bits)
    return eng


def quantized_accuracy(
    dataset: GraphDataset,
    batcher: ClusterBatcher,
    ws: Sequence,
    bit_width: int,
    model: str = "gcn",
    shifts: Optional[Sequence[int]] = None,
    clamp_bits: Optional[int] = None,
    quant_bits: Optional[int] = None,
    device="cuda",
    mode: str = "step",
) -> float:
    """Accuracy of the real quantized engine with the given weights, its
    logits from ``mode``'s engine (``QGTCEngine.evaluate``: ``"step"``,
    K2 and K3; ``"fused"``; ``"mega"``, K1 a bucket).

    ``clamp_bits`` / ``quant_bits`` (default ``bit_width``) narrow the
    requant clamp and the weight quantization grid below the datapath
    width: the exact-emulation deployment of a lower-bit model on a wider
    engine (:func:`qat_ladder`)."""
    eng = _deployed(batcher, dataset.num_classes, ws, bit_width, model, shifts, clamp_bits, quant_bits, device)
    return eng.evaluate(batcher, dataset.labels, mode=mode)


def quantized_f1(
    dataset: GraphDataset,
    batcher: ClusterBatcher,
    ws: Sequence,
    bit_width: int,
    model: str = "gcn",
    shifts: Optional[Sequence[int]] = None,
    clamp_bits: Optional[int] = None,
    quant_bits: Optional[int] = None,
    device="cuda",
    mode: str = "step",
) -> dict:
    """Deployed multilabel micro / macro F1 of the real quantized engine
    (reference ``calc_f1`` role, ``utils.py:43-50``; ppi); arguments as in
    :func:`quantized_accuracy`."""
    eng = _deployed(batcher, dataset.multilabels.shape[1], ws, bit_width, model, shifts, clamp_bits,
                    quant_bits, device)
    return eng.evaluate_f1(batcher, dataset.multilabels, mode=mode)


def _spread_weights(ws, shifts, bit_width: int, model: str):
    """Rescale each weight matrix by a power of two (compensated in the
    requant shift that follows its multiply) so the representable levels
    are exercised: 1-bit weights trained smoothly tend to sit below the 0.5
    rounding threshold and would all quantize to 0. Neutral for the smooth
    model; argmax-neutral where the multiply feeds the float output."""
    ub = (1 << bit_width) - 0.51
    ws2, sh2 = list(ws), list(shifts)
    if bit_width > 2:
        # At >= 3 bits the level grid is fine enough that rounding to zero
        # is not a failure mode, and inflating the shifts costs accuracy.
        return ws2, sh2
    n = len(ws2)
    for l, w in enumerate(ws2):
        wmax = float(torch.max(w)) + 1e-9
        k = int(np.floor(np.log2(max(ub * 0.75 / wmax, 1.0))))
        if k <= 0:
            continue
        if model == "gcn":
            pt = 2 * l
        else:  # gin: agg first; the last weight feeds f32 logits directly
            pt = 2 * l + 1 if l < n - 1 else None
        ws2[l] = torch.clamp(w * float(2 ** k), 0.0, ub)
        if pt is not None:
            sh2[pt] += k
    return ws2, sh2


def qat_train(
    dataset: GraphDataset,
    batcher: ClusterBatcher,
    cfg: QModelConfig,
    model: str = "gcn",
    smooth_epochs: int = 25,
    ste_epochs: int = 20,
    lr: float = 1e-2,
    seed: int = 0,
    verbose: bool = False,
    multilabel: bool = False,
    init_ws: Optional[Sequence] = None,
    device="cuda",
) -> Tuple[List[torch.Tensor], List[int], float]:
    """The full QAT recipe on ``device`` -> (weights, shifts, deployed
    metric):

    1. smooth pretrain (continuous clamp surrogate),
    2. calibrate power-of-two requant shifts on the quantized weights,
    3. STE fine-tune (integer-exact forward),
    4. recalibrate and a short STE fine-tune if the shifts moved.

    ``init_ws`` replaces the weights drawn from ``seed`` (``init_weights``
    at scale 0.25), so that two implementations can start from the same
    weights."""

    def q(ws):
        return [quantize_np(_np(w), cfg.bit_width) for w in ws]

    # Shifts are calibrated before any training: an uncalibrated smooth
    # phase saturates and learns nothing to warm-start from.
    ws0 = ([_f32(w) for w in init_ws] if init_ws is not None
           else init_weights(torch.Generator().manual_seed(seed), cfg, scale=0.25))
    # Adam's step size is absolute and the weight range is [0, 2^bits]:
    # scale the lr with the level range, or high-bit weights never move.
    lr = lr * max(1.0, (1 << cfg.bit_width) / 8.0)
    shifts = calibrate_shifts(dataset, batcher, q(ws0), cfg.bit_width, model)
    kw = dict(model=model, seed=seed, verbose=verbose, multilabel=multilabel, device=device)
    ws, _ = train_float_twin(dataset, batcher, cfg, epochs=smooth_epochs, lr=lr, shifts=shifts, ste=False,
                             init_ws=ws0, **kw)
    # Spread the weights over the levels (shift-compensated), recalibrate on
    # the trained scale, and give the smooth phase one more round before
    # STE hardening.
    ws, shifts = _spread_weights(ws, shifts, cfg.bit_width, model)
    ws, _ = train_float_twin(dataset, batcher, cfg, epochs=smooth_epochs // 2, lr=lr, shifts=shifts,
                             ste=False, init_ws=ws, **kw)
    ws, shifts = _spread_weights(ws, shifts, cfg.bit_width, model)
    ws, acc = train_float_twin(dataset, batcher, cfg, epochs=ste_epochs, lr=lr / 2, shifts=shifts, ste=True,
                               init_ws=ws, **kw)
    shifts2 = calibrate_shifts(dataset, batcher, q(ws), cfg.bit_width, model)
    if shifts2 != shifts:
        ws, acc = train_float_twin(dataset, batcher, cfg, epochs=ste_epochs // 2, lr=lr / 4, shifts=shifts2,
                                   ste=True, init_ws=ws, **kw)
        shifts = shifts2
    return ws, shifts, acc


def ladder_feature_scale(bits: int) -> float:
    """Per-bit-width input pre-scale of :func:`qat_ladder`: ``2^(bits-2)``
    (identity at <= 2 bits). The reference's level grid is the integers
    over [0, 2^bits] (``kernel.h:31-71``), and unscaled features occupy
    only its bottom levels at wide widths; the scale spreads them over the
    grid and makes a carried lower-bit solution exactly shift-compensable."""
    return float(1 << max(bits - 2, 0))


def qat_ladder(
    dataset: GraphDataset,
    make_batcher,
    bits_list: Sequence[int],
    model: str = "gcn",
    hidden: int = 16,
    num_layers: int = 3,
    seeds: Sequence[int] = (0, 1, 2),
    ste_epochs: int = 10,
    verbose: bool = False,
    metric: str = "accuracy",
    lrs: Sequence[float] = (1e-2,),
    device="cuda",
) -> List[dict]:
    """Monotone accuracy frontier: QAT with bit-width laddering (JAX
    ``qat_ladder``). In the reference's quantizer the level grid is always
    the integers and only the range grows with the bits, so a wider engine
    can run a narrower solution verbatim. Each bit width keeps the best
    deployed metric of:

    1. fresh QAT per lr and seed (:func:`qat_train`),
    2. the previous winner's weights and shifts in this width's engine
       ("carried"; with the first shift grown by the feature scale's ratio,
       "collapsed"),
    3. each of those STE-fine-tuned at this width,
    4. the exact emulation of the previous winner: its inputs and weights
       on its native grid (``quant_bits``) and the requant clamp at its
       native width (``clamp_bits``), which reproduces its logits on this
       width's datapath, so the frontier is monotone by construction; an
       emulation below the previous row raises ``AssertionError``.

    ``make_batcher(bits, feature_scale, quant_bits=None)`` builds a width's
    batcher; the ladder passes :func:`ladder_feature_scale`. Returns one row
    dict per bit width, ascending: JAX's keys, and ``emulated``, the exact
    emulation's metric (None in the first row), which equals the previous
    row's. ``metric='f1'``: candidates train the
    BCE twin and are compared by the deployed engine's micro-F1, macro-F1
    recorded beside it. Training and deployment run on ``device``."""
    ml = metric == "f1"

    def _eval(it_, ws_, sh_, clamp_bits=None, quant_bits=None):
        if ml:
            return quantized_f1(dataset, it_, ws_, it_.bit_width, model, shifts=sh_, clamp_bits=clamp_bits,
                                quant_bits=quant_bits, device=device)["f1_micro"]
        return quantized_accuracy(dataset, it_, ws_, it_.bit_width, model, shifts=sh_, clamp_bits=clamp_bits,
                                  quant_bits=quant_bits, device=device)

    def _twin(it_, cfg_, **kw):
        return train_float_twin(dataset, it_, cfg_, model, verbose=verbose, multilabel=ml, device=device, **kw)

    rows = []
    prev = None  # (bits, ws, shifts, acc, native_bits)
    for bits in sorted(bits_list):
        acc_emu = None
        it = make_batcher(bits, ladder_feature_scale(bits))
        cfg = QModelConfig(it.feat_dim, hidden, dataset.num_classes, bit_width=bits, num_layers=num_layers)
        candidates = []  # (acc, ws, shifts, how, native_bits)
        # Fresh QAT is high-variance at wide widths, so the fresh pool
        # sweeps lr x seed and the ladder keeps the best deployed metric.
        for lr0 in lrs:
            for seed in seeds:
                ws, sh, acc = qat_train(dataset, it, cfg, model=model, seed=seed, verbose=verbose,
                                        multilabel=ml, lr=lr0, device=device)
                if ml:  # compared by the deployed engine's micro-F1
                    acc = _eval(it, ws, sh)
                tag = f"fresh(seed={seed})" if len(lrs) == 1 else f"fresh(seed={seed},lr={lr0:g})"
                candidates.append((acc, ws, sh, tag, bits))
        if prev is not None:
            p_bits, p_ws, p_sh, p_acc, p_native = prev
            # Two carry schedules for the lower-bit winner: the same shifts
            # ("carried": with the 2^delta feature scale every intermediate
            # runs at 2^delta times its lower-bit value against a 2^delta
            # wider clamp, the same relative saturation), and +delta on the
            # first shift ("collapsed": intermediates back on the lower-bit
            # range, so the wider clamp never saturates).
            delta = int(np.log2(ladder_feature_scale(bits) / ladder_feature_scale(p_bits)))
            carry_schedules = [(list(p_sh), "carried")]
            if delta:
                carry_schedules.append(([p_sh[0] + delta] + list(p_sh[1:]), "collapsed"))
            for c_sh, tag in carry_schedules:
                candidates.append((_eval(it, p_ws, c_sh), p_ws, c_sh, tag, bits))
                ws_ft, acc_ft = _twin(it, cfg, epochs=ste_epochs, lr=5e-3, shifts=c_sh, ste=True, init_ws=p_ws)
                if ml:
                    acc_ft = _eval(it, ws_ft, list(c_sh))
                candidates.append((acc_ft, ws_ft, list(c_sh), f"{tag}+ste", bits))
            # Exact emulation: the wider datapath runs the previous winner
            # verbatim, bit-exact to the previous row's deployment, so its
            # metric equals the previous row's by construction.
            try:
                it_emu = make_batcher(bits, ladder_feature_scale(p_native), quant_bits=p_native)
            except TypeError:
                it_emu = None  # a factory without quant_bits
            if it_emu is not None:
                acc_emu = _eval(it_emu, p_ws, list(p_sh), clamp_bits=p_native, quant_bits=p_native)
                if acc_emu < p_acc - 1e-9:
                    raise AssertionError(f"exact emulation broke: {acc_emu} < {p_acc} "
                                         f"(native {p_native}b on a {bits}b datapath)")
                candidates.append((acc_emu, p_ws, list(p_sh), f"emulated({p_native}b)", p_native))
        acc, ws, sh, how, native = max(candidates, key=lambda c: c[0])
        if prev is not None and acc < prev[3] - 1e-6:
            # Dip rescue: re-adapt the carried schedule with a smooth
            # phase before STE hardening.
            c_sh = list(p_sh)
            ws_s, _ = _twin(it, cfg, epochs=ste_epochs, lr=5e-3, shifts=c_sh, ste=False, init_ws=p_ws)
            ws_r, acc_r = _twin(it, cfg, epochs=ste_epochs + 5, lr=2e-3, shifts=c_sh, ste=True, init_ws=ws_s)
            if ml:
                acc_r = _eval(it, ws_r, list(c_sh))
            candidates.append((acc_r, ws_r, list(c_sh), "carried+smooth+ste", bits))
            acc, ws, sh, how, native = max(candidates, key=lambda c: c[0])
        prev = (bits, ws, sh, acc, native)
        row = dict(model=model, bits=bits, accuracy=round(float(acc), 4),
                   chance=round(1.0 / dataset.num_classes, 4), shifts="/".join(map(str, sh)), winner=how,
                   emulated=None if acc_emu is None else round(float(acc_emu), 4))
        if ml:
            narrow = native if native != bits else None
            full = quantized_f1(dataset, make_batcher(bits, ladder_feature_scale(native), quant_bits=narrow),
                                ws, bits, model, shifts=list(sh), clamp_bits=narrow, quant_bits=narrow,
                                device=device)
            row["metric"] = "deployed micro-F1 (accuracy col)"
            row["f1_micro"] = round(full["f1_micro"], 4)
            row["f1_macro"] = round(full["f1_macro"], 4)
        rows.append(row)
        if verbose:
            print(rows[-1], flush=True)
    return rows


def save_checkpoint(
    path: str,
    ws: Sequence,
    shifts: Sequence[int],
    cfg: QModelConfig,
    model: str = "gcn",
) -> None:
    """Write trained float weights, requant shifts and the config as the
    JAX package's npz (``models/train.py:782-808``), which either package
    loads. The reference has no model persistence (inference only,
    ones weights)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(
        path,
        n_weights=len(ws),
        shifts=np.asarray(shifts, np.int64),
        model=model,
        bit_width=cfg.bit_width,
        in_dim=cfg.in_dim,
        hidden=cfg.hidden,
        out_dim=cfg.out_dim,
        num_layers=cfg.num_layers,
        **{f"w{i}": _np(w) for i, w in enumerate(ws)},
    )


def load_checkpoint(path: str) -> Tuple[List[torch.Tensor], List[int], QModelConfig, str]:
    """-> (weights as CPU float32 tensors, shifts, config, model) from a
    checkpoint either package's ``save_checkpoint`` wrote."""
    with np.load(path, allow_pickle=False) as z:
        ws = [_f32(z[f"w{i}"]) for i in range(int(z["n_weights"]))]
        shifts = [int(x) for x in z["shifts"]]
        cfg = QModelConfig(in_dim=int(z["in_dim"]), hidden=int(z["hidden"]), out_dim=int(z["out_dim"]),
                           bit_width=int(z["bit_width"]), num_layers=int(z["num_layers"]))
        model = str(z["model"])
    return ws, shifts, cfg, model
