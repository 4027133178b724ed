"""Plain reference of the quantized Cluster-GCN and batched GIN, in PyTorch.

It imports nothing of the port and nothing of JAX, and takes nothing the
program made: from the benchmark's own graph, features and float weights it
rebuilds each batch's dense adjacency, quantizes the features and weights
itself, and runs the integer chain in float64 (every value an integer far
below 2^53, so the arithmetic is exact on any device and no TF32 applies).

The rules are frozen copies of the port's:

* :func:`quantize` is ``qgtc_ppopp22_tpu_torch/ops/quantize.py:24-31`` (and
  ``models/golden.py:22-27``): below 0 becomes 1, above 2^bits becomes
  2^bits - 1, then round half to even;
* :func:`requantize` is ``ops/quantize.py:34-62``'s ``requantize_wrapped``
  with no shift: above 2^bits becomes 2^bits - 1, below 0 becomes 1, then
  the low ``bits`` bits are kept (2^bits wraps to 0, as the packer does);
* the levels a GEMM reads are the low ``bits`` bits of each operand
  (``models/golden.py:30-31``);
* the chains are ``models/qmodels.py:162-207`` (``qgcn_forward``,
  ``qgin_forward``): GCN ``XW1 -> A(.) -> (.)W2 -> A(.) -> (.)W3 -> A(.)``, GIN
  ``AX -> (.)W1 -> A(.) -> (.)W2 -> A(.) -> (.)W3``, every product requantized
  but the last, which is returned as it is.
"""

from __future__ import annotations

from typing import Iterator, Sequence, Tuple

import numpy as np
import torch


def quantize(x: torch.Tensor, bits: int) -> torch.Tensor:
    """float -> the levels a GEMM reads (float64)."""
    ub = float(1 << bits)
    x = x.to(torch.float32)
    one = torch.ones_like(x)
    clipped = torch.where(x < 0.0, one, torch.where(x > ub, one * (ub - 1.0), x))
    return (torch.round(clipped).to(torch.int64) & ((1 << bits) - 1)).to(torch.float64)


def requantize(acc: torch.Tensor, bits: int) -> torch.Tensor:
    ub = float(1 << bits)
    r = torch.where(acc > ub, torch.full_like(acc, ub - 1.0), torch.where(acc < 0, torch.ones_like(acc), acc))
    return (r.to(torch.int64) & ((1 << bits) - 1)).to(torch.float64)


def forward(model: str, a: torch.Tensor, qx: torch.Tensor, qws: Sequence[torch.Tensor], bits: int) -> torch.Tensor:
    """Logits float64[n, classes] of one batch: ``a`` its 0/1 adjacency,
    ``qx`` and ``qws`` the feature and weight levels."""
    if model == "gcn":
        h = qx
        for l, w in enumerate(qws):
            h = requantize(h @ w, bits)
            if l < len(qws) - 1:
                h = requantize(a @ h, bits)
        return a @ h
    if model == "gin":
        h = requantize(a @ qx, bits)
        for w in qws[:-1]:
            h = requantize(h @ w, bits)
            h = requantize(a @ h, bits)
        return h @ qws[-1]
    raise ValueError(f"unknown model {model!r}")


def batch_logits(indptr: np.ndarray, indices: np.ndarray, features: np.ndarray,
                 float_weights: Sequence[torch.Tensor], cfg: dict, batches: Sequence[np.ndarray],
                 device: torch.device) -> Iterator[Tuple[int, torch.Tensor]]:
    """``(i, logits float64[len(batches[i]), classes])`` for every batch,
    one at a time: ``batches[i]`` is the batch's node ids in its row order,
    its adjacency ``A[r, c] = 1`` where an edge runs from node ``c`` into node
    ``r``. The edges of all batches are sorted out once, on ``device``; a node
    that two batches list is given to the later one."""
    bits = int(cfg["bit_width"])
    n_all = len(indptr) - 1
    owner = torch.full((n_all,), -1, dtype=torch.int64, device=device)
    pos = torch.full((n_all,), -1, dtype=torch.int64, device=device)
    for i, nodes in enumerate(batches):
        idx = torch.from_numpy(np.asarray(nodes, np.int64)).to(device)
        owner[idx] = i
        pos[idx] = torch.arange(len(idx), device=device)
    ip = torch.from_numpy(np.asarray(indptr, np.int64)).to(device)
    cols = torch.from_numpy(np.asarray(indices, np.int64)).to(device)
    rows = torch.repeat_interleave(torch.arange(n_all, device=device), ip[1:] - ip[:-1])
    ob = owner[rows]
    keep = (ob >= 0) & (ob == owner[cols])
    ob, rows, cols = ob[keep], rows[keep], cols[keep]
    order = torch.argsort(ob)
    ob, rows, cols = ob[order], pos[rows[order]], pos[cols[order]]
    bounds = torch.searchsorted(ob, torch.arange(len(batches) + 1, device=device)).tolist()
    del owner, ip, keep, order
    feats = torch.from_numpy(features).to(device)
    qws = [quantize(w.to(device), bits) for w in float_weights]
    for i, nodes in enumerate(batches):
        n = len(nodes)
        a = torch.zeros((n, n), dtype=torch.float64, device=device)
        a[rows[bounds[i]:bounds[i + 1]], cols[bounds[i]:bounds[i + 1]]] = 1.0
        qx = quantize(feats[torch.from_numpy(np.asarray(nodes, np.int64)).to(device)], bits)
        yield i, forward(cfg["model"], a, qx, qws, bits)
