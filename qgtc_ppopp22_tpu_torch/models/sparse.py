"""Full-graph sparse quantized inference.

Counterpart of ``qgtc_ppopp22_tpu/models/sparse.py``: the quantized
engine's integer semantics (quantize levels, requantize with an optional
shift between layers, ``kernel.h:31-71,347-351``) computed over the whole
CSR graph with a gather and ``index_add_`` (JAX's ``segment_sum``): no
clustering, no densification, no padding. Exact-integer equivalent of the
dense engines on the whole graph.

Aggregation is 1-bit (binary adjacency, the reference's convention): the
neighbour sum of integer levels is the bit-GEMM's result. The sums are
integers, so ``index_add_`` gives the same answer in any atomic order.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from qgtc_ppopp22_tpu_torch.ops.quantize import requantize_wrapped as _requant

__all__ = ["sparse_q_forward", "sparse_aggregate_levels"]


def sparse_aggregate_levels(indptr: torch.Tensor, indices: torch.Tensor, h: torch.Tensor,
                            num_nodes: int) -> torch.Tensor:
    """``A @ H`` for the binary in-adjacency CSR over integer levels: row
    ``i`` is the sum of ``h[indices[indptr[i]:indptr[i+1]]]``."""
    # output_size: the edge count, so CUDA needs no host synchronize to size
    # the result (JAX's total_repeat_length)
    row = torch.repeat_interleave(torch.arange(num_nodes, device=h.device), torch.diff(indptr),
                                  output_size=indices.numel())
    out = torch.zeros((num_nodes,) + tuple(h.shape[1:]), dtype=h.dtype, device=h.device)
    return out.index_add_(0, row, h[indices])


def _mm(h: torch.Tensor, w: torch.Tensor, mask: int) -> torch.Tensor:
    """``H @ W`` of integer levels, exactly. CUDA has no int32 matmul, so
    the product runs in float64: levels below 2^8 on both sides and K at
    most the feature width keep every sum below 2^16 K, far under 2^53,
    where float64 is exact. ``w`` keeps only its low ``mask`` bits, as a
    pack would (level ``2^bits`` -> 0, ``kernel.h:226-229``)."""
    return (h.to(torch.float64) @ (w & mask).to(torch.float64)).to(torch.int32)


def sparse_q_forward(
    indptr: torch.Tensor,
    indices: torch.Tensor,
    qx: torch.Tensor,
    qws: Sequence[torch.Tensor],
    out_bits: int,
    model: str = "gcn",
    shifts: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """Quantized GCN / GIN forward over the full CSR graph -> float32 logits
    [N, out_dim]. ``qx``: int32 feature levels [N, d]; ``qws``: int32
    weight levels. Bit-exact with the dense engines' semantics (the same
    requantizer, the same dataflow order, ``main_qgtc.py:127-154``)."""
    n = indptr.shape[0] - 1
    n_layers = len(qws)
    sh = iter(list(shifts) if shifts is not None else [0] * (2 * n_layers - 1))
    mask = (1 << out_bits) - 1

    def agg(h):
        return _requant(sparse_aggregate_levels(indptr, indices, h, n), out_bits, next(sh))

    h = qx.to(torch.int32) & mask
    if model == "gcn":
        for l, w in enumerate(qws):
            h = _requant(_mm(h, w, mask), out_bits, next(sh))
            if l < n_layers - 1:
                h = agg(h)
        return sparse_aggregate_levels(indptr, indices, h, n).to(torch.float32)
    if model != "gin":
        raise ValueError(model)
    h = agg(h)
    for w in qws[:-1]:
        h = agg(_requant(_mm(h, w, mask), out_bits, next(sh)))
    return _mm(h, qws[-1], mask).to(torch.float32)
