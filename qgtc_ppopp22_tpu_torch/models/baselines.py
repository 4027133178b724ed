"""Full-precision baseline models (the reference's DGL-baseline role).

Counterpart of ``qgtc_ppopp22_tpu/models/baselines.py``: a dense model
over the same cluster batches as the quantized engine, aggregation as
``A @ H`` with bfloat16 operands and float32 sums (the reference's DGL
GraphSAGE / GIN, ``modules.py:16-45, 55-99``). The whole-bucket kernel
of this chain is ``ops/fused_model.fused_baseline_epoch``.

``_bf16_mm`` rounds both operands to bfloat16 (round to nearest even, as
JAX's ``astype`` does) and multiplies them in float32. A product of two
bf16 values is exact in float32, so this is JAX's
``preferred_element_type=float32``; ``torch.matmul`` on bf16 tensors
would round the output to bf16 as well, which JAX does not.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch


def init_mlp_weights(
    generator: torch.Generator, dims: Sequence[int], scale: float = 0.1
) -> List[torch.Tensor]:
    """Normal weights ``[dims[i], dims[i+1]] * scale``, drawn on the CPU
    from ``generator``."""
    return [
        torch.randn((dims[i], dims[i + 1]), generator=generator, dtype=torch.float32) * scale
        for i in range(len(dims) - 1)
    ]


def baseline_weights_from_jax(float_weights: Sequence[np.ndarray]) -> List[torch.Tensor]:
    """The JAX baseline's weights (``np.asarray(eng.weights[i])``) as this
    package's float32 tensors, unchanged."""
    return [torch.from_numpy(np.array(w, dtype=np.float32)) for w in float_weights]


def _bf16_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a.to(torch.bfloat16).float(), b.to(torch.bfloat16).float())


def sage_forward(a: torch.Tensor, x: torch.Tensor, ws: Sequence[torch.Tensor]) -> torch.Tensor:
    """GraphSAGE-style chain (copy-src/sum + Linear + ReLU per layer,
    ``modules.py:16-24, 41-45``): ``h = relu((A @ h) @ W)``, no relu
    after the last layer; float32 logits."""
    h = x
    for i, w in enumerate(ws):
        h = _bf16_mm(_bf16_mm(a, h), w)
        if i < len(ws) - 1:
            h = torch.relu(h)
    return h


def gin_forward(a: torch.Tensor, x: torch.Tensor, ws: Sequence[torch.Tensor]) -> torch.Tensor:
    """GIN-style chain (sum-aggregate then a one-Linear MLP with ReLU,
    ``modules.py:55-99`` simplified as in the JAX package): the same
    arithmetic as :func:`sage_forward`."""
    return sage_forward(a, x, ws)


def int8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 x int8 -> int32 product (the reference's cuBLAS ``GemmEx``
    INT8 baseline, ``cuBLASGemmEX/cublas_main.cu:132-154``):
    ``torch._int_mm`` on CUDA, an exact int32 product on the CPU."""
    a8, b8 = a.to(torch.int8), b.to(torch.int8)
    if a8.is_cuda:
        return torch._int_mm(a8, b8)
    return torch.matmul(a8.to(torch.int32), b8.to(torch.int32))


def sparse_aggregate(
    indptr: torch.Tensor,
    indices: torch.Tensor,
    x: torch.Tensor,
    num_nodes: Optional[int] = None,
) -> torch.Tensor:
    """CSR sum-aggregation (``index_add_``; the JAX ``segment_sum``):
    row ``i`` is the sum of ``x[indices[indptr[i]:indptr[i+1]]]``."""
    num_nodes = num_nodes or (indptr.shape[0] - 1)
    deg = torch.diff(indptr)
    # output_size: the edge count, so CUDA needs no host synchronize
    row = torch.repeat_interleave(torch.arange(num_nodes, device=x.device), deg,
                                  output_size=indices.numel())
    out = torch.zeros((num_nodes,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    return out.index_add_(0, row, x[indices])
