"""Quantized GNN models in the digit domain (QGCN / QGIN).

Counterpart of ``qgtc_ppopp22_tpu/models/qmodels.py``, over
``DigitTensor`` features and a ``PackedTensor`` adjacency (the
``BitTensor`` path of the JAX package waits for its GEMM):

* QGCN, update then aggregate (``main_qgtc.py:146-154``):
  ``XW1 -> A(XW1) -> (.)W2 -> A(.) -> (.)W3 -> A(.) as float32``.
* QGIN, aggregate then update (``main_qgtc.py:131-138``):
  ``AX -> (AX)W1 -> A(.) -> (.)W2 -> A(.) -> (.)W3 as float32``.

Each product goes to ``packmm`` when its left operand is the packed
adjacency, else to ``digitmm``. ``plain=True`` runs their plain PyTorch
versions instead of the kernels, on whatever device the operands are:
the on-device reference the kernels are held against.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from qgtc_ppopp22_tpu_torch.ops.digitmm import (
    digitmm_plain,
    digitmm_to_digits,
    digitmm_to_f32,
)
from qgtc_ppopp22_tpu_torch.ops.digits import DigitTensor, digit_pack
from qgtc_ppopp22_tpu_torch.ops.packmm import (
    PackedTensor,
    packmm_plain,
    packmm_to_digits,
    packmm_to_f32,
)
from qgtc_ppopp22_tpu_torch.ops.quantize import quantize


def _mm_to_digits(a, b: DigitTensor, out_bits: int, shift: int, plain: bool) -> DigitTensor:
    if isinstance(a, PackedTensor):
        if plain:
            return packmm_plain(a, b, out_bits, shift)
        return packmm_to_digits(a, b, out_bits, shift=shift)
    if plain:
        return digitmm_plain(a, b, out_bits, shift)
    return digitmm_to_digits(a, b, out_bits, shift=shift)


def _mm_to_f32(a, b: DigitTensor, plain: bool) -> torch.Tensor:
    if isinstance(a, PackedTensor):
        return packmm_plain(a, b) if plain else packmm_to_f32(a, b)
    return digitmm_plain(a, b) if plain else digitmm_to_f32(a, b)


@dataclasses.dataclass(frozen=True)
class QModelConfig:
    in_dim: int
    hidden: int
    out_dim: int
    bit_width: int = 2
    num_layers: int = 3  # reference models are 3-layer (modules.py)

    def weight_shapes(self) -> List[tuple]:
        dims = [self.in_dim] + [self.hidden] * (self.num_layers - 1) + [self.out_dim]
        return [(dims[i], dims[i + 1]) for i in range(self.num_layers)]


def init_weights(
    generator: torch.Generator, cfg: QModelConfig, scale: float = 1.0
) -> List[torch.Tensor]:
    """Float weights uniform over ``[0, 2^bits * scale)``, so quantized
    levels spread over the whole range (the reference quantizer has no
    learned scale). Drawn on the CPU from ``generator``."""
    ub = float(1 << cfg.bit_width)
    return [
        torch.rand((fi, fo), generator=generator, dtype=torch.float32) * (ub * scale)
        for fi, fo in cfg.weight_shapes()
    ]


def pack_weights(
    weights: Sequence[torch.Tensor],
    bit_width: int,
    fmt: str = "digits",
    quant_bits: Optional[int] = None,
) -> List[DigitTensor]:
    """Quantize and pack weights once (reference ``main_qgtc.py:108-110``).

    ``quant_bits`` (default ``bit_width``) sets the quantization grid
    apart from the datapath width; a narrower grid wraps ``2^qb`` to 0
    as a ``qb``-plane pack would, so a wide engine runs a narrow model's
    exact weights. Only ``fmt='digits'`` is ported."""
    if fmt != "digits":
        raise NotImplementedError(f"weight format {fmt!r} is not yet ported")
    qb = quant_bits or bit_width
    if qb > bit_width:
        raise ValueError(f"quant_bits ({qb}) must be <= bit_width")

    def q(w):
        v = quantize(w, qb)
        return v % (1 << qb) if qb < bit_width else v

    return [digit_pack(q(w), bit_width) for w in weights]


def weights_from_jax(
    float_weights: Sequence[np.ndarray], bit_width: int, quant_bits: Optional[int] = None
) -> List[DigitTensor]:
    """The JAX engine's float weights (``np.asarray(eng.float_weights[i])``)
    -> this package's digit weights, so both compute the same model."""
    ws = [torch.from_numpy(np.array(w, dtype=np.float32)) for w in float_weights]
    return pack_weights(ws, bit_width, fmt="digits", quant_bits=quant_bits)


def _shifts(shifts, n_layers: int) -> List[int]:
    return list(shifts) if shifts is not None else [0] * (2 * n_layers - 1)


def qgcn_forward(
    a: PackedTensor,
    x: DigitTensor,
    ws: Sequence[DigitTensor],
    out_bits: int,
    shifts: Optional[Sequence[int]] = None,
    plain: bool = False,
) -> torch.Tensor:
    """Cluster-GCN forward -> float32 logits [M, out_dim]. ``shifts``: the
    optional per-GEMM requant shifts (2 per hidden layer + 1)."""
    sh = iter(_shifts(shifts, len(ws)))
    h = x
    for l, w in enumerate(ws):
        h = _mm_to_digits(h, w, out_bits, next(sh), plain)
        if l < len(ws) - 1:
            h = _mm_to_digits(a, h, out_bits, next(sh), plain)
    return _mm_to_f32(a, h, plain)


def qgin_forward(
    a: PackedTensor,
    x: DigitTensor,
    ws: Sequence[DigitTensor],
    out_bits: int,
    shifts: Optional[Sequence[int]] = None,
    plain: bool = False,
) -> torch.Tensor:
    """Batched-GIN forward -> float32 logits [M, out_dim]."""
    sh = iter(_shifts(shifts, len(ws)))
    h = _mm_to_digits(a, x, out_bits, next(sh), plain)
    for w in ws[:-1]:
        h = _mm_to_digits(h, w, out_bits, next(sh), plain)
        h = _mm_to_digits(a, h, out_bits, next(sh), plain)
    return _mm_to_f32(h, ws[-1], plain)
