"""Quantized GNN models (QGCN / QGIN).

Counterpart of ``qgtc_ppopp22_tpu/models/qmodels.py``, in two working
formats: ``DigitTensor`` features with a ``PackedTensor`` adjacency
(``fmt='digits'``), or ``BitTensor`` planes throughout (``fmt='bits'``,
the reference's own bit-serial form):

* QGCN, update then aggregate (``main_qgtc.py:146-154``):
  ``XW1 -> A(XW1) -> (.)W2 -> A(.) -> (.)W3 -> A(.) as float32``.
* QGIN, aggregate then update (``main_qgtc.py:131-138``):
  ``AX -> (AX)W1 -> A(.) -> (.)W2 -> A(.) -> (.)W3 as float32``.

Each product goes to ``packmm`` when its left operand is the packed
adjacency, to ``bitgemm`` when it is a ``BitTensor``, else to
``digitmm``. ``plain=True`` runs their plain PyTorch versions instead of
the kernels, on whatever device the operands are: the on-device
reference the kernels are held against. A ``tile_map`` (zero-tile
jumping over the adjacency's all-zero tiles) goes to every product whose
left operand is the adjacency (JAX ``models/qmodels.py:51-74``), in
whichever of the three GEMMs that is.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from qgtc_ppopp22_tpu_torch.models.golden import bitmm_np
from qgtc_ppopp22_tpu_torch.ops.bitgemm import TileMap, bitmm_plain, bitmm_to_bits, bitmm_to_int
from qgtc_ppopp22_tpu_torch.ops.bitpack import BitTensor, pack_bits
from qgtc_ppopp22_tpu_torch.ops.digitmm import (
    digitmm_plain,
    digitmm_to_digits,
    digitmm_to_f32,
)
from qgtc_ppopp22_tpu_torch.ops.digits import digit_pack
from qgtc_ppopp22_tpu_torch.ops.packmm import (
    PackedTensor,
    packmm_plain,
    packmm_to_digits,
    packmm_to_f32,
)
from qgtc_ppopp22_tpu_torch.ops.quantize import quantize


def _mm_to_bits(a, b, out_bits: int, shift: int, plain: bool, tile_map=None):
    """Container-dispatching requantized GEMM: packed adjacency, bit
    planes or digit planes on the left."""
    if isinstance(a, BitTensor):
        if shift:
            raise NotImplementedError(
                "scaled requant is only on the digit path; the packed "
                "bitgemm path keeps exact reference semantics (shift=0)"
            )
        if plain:
            return bitmm_plain(a, b, out_bits, tile_map)
        return bitmm_to_bits(a, b, out_bits, tile_map=tile_map)
    if isinstance(a, PackedTensor):
        if plain:
            return packmm_plain(a, b, out_bits, shift, tile_map=tile_map)
        return packmm_to_digits(a, b, out_bits, tile_map=tile_map, shift=shift)
    if plain:
        return digitmm_plain(a, b, out_bits, shift, tile_map=tile_map)
    return digitmm_to_digits(a, b, out_bits, tile_map=tile_map, shift=shift)


def _mm_to_f32(a, b, plain: bool, tile_map=None) -> torch.Tensor:
    if isinstance(a, BitTensor):
        return bitmm_plain(a, b, None, tile_map) if plain else bitmm_to_int(a, b, tile_map=tile_map)
    if isinstance(a, PackedTensor):
        return packmm_plain(a, b, tile_map=tile_map) if plain else packmm_to_f32(a, b, tile_map)
    return digitmm_plain(a, b, tile_map=tile_map) if plain else digitmm_to_f32(a, b, tile_map)


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
) -> List:
    """Quantize and pack weights once (reference ``main_qgtc.py:108-110``):
    ``DigitTensor``\\ s for ``fmt='digits'``, ``BitTensor``\\ s for
    ``fmt='bits'``.

    ``quant_bits`` (default ``bit_width``) sets the quantization grid
    apart from the datapath width; a narrower grid wraps ``2^qb`` to 0
    as a ``qb``-plane pack would, so a wide engine runs a narrow model's
    exact weights."""
    if fmt not in ("digits", "bits"):
        raise ValueError(f"unknown weight format {fmt!r}")
    qb = quant_bits or bit_width
    if qb > bit_width:
        raise ValueError(f"quant_bits ({qb}) must be <= bit_width")

    def q(w):
        v = quantize(w, qb)
        return v % (1 << qb) if qb < bit_width else v

    pack = pack_bits if fmt == "bits" else digit_pack
    return [pack(q(w), bit_width) for w in weights]


def weights_from_jax(
    float_weights: Sequence[np.ndarray], bit_width: int, quant_bits: Optional[int] = None,
    fmt: str = "digits",
) -> List:
    """The JAX engine's float weights (``np.asarray(eng.float_weights[i])``)
    -> this package's weights in ``fmt``, so both compute the same model."""
    ws = [torch.from_numpy(np.array(w, dtype=np.float32)) for w in float_weights]
    return pack_weights(ws, bit_width, fmt=fmt, quant_bits=quant_bits)


def _shifts(shifts, n_layers: int) -> List[int]:
    return list(shifts) if shifts is not None else [0] * (2 * n_layers - 1)


def qgcn_forward(
    bit_a,
    bit_x,
    bit_ws: Sequence,
    out_bits: int,
    tile_map: Optional[TileMap] = None,
    *,
    shifts: Optional[Sequence[int]] = None,
    plain: bool = False,
) -> torch.Tensor:
    """Cluster-GCN forward -> float32 logits [M, out_dim], over a
    ``PackedTensor`` adjacency with ``DigitTensor`` features and weights,
    or ``BitTensor``\\ s throughout. JAX's names and order: a positional
    fifth argument is the ``tile_map``. ``shifts``: the optional per-GEMM
    requant shifts (2 per hidden layer + 1, digit path only)."""
    sh = iter(_shifts(shifts, len(bit_ws)))
    h = bit_x
    for l, w in enumerate(bit_ws):
        h = _mm_to_bits(h, w, out_bits, next(sh), plain)
        if l < len(bit_ws) - 1:
            h = _mm_to_bits(bit_a, h, out_bits, next(sh), plain, tile_map)
    return _mm_to_f32(bit_a, h, plain, tile_map)


def qgin_forward(
    bit_a,
    bit_x,
    bit_ws: Sequence,
    out_bits: int,
    tile_map: Optional[TileMap] = None,
    *,
    shifts: Optional[Sequence[int]] = None,
    plain: bool = False,
) -> torch.Tensor:
    """Batched-GIN forward -> float32 logits [M, out_dim]; operands and
    arguments as in :func:`qgcn_forward`."""
    sh = iter(_shifts(shifts, len(bit_ws)))
    h = _mm_to_bits(bit_a, bit_x, out_bits, next(sh), plain, tile_map)
    for w in bit_ws[:-1]:
        h = _mm_to_bits(h, w, out_bits, next(sh), plain)
        h = _mm_to_bits(bit_a, h, out_bits, next(sh), plain, tile_map)
    return _mm_to_f32(h, bit_ws[-1], plain)


# -- NumPy golden forwards (integer semantics), for parity checks -------


def qgcn_golden(qa, qx, qws, bit_width: int, out_bits: int, shifts=None) -> np.ndarray:
    """Integer-exact NumPy model of :func:`qgcn_forward` over levels: ``qa``
    the 0/1 adjacency, ``qx`` the feature levels, ``qws`` the weight levels
    (JAX ``models/qmodels.qgcn_golden``)."""
    sh = iter(_shifts(shifts, len(qws)))
    h, hb = qx, bit_width
    for l, w in enumerate(qws):
        h, hb = bitmm_np(h, w, hb, bit_width, out_bits, next(sh)), out_bits
        if l < len(qws) - 1:
            h = bitmm_np(qa, h, 1, hb, out_bits, next(sh))
    return bitmm_np(qa, h, 1, hb, None)


def qgin_golden(qa, qx, qws, bit_width: int, out_bits: int, shifts=None) -> np.ndarray:
    """Integer-exact NumPy model of :func:`qgin_forward`, arguments as in
    :func:`qgcn_golden` (JAX ``models/qmodels.qgin_golden``)."""
    sh = iter(_shifts(shifts, len(qws)))
    h, hb = bitmm_np(qa, qx, 1, bit_width, out_bits, next(sh)), out_bits
    for w in qws[:-1]:
        h = bitmm_np(h, w, hb, bit_width, out_bits, next(sh))
        h = bitmm_np(qa, h, 1, out_bits, out_bits, next(sh))
    return bitmm_np(h, qws[-1], hb, bit_width, None)
