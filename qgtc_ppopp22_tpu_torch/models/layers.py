"""Layer-level API (reference ``QGTC_conv.py`` role, but alive).

Counterpart of ``qgtc_ppopp22_tpu/models/layers.py``. The reference ships
layer classes (``GCNConv_Qnt`` / ``Aggregation_Qnt``, ``QGTC_conv.py:9-78``)
that its benchmark never instantiates, and cannot: ``GCNConv_Qnt.__init__``
raises NameError, and the backward stubs return ``None``. These are the
working equivalents, composable layer objects over the port's GEMMs
(``models/qmodels._mm_to_bits`` / ``_mm_to_f32``) with the reference's two
primitive operations:

* :class:`QAggregation`: ``A @ H`` in the bit domain
  (``Aggregation_Qnt.forward``: ``bitMM2Bit(A, .)`` or ``bitMM2Int(A, .)``);
  a ``PackedTensor`` adjacency reaches ``packmm`` (K2), a digit-plane one
  ``digitmm`` (K3), a ``BitTensor`` one ``bitmm`` (K6).
* :class:`QLinear`: ``H @ W`` with the weight quantized and packed once
  (``GCNConv_Qnt``'s ``bit_W`` buffer); digit planes reach ``digitmm``
  (K3), bit planes ``bitmm`` (K6).

Inference only, like the reference: no backward pass exists.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from qgtc_ppopp22_tpu_torch.models.qmodels import _mm_to_bits, _mm_to_f32
from qgtc_ppopp22_tpu_torch.ops.bitgemm import TileMap
from qgtc_ppopp22_tpu_torch.ops.bitpack import BitTensor, val2bit
from qgtc_ppopp22_tpu_torch.ops.digits import DigitTensor, digit_pack
from qgtc_ppopp22_tpu_torch.ops.packmm import PackedTensor
from qgtc_ppopp22_tpu_torch.ops.quantize import quantize

Packed = Union[BitTensor, DigitTensor, PackedTensor]


@dataclasses.dataclass(frozen=True)
class QLinear:
    """Quantized linear layer: the weight packed once at construction
    (the reference packs weights outside the epoch loop,
    ``main_qgtc.py:108-110``)."""

    weight: Packed
    out_bits: int

    @classmethod
    def create(cls, w, bit_width: int, out_bits: Optional[int] = None, fmt: str = "digits",
               device=None) -> "QLinear":
        """``w``: float weights (a tensor or a NumPy array, e.g. a JAX
        engine's), quantized to ``bit_width`` and packed as digit planes
        (``fmt='digits'``) or bit planes (``'bits'``) on ``device`` (default
        ``w``'s, the CPU for an array)."""
        if not isinstance(w, torch.Tensor):
            w = torch.from_numpy(np.array(w, np.float32))
        if device is not None:
            w = w.to(device)
        if fmt == "digits":
            packed: Packed = digit_pack(quantize(w, bit_width), bit_width)
        elif fmt == "bits":
            packed = val2bit(w, bit_width)
        else:
            raise ValueError(f"unknown weight format {fmt!r}")
        return cls(weight=packed, out_bits=out_bits or bit_width)

    def __call__(self, h: Packed) -> Packed:
        return _mm_to_bits(h, self.weight, self.out_bits, 0, False)

    def to_float(self, h: Packed) -> torch.Tensor:
        """The output-layer variant (``bitMM2Int(., W)``, GIN's last op)."""
        return _mm_to_f32(h, self.weight, False)


@dataclasses.dataclass(frozen=True)
class QAggregation:
    """Bit-domain neighbourhood aggregation ``A @ H``
    (``Aggregation_Qnt.forward``, ``QGTC_conv.py:15-22``), over the
    adjacency's all-zero tiles skipped when a ``tile_map`` is given."""

    out_bits: int
    tile_map: Optional[TileMap] = None

    def __call__(self, bit_a: Packed, h: Packed) -> Packed:
        return _mm_to_bits(bit_a, h, self.out_bits, 0, False, self.tile_map)

    def to_float(self, bit_a: Packed, h: Packed) -> torch.Tensor:
        """The final aggregation to float logits (``bitMM2Int(A, .)``)."""
        return _mm_to_f32(bit_a, h, False, self.tile_map)


@dataclasses.dataclass(frozen=True)
class QGCNConv:
    """One GCN layer: update, then aggregate (``GCNConv_Qnt``'s intent,
    ``main_qgtc.py:146-154``'s execution)."""

    linear: QLinear
    agg: QAggregation

    @classmethod
    def create(cls, w, bit_width: int, tile_map: Optional[TileMap] = None, fmt: str = "digits",
               device=None) -> "QGCNConv":
        return cls(linear=QLinear.create(w, bit_width, fmt=fmt, device=device),
                   agg=QAggregation(out_bits=bit_width, tile_map=tile_map))

    def __call__(self, bit_a: Packed, h: Packed, final: bool = False):
        h = self.linear(h)
        if final:
            return self.agg.to_float(bit_a, h)
        return self.agg(bit_a, h)


@dataclasses.dataclass(frozen=True)
class QGINConv:
    """One GIN layer: aggregate, then update (``main_qgtc.py:131-138``)."""

    linear: QLinear
    agg: QAggregation

    @classmethod
    def create(cls, w, bit_width: int, tile_map: Optional[TileMap] = None, fmt: str = "digits",
               device=None) -> "QGINConv":
        return cls(linear=QLinear.create(w, bit_width, fmt=fmt, device=device),
                   agg=QAggregation(out_bits=bit_width, tile_map=tile_map))

    def __call__(self, bit_a: Packed, h: Packed, final: bool = False):
        h = self.agg(bit_a, h)
        if final:
            return self.linear.to_float(h)
        return self.linear(h)
