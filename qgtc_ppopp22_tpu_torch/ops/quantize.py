"""Scalar quantization semantics of the reference, on torch tensors.

Counterpart of ``qgtc_ppopp22_tpu/ops/quantize.py``; the same rules:

* ``quantize``: clip to ``[0, 2^bits]`` where values below 0 become 1
  (not 0) and values above ``2^bits`` become ``2^bits - 1``, then round
  half to even (``torch.round``, like CUDA ``__float2int_rn``).
* ``requantize``: the GEMM epilogue. After an optional arithmetic
  ``>> shift``: ``acc > 2^b`` -> ``2^b - 1``, ``acc < 0`` -> 1, anything
  else (``2^b`` included) passes; ``requantize_wrapped`` then keeps the
  low ``b`` bits, so ``2^b`` wraps to 0 as the reference packer does.
"""

from __future__ import annotations

import torch


def _check_bits(bits: int, name: str) -> None:
    if not (1 <= bits <= 8):
        raise ValueError(f"{name} must be in [1, 8], got {bits}")


def quantize(x: torch.Tensor, bits: int) -> torch.Tensor:
    """float -> int32 levels in ``[0, 2^bits]`` (reference ``Quantize_val``)."""
    _check_bits(bits, "bits")
    ub = float(1 << bits)
    x = x.to(torch.float32)
    one = torch.ones_like(x)
    clipped = torch.where(x < 0.0, one, torch.where(x > ub, one * (ub - 1.0), x))
    return torch.round(clipped).to(torch.int32)


def requantize(acc: torch.Tensor, out_bits: int, shift: int = 0) -> torch.Tensor:
    """Integer accumulator -> levels, reference epilogue semantics.

    Keeps the accumulator's integer dtype; ``>>`` on a signed tensor is
    arithmetic (floor division by ``2^shift``)."""
    _check_bits(out_bits, "out_bits")
    ub = 1 << out_bits
    if shift:
        acc = acc >> shift
    return torch.where(
        acc > ub,
        torch.full_like(acc, ub - 1),
        torch.where(acc < 0, torch.ones_like(acc), acc),
    )


def requantize_wrapped(
    acc: torch.Tensor, out_bits: int, shift: int = 0
) -> torch.Tensor:
    """:func:`requantize` plus the pack-time wrap (``2^b`` -> 0)."""
    return requantize(acc, out_bits, shift) & ((1 << out_bits) - 1)


def dequantize_levels(q: torch.Tensor) -> torch.Tensor:
    """Integer levels -> float32 (the reference never rescales)."""
    return q.to(torch.float32)
