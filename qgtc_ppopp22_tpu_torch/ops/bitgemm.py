"""Zero-tile schedule container (counterpart of the ``TileMap`` in
``qgtc_ppopp22_tpu/ops/bitgemm.py``).

The ``BitTensor`` GEMM of that module (``_bitmm``) is not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class TileMap:
    """Block-sparse schedule over the left operand's (M-tile, K-tile)
    grid: ``kidx[i, t]`` is the t-th K-tile to visit for row tile ``i``;
    entries past ``kcnt[i]`` repeat the last valid index."""

    kidx: torch.Tensor  # int32[nm, nk]
    kcnt: torch.Tensor  # int32[nm]
    tile_m: int
    tile_k: int
