"""The work an epoch needs, counted from the batches' real sizes alone.

Frozen here so that every implementation is measured against the same work:
nothing goes through the engine's plan, padding or zero-tile schedule.

* **Operations**: 2·M·N·K for every GEMM of the chain, in
  ``qgtc_ppopp22_tpu_torch/models/qmodels.py``'s order (the copy of
  ``benchmarks/roofline.py:63-78``, ``chain_gemms``), at the batch's real node
  count and the model's real widths, counted once whatever the bit width,
  the aggregations dense.
* **Bytes**: the adjacency at 1 bit an entry over n x n, the features at
  their bits, the weights at their bits (once a batch), and the float32
  logits written once.
* **Floor** of a batch: the larger of its operations over the int8 peak and
  its bytes over the HBM peak; an epoch's floor is the sum over its batches.
"""

from __future__ import annotations

from typing import Optional, Sequence

# Data-sheet peaks by the name torch.cuda.get_device_name() gives: NVIDIA
# H100 SXM, dense int8 operations/s and HBM bytes/s, at its 700 W limit.
PEAKS = {"NVIDIA H100 80GB HBM3": {"int8_ops": 1979e12, "hbm_bytes": 3.35e12}}


def peaks(kind: str) -> Optional[dict]:
    return PEAKS.get(kind)


def dims(cfg: dict, feat_dim: int, num_classes: int) -> list:
    """[features, hidden..., classes] of the configuration's chain."""
    return [feat_dim] + [int(cfg["hidden"])] * (int(cfg["num_layers"]) - 1) + [num_classes]


def chain_gemms(model: str, m: int, widths: Sequence[int]) -> list:
    """``[(kind, M, K, N)]`` of one batch's chain: GCN updates then
    aggregates each layer; GIN aggregates X, then updates and aggregates,
    then makes the last update."""
    n = len(widths) - 1
    out = []
    if model == "gcn":
        for l in range(n):
            out += [("update", m, widths[l], widths[l + 1]), ("aggregate", m, m, widths[l + 1])]
    elif model == "gin":
        out.append(("aggregate", m, m, widths[0]))
        for l in range(n - 1):
            out += [("update", m, widths[l], widths[l + 1]), ("aggregate", m, m, widths[l + 1])]
        out.append(("update", m, widths[n - 1], widths[n]))
    else:
        raise ValueError(f"unknown model {model!r}")
    return out


def batch_ops(model: str, n: int, widths: Sequence[int]) -> int:
    return sum(2 * M * K * N for _, M, K, N in chain_gemms(model, n, widths))


def batch_bytes(n: int, widths: Sequence[int], bits: int) -> float:
    weights = sum(widths[l] * widths[l + 1] for l in range(len(widths) - 1)) * bits / 8
    return n * n / 8 + n * widths[0] * bits / 8 + weights + n * widths[-1] * 4


def batch_floor_s(model: str, n: int, widths: Sequence[int], bits: int, peak: dict) -> float:
    return max(batch_ops(model, n, widths) / peak["int8_ops"],
               batch_bytes(n, widths, bits) / peak["hbm_bytes"])
