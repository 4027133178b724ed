"""Classification metrics (reference ``utils.py:43-50``, ``calc_f1``) and
results output.

NumPy copy of ``f1_score`` and ``multilabel_f1`` from
``qgtc_ppopp22_tpu/utils/metrics.py``: micro / macro F1 over argmax
predictions, and the multilabel branch that thresholds logits at 0; its
``Logger`` (the reference's append-to-file logger, ``utils.py:12-28``),
``write_csv`` and ``write_json_line``, which write the same bytes.
"""

from __future__ import annotations

import csv
import json
import os
import time
from typing import Dict, Iterable, List, Optional

import numpy as np


def _f1_from_counts(tp, fp, fn):
    denom = 2 * tp + fp + fn
    return np.where(denom > 0, 2 * tp / np.maximum(denom, 1), 0.0)


def f1_score(
    y_true: np.ndarray,
    y_pred: np.ndarray,
    num_classes: Optional[int] = None,
    average: str = "micro",
) -> float:
    """Micro / macro F1 of class predictions."""
    y_true = np.asarray(y_true).ravel()
    y_pred = np.asarray(y_pred).ravel()
    if num_classes is None:
        num_classes = int(max(y_true.max(initial=0), y_pred.max(initial=0))) + 1
    tp = np.zeros(num_classes)
    fp = np.zeros(num_classes)
    fn = np.zeros(num_classes)
    for c in range(num_classes):
        tp[c] = np.sum((y_pred == c) & (y_true == c))
        fp[c] = np.sum((y_pred == c) & (y_true != c))
        fn[c] = np.sum((y_pred != c) & (y_true == c))
    if average == "micro":
        return float(_f1_from_counts(tp.sum(), fp.sum(), fn.sum()))
    if average == "macro":
        return float(np.mean(_f1_from_counts(tp, fp, fn)))
    raise ValueError(f"unknown average {average!r}")


def multilabel_f1(logits: np.ndarray, labels: np.ndarray, average: str = "micro") -> float:
    """Reference ``calc_f1`` multilabel branch (``utils.py:44-47``):
    predictions are ``logits > 0``."""
    pred = (np.asarray(logits) > 0).astype(np.int64)
    lab = np.asarray(labels).astype(np.int64)
    tp = np.sum((pred == 1) & (lab == 1), axis=0).astype(np.float64)
    fp = np.sum((pred == 1) & (lab == 0), axis=0).astype(np.float64)
    fn = np.sum((pred == 0) & (lab == 1), axis=0).astype(np.float64)
    if average == "micro":
        return float(_f1_from_counts(tp.sum(), fp.sum(), fn.sum()))
    return float(np.mean(_f1_from_counts(tp, fp, fn)))


class Logger:
    """Append-to-file logger (reference ``utils.py:12-28``): each line
    stamped with the local time."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def write(self, msg: str) -> None:
        with open(self.path, "a") as f:
            f.write(f"{time.strftime('%Y-%m-%d %H:%M:%S')} {msg}\n")


def write_csv(path: str, rows: Iterable[Dict], fieldnames: List[str]) -> None:
    """Structured results output (replaces the reference's ``parse_time.py``
    scraping): a header line, then one line per row."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fieldnames)
        w.writeheader()
        for r in rows:
            w.writerow(r)


def write_json_line(path: Optional[str], record: Dict) -> str:
    """``record`` as one JSON line, appended to ``path`` when one is given;
    returns the line."""
    line = json.dumps(record)
    if path:
        with open(path, "a") as f:
            f.write(line + "\n")
    return line
