"""How ``correct`` is decided: every batch's logits from the timed path against
the plain reference, over every node of the graph, in each checked epoch.

Each node is due exactly once over the epoch's batches (the batches are a
partition of the graph). The program's batches say which nodes each one
holds and in which row order; the reference rebuilds each batch from the
benchmark's own graph, features and weights for those nodes, in that order.
A node that no batch holds, or that more than one holds, counts every one of
its logits as wrong. Two numbers are compared, each with its limit from the
configuration:

* ``wrong_logits``: logits that differ from the reference, or are missing,
  summed over the checked epochs;
* ``max_logit_gap``: the largest absolute difference of a logit that both
  sides computed.
"""

from __future__ import annotations

from typing import Dict, Iterator, Sequence, Tuple

import numpy as np
import torch


def compare(programs: Sequence[Dict[int, torch.Tensor]], reference: Iterator[Tuple[int, torch.Tensor]],
            batches: Sequence[np.ndarray], num_nodes: int, classes: int) -> dict:
    """The compared numbers over the checked epochs. ``programs[e][i]`` is
    batch ``i``'s logits [rows, classes] in epoch ``e``; ``reference`` yields
    each batch's reference logits once."""
    every = np.concatenate([np.asarray(b, np.int64) for b in batches]) if batches else np.empty(0, np.int64)
    if every.size and (every.min() < 0 or every.max() >= num_nodes):
        raise ValueError("a batch lists a node outside the graph")
    counts = np.bincount(every, minlength=num_nodes)
    wrong = int((counts == 0).sum() + counts[counts > 1].sum()) * classes * len(programs)
    gap = 0.0
    for i, ref in reference:
        once = torch.from_numpy(counts[np.asarray(batches[i], np.int64)] == 1).to(ref.device)
        for program in programs:
            got = program[i].to(ref.device, torch.float64)
            if got.shape != ref.shape:
                wrong += int(once.sum()) * classes
                continue
            diff = (got - ref).abs()[once]
            wrong += int((diff != 0).sum())
            if diff.numel():
                gap = max(gap, float(diff.max()))
    return {"wrong_logits": wrong, "max_logit_gap": gap}


def judge(numbers: dict, limits: dict) -> bool:
    return all(numbers[k] <= limits[k] for k in limits)
