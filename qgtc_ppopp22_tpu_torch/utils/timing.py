"""Device timing (the reference's cudaEvent role, ``QGTC_device.cu:409-422``).

PyTorch returns before the device finishes, so a host clock measures
the enqueue, and CUDA events around back-to-back calls measure the
host's pace whenever a call's Python and launch work outlasts its
kernels (true of the slice's small GEMMs). :func:`device_times_ms`
therefore sums the device time of the kernels and copies the calls ran,
from ``torch.profiler``, so host gaps do not count.
"""

from __future__ import annotations

from typing import Callable, Dict, Hashable

import torch


def device_times_ms(
    fns: Dict[Hashable, Callable[[], object]], iters: int = 20, warmup: int = 3
) -> Dict[Hashable, float]:
    """Mean device milliseconds per call of each function in ``fns``:
    every kernel and copy its ``iters`` calls ran, summed.

    One profiler session covers all functions (a second session in the
    same process can come back empty); each function's calls run inside
    a named range that ends with a synchronize, so its device work falls
    inside that range. Requires a CUDA device."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    if not torch.cuda.is_available():
        raise RuntimeError("device_times_ms needs a CUDA device")
    names = list(fns)
    for fn in fns.values():
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i, name in enumerate(names):
            with record_function(f"timed:{i}"):
                for _ in range(iters):
                    fns[name]()
                torch.cuda.synchronize()
    events = prof.events()
    ranges = {
        int(e.name[len("timed:"):]): (e.time_range.start, e.time_range.end)
        for e in events
        if e.name.startswith("timed:") and e.device_type == DeviceType.CPU
    }
    total_us = [0.0] * len(names)
    for e in events:
        if e.device_type != DeviceType.CUDA or e.name.startswith("timed:"):
            continue
        for i, (start, end) in ranges.items():
            if start <= e.time_range.start and e.time_range.end <= end:
                total_us[i] += e.time_range.elapsed_us()
                break
    empty = [names[i] for i, t in enumerate(total_us) if t <= 0]
    if empty:
        raise RuntimeError(f"the profiler recorded no device time for {empty}")
    return {name: total_us[i] / 1e3 / iters for i, name in enumerate(names)}
