"""Device timing (the reference's cudaEvent role, ``QGTC_device.cu:409-422``).

PyTorch returns before the device finishes, so a host clock measures
the enqueue, and CUDA events around back-to-back calls measure the
host's pace whenever a call's Python and launch work outlasts its
kernels (true of the slice's small GEMMs). :func:`device_times_ms`
therefore sums the device time of the kernels and copies the calls ran,
from ``torch.profiler``, so host gaps do not count.
"""

from __future__ import annotations

import time
import warnings
from collections import Counter
from typing import Callable, Dict, Hashable, Optional, Sequence, Union

import torch

_MARKER = "spin_kernel"  # the kernel of torch.cuda._sleep
_SESSIONS = 3  # profiler sessions tried before a lost marker is an error
_PAD_KERNELS = 256  # padding launched before a session's first marker and after its end marker
_PAD_SECONDS = 0.1  # and the wait after each padding


def _device_events(fns: Dict[Hashable, Callable[[], object]], counts: Dict[Hashable, int],
                   warmup: int) -> Dict[Hashable, list]:
    """Each function's device events (kernels and copies) over its
    ``counts[name]`` calls, from one profiler session.

    One profiler session covers all functions (a second session in the
    same process can come back empty). Each function's calls follow a
    marker kernel and end with a synchronize, and the device events are
    assigned to functions by their order on the device, between markers:
    the profiler's device timestamps can sit a millisecond or more off
    the host's clock, so host-side ranges would drop or misplace the
    first kernels of a function. The profiler can drop a session's first
    or last records, so padding kernels and a short wait come before the
    first marker, and after an end marker that closes the last function:
    such a loss takes the padding. A session whose markers, the end
    marker included, are not all there is run again, up to ``_SESSIONS``
    in all. Requires a CUDA device; every function must run on the
    current stream (a CUDA graph's replay included: its kernels are
    recorded one by one)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise RuntimeError("device timing needs a CUDA device")
    names = list(fns)
    for fn in fns.values():
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    pad = torch.zeros(1, device="cuda")

    def padding():
        for _ in range(_PAD_KERNELS):
            pad.add_(1)
        torch.cuda.synchronize()
        time.sleep(_PAD_SECONDS)

    for _ in range(_SESSIONS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            padding()
            for name in names:
                torch.cuda._sleep(1)
                for _ in range(counts[name]):
                    fns[name]()
                torch.cuda.synchronize()
            torch.cuda._sleep(1)  # the end marker
            padding()
        device = sorted(
            (e for e in prof.events() if e.device_type == DeviceType.CUDA),
            key=lambda e: e.time_range.start,
        )
        events: list = [[] for _ in names]
        i = -1
        for e in device:
            if _MARKER in e.name:
                i += 1
            elif 0 <= i < len(names):
                events[i].append(e)
        if i == len(names):  # every function's marker and the end marker
            return dict(zip(names, events))
        warnings.warn(f"the profiler recorded {i + 1} of {len(names) + 1} markers; "
                      "running the session again")
    raise RuntimeError(f"the profiler recorded {i + 1} markers for {len(names)} functions "
                       "and the end marker")


def device_times_ms(
    fns: Dict[Hashable, Callable[[], object]],
    iters: Union[int, Dict[Hashable, int]] = 20,
    warmup: int = 3,
) -> Dict[Hashable, float]:
    """Mean device milliseconds per call of each function in ``fns``:
    every kernel and copy its ``iters`` calls ran, summed, from one
    profiler session (:func:`_device_events`). ``iters`` may be a count
    per function: the profiler can drop records when a session holds too
    many, so a function of thousands of small ops (a plain version) takes
    fewer calls."""
    counts = {name: iters[name] if isinstance(iters, dict) else iters for name in fns}
    events = _device_events(fns, counts, warmup)
    total_us = {name: sum(e.time_range.elapsed_us() for e in events[name]) for name in fns}
    empty = [name for name, t in total_us.items() if t <= 0]
    if empty:
        raise RuntimeError(f"the profiler recorded no device time for {empty}")
    return {name: total_us[name] / 1e3 / counts[name] for name in fns}


def kernel_launches(fn: Callable[[], object], iters: int = 1, warmup: int = 1) -> Counter:
    """How many times each kernel and copy ran, by name, per call of
    ``fn`` (over ``iters`` calls, from one profiler session): what ran on
    the device, where a wrapper's counter counts its Python calls (a CUDA
    graph's replay makes none)."""
    events = _device_events({"fn": fn}, {"fn": iters}, warmup)["fn"]
    counts = Counter(e.name for e in events)
    if any(n % iters for n in counts.values()):
        raise RuntimeError(f"kernel counts {dict(counts)} over {iters} calls are not a whole number per call")
    return Counter({name: n // iters for name, n in counts.items()})


def _first_tensor(r) -> Optional[torch.Tensor]:
    """The first tensor in ``r``: a tensor, or one held in a list, tuple,
    dict or dataclass (a ``DigitTensor``, a ``Sharded``...), depth first."""
    if isinstance(r, torch.Tensor):
        return r
    if isinstance(r, dict):
        r = list(r.values())
    elif hasattr(r, "__dataclass_fields__"):
        r = [getattr(r, f) for f in r.__dataclass_fields__]
    if isinstance(r, (list, tuple)):
        for x in r:
            t = _first_tensor(x)
            if t is not None:
                return t
    return None


def host_bench(fn: Callable, args: Sequence, iters: int = 100) -> float:
    """Host-loop seconds per call of ``fn(*args)``, the per-call launch
    cost included (JAX ``utils/timing.py:150-167``): one call outside the
    timing, then ``iters`` calls back to back and one synchronize of the
    device of the last output's first tensor. Epoch-style timing, where
    dispatch is part of the measured system (``main_qgtc.py:112-155``)."""

    def sync(r):
        t = _first_tensor(r)
        if t is not None and t.is_cuda:
            torch.cuda.synchronize(t.device)

    sync(fn(*args))
    t0 = time.perf_counter()
    r = None
    for _ in range(iters):
        r = fn(*args)
    sync(r)
    return (time.perf_counter() - t0) / iters
