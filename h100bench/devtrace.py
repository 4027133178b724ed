"""The traced window: ``torch.profiler`` over a short stretch of epochs.

One profiler session records the host (the harness's spans, the runtime's
launch calls) and the device (kernels, copies, fills). The profiler can drop
a session's first or last records, so the session opens and closes with a
burst of small padding kernels and a pause, and the window proper lies
between two ``torch.cuda._sleep`` markers (``spin_kernel``): from the end of
the first to the start of the last. The start marker spins long enough for
the host to queue the first epochs behind it, so the window opens on queued
work. A session whose markers are not both there is run again, up to three
times in all.

The summary: the device's busy seconds (the union of every device operation
in the window), the window's seconds, each operation's seconds by name, and
the idle time summed by what ended each gap: the harness span in which the
next operation was launched (its runtime call, matched by correlation id)
and that operation.
"""

from __future__ import annotations

import bisect
import json
import time
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Tuple

import torch

MARKER = "spin_kernel"  # the kernel of torch.cuda._sleep
START_SPIN = 2_000_000  # cycles, ~1 ms: the host queues the first epochs meanwhile
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
NAME_CHARS = 160
SESSIONS = 3  # profiler sessions tried before the window is given up


def traced_window(launches: Sequence[Tuple[str, Callable[[], object]]], seconds: float, device: torch.device,
                  out: Path) -> Optional[dict]:
    """Epochs of ``launches`` (each labelled, each called once an epoch) for
    ``seconds`` of host time, at least two, inside one profiler session;
    the summary, or None when no session kept its markers."""
    from torch.profiler import ProfilerActivity, profile, record_function

    pad = torch.zeros(1, device=device)

    def padding():
        for _ in range(256):
            pad.add_(1)
        torch.cuda.synchronize(device)
        time.sleep(0.1)

    out.parent.mkdir(parents=True, exist_ok=True)
    for _ in range(SESSIONS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            padding()
            torch.cuda._sleep(START_SPIN)
            n, t0 = 0, time.perf_counter()
            while n < 2 or time.perf_counter() - t0 < seconds:
                with record_function("epoch"):
                    for label, fn in launches:
                        with record_function(label):
                            fn()
                n += 1
            torch.cuda._sleep(1)
            torch.cuda.synchronize(device)
            padding()
        prof.export_chrome_trace(str(out))
        with open(out) as f:
            summary = summarize(json.load(f)["traceEvents"], n)
        if summary is not None:
            return summary
    return None


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], e))
        else:
            merged.append((s, e))
    return merged


def summarize(events: list, epochs: int) -> Optional[dict]:
    """The window's summary from a Chrome trace's events (times in us), or
    None without both markers."""
    dev = sorted((e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS),
                 key=lambda e: float(e["ts"]))
    marks = [e for e in dev if MARKER in e["name"]]
    if len(marks) < 2:
        return None
    w0 = float(marks[0]["ts"]) + float(marks[0]["dur"])
    w1 = float(marks[-1]["ts"])
    ops = [e for e in dev if MARKER not in e["name"] and w0 <= float(e["ts"]) < w1]
    if not ops or w1 <= w0:
        return None
    spans = [(max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1)) for e in ops]
    busy = _union(spans)
    op_s: dict = {}
    for e in ops:
        name = e["name"][:NAME_CHARS]
        op_s[name] = op_s.get(name, 0.0) + float(e["dur"]) * 1e-6
    # the launch call of each correlation id, and the harness's spans
    launch_ts = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime", "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch_ts[corr] = float(e["ts"])
    annotations = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]

    def host_span(op) -> str:
        ts = launch_ts.get((op.get("args") or {}).get("correlation"))
        if ts is None:
            return "launch not traced"
        inner = [a for a in annotations if float(a["ts"]) <= ts <= float(a["ts"]) + float(a["dur"])]
        return min(inner, key=lambda a: float(a["dur"]))["name"] if inner else "outside the harness's spans"

    starts = [float(e["ts"]) for e in ops]
    gaps: dict = {}
    edges = [w0] + [x for s, e in busy for x in (s, e)] + [w1]
    for k in range(0, len(edges), 2):
        g0, g1 = edges[k], edges[k + 1]
        if g1 > g0:
            j = bisect.bisect_left(starts, g1)
            nxt = ops[j] if j < len(ops) else None
            name = "window end" if nxt is None else f"{host_span(nxt)} -> {nxt['name'][:NAME_CHARS]}"
            gaps[name] = gaps.get(name, 0.0) + (g1 - g0) * 1e-6
    return {
        "epochs": epochs,
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "op_s": op_s,
        "gaps": sorted(gaps.items(), key=lambda g: -g[1]),
    }
