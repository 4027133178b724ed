"""The traced window's summary from a Chrome trace: the window between the
markers, the device's busy union, time by operation, gaps by host span."""

import pytest

from h100bench import devtrace


def dev(name, ts, dur, corr=None):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur, "args": {"correlation": corr}}


def host(cat, name, ts, dur, corr=None):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": {"correlation": corr}}


EVENTS = [
    dev("vectorized_elementwise_kernel", 0, 1),  # padding, outside the window
    dev("spin_kernel", 10, 90),  # the window opens at 100
    dev("void k1_kernel<0>(Params)", 100, 40, corr=1),
    dev("void k1_kernel<0>(Params)", 130, 20, corr=2),  # overlaps: the union counts 100..150 once
    {"ph": "X", "cat": "gpu_memset", "name": "Memset", "ts": 160, "dur": 10},
    dev("void k1_kernel<1>(Params)", 200, 90, corr=3),
    dev("void k1_kernel<1>(Params)", 295, 5, corr=3),
    dev("spin_kernel", 320, 1),  # the window closes at 320
    dev("vectorized_elementwise_kernel", 400, 1),
    host("user_annotation", "epoch", 50, 200),
    host("user_annotation", "bucket pn=2560 x 59", 180, 5),
    host("cuda_runtime", "cudaLaunchKernelExC", 182, 1, corr=3),
]


def test_summary():
    s = devtrace.summarize(EVENTS, epochs=2)
    assert s["epochs"] == 2
    assert s["window_s"] == pytest.approx(220e-6)
    assert s["busy_s"] == pytest.approx((50 + 10 + 95) * 1e-6)
    assert s["op_s"]["void k1_kernel<0>(Params)"] == pytest.approx(60e-6)
    assert s["op_s"]["Memset"] == pytest.approx(10e-6)
    assert s["op_s"]["void k1_kernel<1>(Params)"] == pytest.approx(95e-6)
    names = [g[0] for g in s["gaps"]]
    lengths = [g[1] for g in s["gaps"]]
    # 170..200 and 290..295 end in the same launch; 300..320; 150..160
    assert lengths == pytest.approx([35e-6, 20e-6, 10e-6])
    assert names[0] == "bucket pn=2560 x 59 -> void k1_kernel<1>(Params)"
    assert names[1] == "window end"
    assert names[2] == "launch not traced -> Memset"


def test_no_markers_no_summary():
    assert devtrace.summarize([e for e in EVENTS if e["name"] != "spin_kernel"], 2) is None
