"""K1's share of its roofline, in percent: the floor of the batches K1 ran
(the buckets that did not fall back; per batch the larger of its operations
over the int8 peak and its bytes over the HBM peak) over K1's device time an
epoch in the traced window."""

KERNEL = "k1_kernel"


def read(ctx):
    tr, floors = ctx["trace"], ctx["batch_floor_s"]
    if tr is None or floors is None:
        return None
    k1_s = sum(s for name, s in tr["op_s"].items() if KERNEL in name) / tr["epochs"]
    if k1_s <= 0:
        return None
    floor_s = sum(floors[i] for b in ctx["buckets"] if not b["fallback"] for i in b["index"])
    return 100.0 * floor_s / k1_s
