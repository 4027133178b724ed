"""The whole epoch's share of the card's int8 peak, in percent: the epoch's
operations (every GEMM of every batch at its real size, dense) over the
unprofiled window's host time an epoch times the peak."""


def read(ctx):
    peak = ctx["peak"]
    if peak is None:
        return None
    w = ctx["window"]
    return 100.0 * sum(ctx["batch_ops"]) / (w["seconds"] / w["epochs"] * peak["int8_ops"])
