"""Seconds of the host batcher's construction (partition, densify, reorder,
quantize, pack), on the harness's clock."""


def read(ctx):
    return ctx["spans"].get("batch_build_s")
