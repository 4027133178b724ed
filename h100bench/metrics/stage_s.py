"""Seconds of the engine's staging (buckets and weights onto the device)
plus the first epoch and its synchronize, on the harness's clock."""


def read(ctx):
    return ctx["spans"].get("stage_s")
