"""Host milliseconds an epoch: the window's host time, from the first launch
to the final synchronize, over every epoch completed in it."""


def read(ctx):
    w = ctx["window"]
    return w["seconds"] * 1e3 / w["epochs"]
