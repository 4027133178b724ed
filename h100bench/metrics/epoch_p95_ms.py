"""The 95th percentile of the window's epochs, each timed by the CUDA events
recorded on the stream between epochs (linear interpolation)."""

import numpy as np


def read(ctx):
    return float(np.percentile(ctx["window"]["epoch_ms"], 95))
