"""95th percentile of the time of a `FramesToCV` call over every call of
the run's window (host clock, each call ending when its CV values are on
the host), with the count of calls."""

import numpy as np


def read(ctx):
    times = ctx.window.durations()
    return {"value": 1e3 * float(np.percentile(times, 95)), "n": len(times)}
