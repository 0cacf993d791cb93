"""The 95th percentile (nearest rank) of the times between consecutive
iteration completions over the whole window, from CUDA events recorded on
the stream after each iteration, in milliseconds."""

import math


def read(run):
    xs = sorted(run["intervals_s"])
    if not xs:
        return None
    return 1e3 * xs[math.ceil(0.95 * len(xs)) - 1]
