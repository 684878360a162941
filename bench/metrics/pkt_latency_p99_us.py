"""99th percentile over every packet due in the window of the time from its
scheduled arrival to its verdict on the host (the ``on_retire`` tap); a
packet dropped or never served counts as infinitely late."""

import numpy as np


def read(ctx):
    lat = ctx["latency_us"]
    if lat is None or lat.size == 0:
        return None
    return float(np.quantile(lat, 0.99, method="higher"))
