"""The decode step's wall time, ms: the median host time of a
``ServeEngine.step`` that admitted nothing (one decode of every active row:
the host state copied in, the layers, the head, the next tokens read
back) inside the window."""

import numpy as np


def read(ctx):
    s = ctx.get("decode_step_s")
    if s is None or s.size == 0:
        return None
    return float(np.median(s)) * 1e3
