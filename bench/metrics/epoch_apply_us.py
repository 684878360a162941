"""Median of ``EpochRecord.apply_us`` (the program's stamp: stage, barrier,
flip of the double-buffered bank) over the window's SwapSlot epochs."""

import numpy as np


def read(ctx):
    a = ctx["epoch_apply_us"]
    return float(np.median(a)) if a.size else None
