"""Admission and prefill per request, ms: the host time of the steps that
admitted requests, less one median decode step each (the decode those steps
also ran), summed and divided by the requests they admitted."""

import numpy as np


def read(ctx):
    adm, dec = ctx.get("admit_step_s"), ctx.get("decode_step_s")
    if adm is None or adm.size == 0 or dec.size == 0 or not ctx["admitted_window"]:
        return None
    extra = adm.sum() - adm.size * float(np.median(dec))
    return 1e3 * extra / ctx["admitted_window"]
