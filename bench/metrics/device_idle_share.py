"""The card's idle share, %: 1 - device-busy time (the union of every
device activity in the traced sub-window) over the wall time.  In a closed
loop the wall time is per packet served, taken outside the traced
sub-window (the profiler slows the host); in an open loop, whose rate is
fixed, it is the sub-window's length."""


def read(ctx):
    sub = ctx["sub"]
    if sub is None or sub["served"] <= 0:
        return None
    if ctx["closed"]:
        busy = sub["busy_s"] / sub["served"] * sub["served_rate_unprofiled"]
    else:
        busy = sub["busy_s"] / sub["wall_s"]
    return 100.0 * (1.0 - busy)
