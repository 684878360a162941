"""The tick's host-to-device copy: host time in the program's span
``dp.tick.h2d`` per 1000 packets served, traced sub-window."""

from benchkit.program_spans import us_per_kpkt


def read(ctx):
    return us_per_kpkt(ctx, [("dp.tick.h2d", "total_s")], "dp.tick.stage")
