"""The arrival edge's ring pushes: host time in the program's span
``dp.dispatch.push`` (per-queue split, ``PacketRing.push``, drop taps and
accounting) per 1000 packets dispatched, traced sub-window."""

from benchkit.program_spans import us_per_kpkt


def read(ctx):
    return us_per_kpkt(ctx, [("dp.dispatch.push", "total_s")], "dp.dispatch")
