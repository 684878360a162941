"""The arrival edge's hash: host time in the program's span
``dp.dispatch.hash`` (flow words, Toeplitz hash, buckets, RETA lookup) per
1000 packets dispatched (``dp.dispatch``'s rows), traced sub-window."""

from benchkit.program_spans import us_per_kpkt


def read(ctx):
    return us_per_kpkt(ctx, [("dp.dispatch.hash", "total_s")], "dp.dispatch")
