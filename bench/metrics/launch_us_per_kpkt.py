"""The tick's launches: host time in the program's span
``dp.tick.launch`` (every ``packet_step`` call and the event record) per
1000 packets served, traced sub-window."""

from benchkit.program_spans import us_per_kpkt


def read(ctx):
    return us_per_kpkt(ctx, [("dp.tick.launch", "total_s")], "dp.tick.stage")
