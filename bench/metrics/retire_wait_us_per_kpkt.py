"""The wait for the device: host time in the program's span
``dp.retire.wait`` (the tick's event) per 1000 packets served, traced
sub-window."""

from benchkit.program_spans import us_per_kpkt


def read(ctx):
    return us_per_kpkt(ctx, [("dp.retire.wait", "total_s")], "dp.tick.stage")
