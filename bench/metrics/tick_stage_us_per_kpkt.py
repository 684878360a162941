"""The tick's staging: host time in the program's spans ``dp.tick.pop``
(ring pops) and ``dp.tick.stage`` (``_pad``, ``np.stack``) per 1000 packets
served (``dp.tick.stage``'s rows), traced sub-window."""

from benchkit.program_spans import us_per_kpkt


def read(ctx):
    return us_per_kpkt(ctx, [("dp.tick.pop", "total_s"), ("dp.tick.stage", "total_s")], "dp.tick.stage")
