"""The retire's own host work: the self time of the program's span
``dp.retire`` with ``dp.retire.d2h`` (result copies) and
``dp.retire.account`` (telemetry, ring completion, record), not the caller's
``dp.retire.tap``, per 1000 packets served, traced sub-window."""

from benchkit.program_spans import us_per_kpkt


def read(ctx):
    parts = [("dp.retire", "self_s"), ("dp.retire.d2h", "total_s"),
             ("dp.retire.account", "total_s")]
    return us_per_kpkt(ctx, parts, "dp.tick.stage")
