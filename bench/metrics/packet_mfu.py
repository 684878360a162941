"""The whole step's share of the card's binary peak, %: every packet retired
in the window x d x H binary MACs over the window x the frozen
``b1.and.popc`` rate."""

from benchkit import roofline


def read(ctx):
    if not ctx["closed"] or not ctx["retired_window"]:
        return None
    m = ctx["model"]
    return roofline.packet_mfu_percent(ctx["retired_window"], ctx["window_s"],
                                       d_bits=m["d_bits"], hidden=m["hidden"])
