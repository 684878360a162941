"""The fused forward kernel's share of its roofline, %: the least time the
card needs for the work of the packets served in the traced sub-window
(``benchkit.roofline``: rows read once, results written once, the bank read
once per tick; d x H binary MACs per row) over the device time of the
kernels whose name holds ``PATTERN``."""

from benchkit import roofline

PATTERN = "fused_forward"


def read(ctx):
    sub = ctx["sub"]
    if sub is None or sub["served"] <= 0:
        return None
    kernel_s = sum(s for n, s in sub["device_s_by_name"].items() if PATTERN in n)
    if kernel_s <= 0:
        return None
    m = ctx["model"]
    nbytes, macs = roofline.fused_work(
        sub["served"], sub["ticks"], d_bits=m["d_bits"], hidden=m["hidden"],
        n_out=m["n_out"], num_slots=ctx["num_slots"])
    return 100.0 * roofline.least_seconds(nbytes, macs) / kernel_s
