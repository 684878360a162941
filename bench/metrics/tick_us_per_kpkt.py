"""Host time inside ``DataplaneRuntime.tick`` (pop, pad, copy, the
``packet_step`` launches, the wait for the device, retire) per 1000 packets
those window ticks served."""


def read(ctx):
    if not ctx["served_window"]:
        return None
    return ctx["tick_s"] * 1e6 / (ctx["served_window"] / 1e3)
