"""Host time inside ``DataplaneRuntime.dispatch`` (RSS hash, ring pushes)
per 1000 packets dispatched in the window."""


def read(ctx):
    if not ctx["emitted"]:
        return None
    return ctx["dispatch_s"] * 1e6 / (ctx["emitted"] / 1e3)
