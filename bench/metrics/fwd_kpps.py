"""Packets given a verdict per second in a closed loop: every packet retired
inside the window over the window, in thousands."""


def read(ctx):
    if not ctx["closed"]:
        return None
    return ctx["retired_window"] / ctx["window_s"] / 1e3
