"""Output tokens delivered per second in a serving cell: every output token
whose step ended inside the window (one a decoded row, one a prefill) over
the window."""


def read(ctx):
    if "processed_window" not in ctx:
        return None
    return ctx["served_window"] / ctx["window_s"]
