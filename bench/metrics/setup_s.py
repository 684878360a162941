"""Process start to the first timed packet: imports, the card's context,
the kernel libraries (built on a checkout's first run), weights, traffic and
the warm-up ticks."""


def read(ctx):
    return ctx["setup_s"]
