"""The decode step's share of its HBM roofline, %: the least time of the
traced decode steps' bytes at 3.35e12 B/s (``benchkit.lm_work.decode_bytes``:
the non-embedding weights once, each distinct head slot once, the active
rows' embeddings, SSM and conv state read and written, the logits written)
over the device-busy time inside those steps' host spans, in the traced
sub-window."""

from benchkit import lm_work


def read(ctx):
    sub = ctx["sub"]
    if sub is None or not sub.get("decode_bytes") or sub.get("decode_busy_s", 0) <= 0:
        return None
    return 100.0 * sub["decode_bytes"] / lm_work.HBM_BYTES_PER_S / sub["decode_busy_s"]
