"""Per-layer metrics read from the program's own spans.

A traced run's readers may be handed ``ctx["spans"]``: the data plane's
``SpanRecorder.summary()`` over the traced sub-window (per span name:
``count``, ``total_s``, ``self_s``, ``parent`` and the summed counts such as
``rows``), or None where the run recorded none.  ``us_per_kpkt`` turns the
time of some spans into host microseconds per 1000 rows of another span.
"""

from __future__ import annotations


def us_per_kpkt(ctx, parts, rows_of: str):
    """Host µs of ``parts`` (pairs of span name and ``"total_s"`` or
    ``"self_s"``) per 1000 rows counted by span ``rows_of``; None where the
    run has no spans or ``rows_of`` counted no row.  A part that never ran
    adds nothing."""
    spans = ctx.get("spans")
    if not spans:
        return None
    rows = spans.get(rows_of, {}).get("rows", 0)
    if not rows:
        return None
    seconds = sum(spans.get(name, {}).get(field, 0.0) for name, field in parts)
    return seconds * 1e6 / (rows / 1e3)
