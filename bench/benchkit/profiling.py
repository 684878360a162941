"""Device traces: the reduction of a ``torch.profiler`` trace of a
sub-window to busy time, kernel time by name and idle gaps by what the host
was doing.

The method is ``chip_smoke.py``'s ``profile_step``, frozen here: device time
from the profiler's device activities, held against wall time taken without
the profiler (its host overhead would inflate the idle share).  ``torch`` is
imported inside the functions: the CPU tests import this module.
"""

from __future__ import annotations

import bisect

SPAN_PREFIX = "bench."


def start():
    """A started profiler over the host and the card."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    return prof


def short_name(name: str) -> str:
    """A device activity's name without template arguments and parameters."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    cut = [i for i in (name.find("<"), name.find("(")) if i > 0
           and name[i - 1] != " "]          # keep "Memcpy HtoD (Pageable ...)"
    return name[:min(cut, default=len(name))][:100]


def warm():
    """Start and stop the profiler once, so that its one-time start-up
    (the device tracing library) lands in set-up and not in the window."""
    import torch

    prof = start()
    torch.ones(1, device="cuda").add_(1)
    torch.cuda.synchronize()
    prof.stop()


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def summarize(prof, *, top: int = 10) -> dict:
    """Reduce a stopped profiler: device busy seconds (the union of every
    device activity's interval), device seconds by activity name, and the
    idle gaps between device activities, each named by the harness span and
    the innermost host operation running at the gap's middle."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.events():
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            # a host span's mirror on the device timeline is no device work
            if not (getattr(e, "is_user_annotation", False)
                    or e.name.startswith(SPAN_PREFIX)):
                dev.append((tr.start, tr.end, e.name))
        else:
            host.append((tr.start, tr.end, e.name))
    by_name: dict[str, float] = {}
    for s, e, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (e - s) * 1e-6
    short: dict[str, float] = {}
    for n, v in by_name.items():
        short[short_name(n)] = short.get(short_name(n), 0.0) + v
    busy = _union((s, e) for s, e, _ in dev)
    busy_s = sum(e - s for s, e in busy) * 1e-6
    host.sort()
    starts = [h[0] for h in host]
    spans = sorted(h for h in host if h[2].startswith(SPAN_PREFIX))
    span_starts = [s[0] for s in spans]

    def covering(items, keys, t):
        i = bisect.bisect_right(keys, t) - 1
        for j in range(i, max(i - 64, -1), -1):   # the latest start covering t
            if items[j][1] >= t:
                return items[j][2]
        return None

    gaps: dict[str, float] = {}
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = (e0 + s1) / 2
        span = covering(spans, span_starts, mid) or "harness"
        op = covering(host, starts, mid)
        label = span if op is None or op == span else f"{span}>{short_name(op)}"
        gaps[label] = gaps.get(label, 0.0) + (s1 - e0) * 1e-6
    return {
        "busy_s": busy_s,
        "device_s_by_name": by_name,
        "device_ops": sorted(short.items(), key=lambda kv: -kv[1])[:top],
        "idle_gaps": sorted(gaps.items(), key=lambda kv: -kv[1])[:top],
        "device_events": len(dev),
    }


def busy_within(prof, name: str) -> tuple[float, int]:
    """Device-busy seconds inside the harness's host spans ``bench.<name>``
    (the union of every device activity, clipped to each span) and the
    number of those spans.  A span that ends in a synchronisation holds all
    the device work it launched."""
    from torch.autograd import DeviceType

    dev, spans = [], []
    for e in prof.events():
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            if not (getattr(e, "is_user_annotation", False)
                    or e.name.startswith(SPAN_PREFIX)):
                dev.append((tr.start, tr.end))
        elif e.name == SPAN_PREFIX + name:
            spans.append((tr.start, tr.end))
    busy = _union(dev)
    starts = [b[0] for b in busy]
    total = 0
    for s0, s1 in spans:
        for b0, b1 in busy[max(bisect.bisect_right(starts, s0) - 1, 0):]:
            if b0 >= s1:
                break
            total += max(0, min(b1, s1) - max(b0, s0))
    return total * 1e-6, len(spans)
