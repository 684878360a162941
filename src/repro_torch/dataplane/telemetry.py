"""Per-queue data-plane telemetry: pps, drops, verdicts, latency histograms
(torch port: host-side NumPy, as in the reference).

Counters mirror what a production data plane exports per hardware queue
(think ethtool -S / XDP stats): packets completed, drops at the ring edge,
per-slot verdict counts (how much traffic each resident model served and
how much of it was judged malicious), Pi action counts, and a log2 latency
histogram measured enqueue -> retire.  ``snapshot()`` freezes everything
into plain dicts per tick so benchmarks and the CLI can stream or diff
them without touching live state.

Two export paths coexist (DESIGN.md §11):

* ``snapshot()`` — the full frozen view, walked on demand.
* delta emission — when a sink is attached (``attach_sink``), the runtime
  calls ``emit_delta`` at retire boundaries and only the *increments*
  since the previous emission are pushed, computed from flat cursor
  arrays (one vector subtract per counter family, no per-queue dict
  walks).  With no sink attached the hot path pays a single attribute
  check.  Delta events are monotonic: summing a stream's deltas
  reproduces ``snapshot()`` totals exactly.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import packet as pkt

# log2 latency bucket edges in microseconds: [1us .. ~134s] + overflow.
LATENCY_EDGES_US = np.concatenate(
    [[0.0], 2.0 ** np.arange(0, 28), [np.inf]])

#: Runtime-level event counters every ``Telemetry`` carries.  ``merge``
#: folds each of these generically, so adding a counter here is the whole
#: contract: no hand-copied list to forget.
EVENT_COUNTERS = ("slot_swaps", "reta_updates", "wrong_verdict",
                  "runtime_ticks", "dropped_total")


class QueueTelemetry:
    """Telemetry for one queue; updated once per processed tick."""

    def __init__(self, queue: int, num_slots: int):
        self.queue = queue
        self.ticks = 0
        self.completed = 0
        self.dropped = 0  # ring-edge drops charged to this queue
        self.busy_s = 0.0
        self.per_slot_total = np.zeros(num_slots, np.int64)
        self.per_slot_malicious = np.zeros(num_slots, np.int64)
        self.actions = np.zeros(3, np.int64)  # forward / drop / flag
        self.latency_hist = np.zeros(len(LATENCY_EDGES_US) - 1, np.int64)
        self.latency_sum_us = 0.0
        self.latency_max_us = 0.0

    def record(self, slots, verdicts, actions, latency_us, tick_s: float) -> None:
        slots = np.asarray(slots)
        verdicts = np.asarray(verdicts, bool)
        actions = np.asarray(actions)
        latency_us = np.asarray(latency_us, np.float64)
        self.ticks += 1
        self.completed += len(slots)
        self.busy_s += tick_s
        np.add.at(self.per_slot_total, slots, 1)
        np.add.at(self.per_slot_malicious, slots[verdicts], 1)
        for a in (pkt.ACTION_FORWARD, pkt.ACTION_DROP, pkt.ACTION_FLAG):
            self.actions[a] += int((actions == a).sum())
        if latency_us.size:
            self.latency_hist += np.histogram(latency_us, LATENCY_EDGES_US)[0]
            self.latency_sum_us += float(latency_us.sum())
            self.latency_max_us = max(self.latency_max_us, float(latency_us.max()))

    def record_bulk(self, *, ticks: int, completed: int, per_slot_total,
                    per_slot_malicious, actions, latency_us,
                    busy_s: float) -> None:
        """Fold a whole megastep window of device-accumulated counters in
        one call: totals equal those of ``ticks`` sequential ``record``
        calls; only the wall-clock attribution (``busy_s``, latencies)
        differs, measured at flush granularity."""
        latency_us = np.asarray(latency_us, np.float64)
        self.ticks += int(ticks)
        self.completed += int(completed)
        self.busy_s += busy_s
        self.per_slot_total += np.asarray(per_slot_total, np.int64)
        self.per_slot_malicious += np.asarray(per_slot_malicious, np.int64)
        self.actions += np.asarray(actions, np.int64)
        if latency_us.size:
            self.latency_hist += np.histogram(latency_us, LATENCY_EDGES_US)[0]
            self.latency_sum_us += float(latency_us.sum())
            self.latency_max_us = max(self.latency_max_us,
                                      float(latency_us.max()))

    def latency_quantile_us(self, q: float) -> float:
        """Histogram-resolution quantile (upper bucket edge)."""
        total = int(self.latency_hist.sum())
        if not total:
            return float("nan")
        cum = np.cumsum(self.latency_hist)
        b = int(np.searchsorted(cum, q * total))
        return float(LATENCY_EDGES_US[min(b + 1, len(LATENCY_EDGES_US) - 1)])

    def snapshot(self) -> dict:
        mean_lat = self.latency_sum_us / self.completed if self.completed else float("nan")
        return {
            "queue": self.queue,
            "ticks": self.ticks,
            "completed": self.completed,
            "dropped": self.dropped,
            "busy_s": self.busy_s,
            "pps_busy": self.completed / self.busy_s if self.busy_s else 0.0,
            "per_slot_total": self.per_slot_total.tolist(),
            "per_slot_malicious": self.per_slot_malicious.tolist(),
            "actions": {
                "forward": int(self.actions[pkt.ACTION_FORWARD]),
                "drop": int(self.actions[pkt.ACTION_DROP]),
                "flag": int(self.actions[pkt.ACTION_FLAG]),
            },
            "latency_mean_us": mean_lat,
            "latency_p50_us": self.latency_quantile_us(0.50),
            "latency_p99_us": self.latency_quantile_us(0.99),
            "latency_max_us": self.latency_max_us,
        }


class _DeltaCursor:
    """Last-emitted counter values, kept as flat arrays so each
    ``emit_delta`` is a handful of vector subtracts."""

    def __init__(self, num_queues: int, num_slots: int):
        self.completed = np.zeros(num_queues, np.int64)
        self.dropped = np.zeros(num_queues, np.int64)
        self.per_slot = np.zeros((num_queues, num_slots), np.int64)
        self.actions = np.zeros((num_queues, 3), np.int64)
        self.events = dict.fromkeys(EVENT_COUNTERS, 0)
        self.seq = 0


class Telemetry:
    """All-queue telemetry plus runtime-level event counters."""

    def __init__(self, num_queues: int, num_slots: int):
        self.num_slots = num_slots
        self.queues = [QueueTelemetry(q, num_slots) for q in range(num_queues)]
        self.slot_swaps = 0
        self.reta_updates = 0
        self.wrong_verdict = 0  # audit-mode mismatches vs the exact path
        self.runtime_ticks = 0  # ticks the runtime actually served
        self.dropped_total = 0  # ring-edge drops across all queues
        # wall-clock window this telemetry covers (first/last recorded
        # event) — merge() aligns merged pps over the UNION window so an
        # uneven-ticking host (stall/crash fault) cannot skew the rate.
        self.window_start_s: float | None = None
        self.window_last_s: float | None = None
        self._sink = None
        self._cursor: _DeltaCursor | None = None

    # -- recording -------------------------------------------------------

    def touch(self, now: float) -> None:
        """Stamp the wall-clock coverage window."""
        if self.window_start_s is None:
            self.window_start_s = now
        self.window_last_s = now

    def record_tick(self, queue: int, slots, verdicts, actions,
                    latency_us, tick_s: float) -> None:
        self.queues[queue].record(slots, verdicts, actions, latency_us, tick_s)

    def record_window(self, queue: int, **kw) -> None:
        """Bulk-fold one queue's megastep window (``QueueTelemetry.record_bulk``)."""
        self.queues[queue].record_bulk(**kw)

    def record_drops(self, queue: int, count: int, now: float | None = None) -> None:
        """Charge ``count`` ring-edge drops to ``queue``."""
        if count:
            self.queues[queue].dropped += count
            self.dropped_total += count
        if now is not None:
            self.touch(now)

    # -- delta stream ----------------------------------------------------

    @property
    def has_sink(self) -> bool:
        return self._sink is not None

    def attach_sink(self, sink) -> None:
        """Start delta emission: ``sink(event_dict)`` is called by
        ``emit_delta`` with each non-empty increment.  One sink at a
        time; cursors reset on attach, so the first delta carries the
        full counters accumulated so far."""
        self._sink = sink
        self._cursor = _DeltaCursor(len(self.queues), self.num_slots)

    def detach_sink(self) -> None:
        self._sink = None
        self._cursor = None

    def emit_delta(self, *, tick: int, now: float | None = None,
                   depths=None) -> dict | None:
        """Push the increments since the previous emission to the sink.

        ``depths`` (optional, per-queue ring occupancy) is a gauge — it
        rides along uncompared.  All-zero deltas are swallowed.  Returns
        the emitted event (or None).
        """
        if self._sink is None:
            return None
        cur = self._cursor
        n = len(self.queues)
        if len(cur.completed) != n:  # queues grew (merge targets never emit)
            grown = _DeltaCursor(n, self.num_slots)
            m = len(cur.completed)
            grown.completed[:m] = cur.completed
            grown.dropped[:m] = cur.dropped
            grown.per_slot[:m] = cur.per_slot
            grown.actions[:m] = cur.actions
            grown.events, grown.seq = cur.events, cur.seq
            cur = self._cursor = grown
        completed = np.fromiter((q.completed for q in self.queues), np.int64, n)
        dropped = np.fromiter((q.dropped for q in self.queues), np.int64, n)
        per_slot = np.stack([q.per_slot_total for q in self.queues])
        actions = np.stack([q.actions for q in self.queues])
        d_completed = completed - cur.completed
        d_dropped = dropped - cur.dropped
        d_slot = per_slot - cur.per_slot
        d_actions = actions - cur.actions
        changed = np.flatnonzero(
            d_completed | d_dropped | d_slot.any(axis=1) | d_actions.any(axis=1))
        d_events = {}
        for name in EVENT_COUNTERS:
            v = getattr(self, name)
            if v != cur.events[name]:
                d_events[name] = v - cur.events[name]
                cur.events[name] = v
        if not len(changed) and not d_events:
            return None
        cur.completed, cur.dropped = completed, dropped
        cur.per_slot, cur.actions = per_slot, actions
        event = {
            "kind": "delta",
            "seq": cur.seq,
            "tick": int(tick),
            "t_s": now,
            "queues": [
                {"queue": int(q),
                 "completed": int(d_completed[q]),
                 "dropped": int(d_dropped[q]),
                 "per_slot": d_slot[q].tolist(),
                 "actions": d_actions[q].tolist(),
                 **({"depth": int(depths[q])} if depths is not None else {})}
                for q in changed
            ],
            "events": d_events,
        }
        cur.seq += 1
        self._sink(event)
        return event

    # -- freezing --------------------------------------------------------

    def snapshot(self, *, elapsed_s: float | None = None) -> dict:
        qs = [q.snapshot() for q in self.queues]
        total = sum(q["completed"] for q in qs)
        out = {
            "queues": qs,
            "completed_total": total,
            "slot_swaps": self.slot_swaps,
            "reta_updates": self.reta_updates,
            "wrong_verdict": self.wrong_verdict,
            "runtime_ticks": self.runtime_ticks,
            "dropped_total": self.dropped_total,
        }
        if elapsed_s is None and self.window_start_s is not None:
            elapsed_s = self.window_last_s - self.window_start_s
        if elapsed_s:
            out["aggregate_pps"] = total / elapsed_s
        return out


def _copy_queue(src: QueueTelemetry, queue: int) -> QueueTelemetry:
    out = QueueTelemetry(queue, len(src.per_slot_total))
    out.ticks = src.ticks
    out.completed = src.completed
    out.dropped = src.dropped
    out.busy_s = src.busy_s
    out.per_slot_total = src.per_slot_total.copy()
    out.per_slot_malicious = src.per_slot_malicious.copy()
    out.actions = src.actions.copy()
    out.latency_hist = src.latency_hist.copy()
    out.latency_sum_us = src.latency_sum_us
    out.latency_max_us = src.latency_max_us
    return out


def merge(telemetries) -> Telemetry:
    """Aggregate per-host telemetries into one mesh-wide view.

    Queues are renumbered into host-major global order (host ``h`` queue
    ``q`` lands at ``h * Q + q``, matching ``rss.global_queue_id``) and
    every counter in ``EVENT_COUNTERS`` is summed generically, so
    policies and benchmarks read one ``Telemetry`` instead of
    hand-summing per-host dicts.  The wall-clock window is the UNION of
    the input windows (min start, max last): when hosts tick unevenly
    under faults — a stalled host covers a shorter window — the merged
    ``aggregate_pps`` divides by real elapsed time, not a sum of
    per-host windows.  The result is a deep copy: mutating it never
    touches the inputs.  Note a mesh-broadcast command counts once per
    host here; the mesh facade overrides those counters with its
    command-level counts.
    """
    tels = list(telemetries)
    if not tels:
        raise ValueError("merge needs at least one telemetry")
    if len({t.num_slots for t in tels}) != 1:
        raise ValueError("cannot merge telemetries with different slot counts")
    out = Telemetry(0, tels[0].num_slots)
    for t in tels:
        for qt in t.queues:
            out.queues.append(_copy_queue(qt, len(out.queues)))
        for name in EVENT_COUNTERS:
            setattr(out, name, getattr(out, name) + getattr(t, name))
        if t.window_start_s is not None:
            out.window_start_s = (t.window_start_s
                                  if out.window_start_s is None
                                  else min(out.window_start_s, t.window_start_s))
            out.window_last_s = (t.window_last_s
                                 if out.window_last_s is None
                                 else max(out.window_last_s, t.window_last_s))
    return out
