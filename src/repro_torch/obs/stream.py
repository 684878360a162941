"""``TelemetryStream`` — the bounded, tailable observability event bus
(torch port; plain Python, the reference's semantics).

One stream carries every event class the runtime emits:

* ``kind="delta"``  — per-queue counter increments (``telemetry.emit_delta``)
* ``kind="epoch"``  — control-plane epoch spans (``ControlPlane.on_record``)
* ``kind="health"`` — host health-lease transitions (``HealthMonitor``)

Events are plain dicts.  The stream is a fixed-capacity ring: producers
never block, old events fall off the head, and every event gets a
monotonic stream id (``sid``).  Subscribers poll with ``tail(cursor)``
— an absolute-sid cursor, so a slow subscriber that falls off the ring
observes a gap (``dropped_events`` grows) instead of corrupt data.
A ``threading.Lock`` guards the deque because the HTTP server tails from
its own threads while the run loop pushes.
"""

from __future__ import annotations

import collections
import threading


class TelemetryStream:
    """Fixed-capacity multi-subscriber event ring."""

    def __init__(self, capacity: int = 8192):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._buf: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self.next_sid = 0        # sid the NEXT pushed event will get
        self.dropped_events = 0  # events evicted by ring overflow

    def push(self, event: dict) -> int:
        """Stamp ``event`` with a stream id and append it; returns the sid."""
        with self._lock:
            sid = self.next_sid
            event["sid"] = sid
            if len(self._buf) == self.capacity:
                self.dropped_events += 1
            self._buf.append(event)
            self.next_sid = sid + 1
            return sid

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)

    def tail(self, cursor: int, limit: int = 1024) -> tuple[list[dict], int]:
        """Events with ``sid >= cursor`` (up to ``limit``) and the cursor
        to pass next time.  A cursor that has fallen off the ring resumes
        at the oldest retained event — the gap is visible as a jump in
        ``sid``."""
        with self._lock:
            if not self._buf:
                return [], max(cursor, self.next_sid)
            oldest = self._buf[0]["sid"]
            start = max(cursor, oldest)
            first = start - oldest
            out = []
            for i in range(first, len(self._buf)):
                if len(out) >= limit:
                    break
                out.append(self._buf[i])
            new_cursor = out[-1]["sid"] + 1 if out else start
            return out, new_cursor

    def latest(self, n: int = 64) -> list[dict]:
        """The most recent ``n`` events (oldest first)."""
        with self._lock:
            if n >= len(self._buf):
                return list(self._buf)
            return list(self._buf)[-n:]

    def snapshot_stats(self) -> dict:
        with self._lock:
            return {"capacity": self.capacity, "buffered": len(self._buf),
                    "next_sid": self.next_sid,
                    "dropped_events": self.dropped_events}


def attach(runtime, stream: TelemetryStream) -> None:
    """Wire a ``DataplaneRuntime`` or ``MeshDataplane`` into ``stream``.

    Per-shard telemetry sinks (delta events are tagged with their host),
    the control plane's epoch-record tap, and — on meshes — the health
    monitor's transition tap all publish into the one stream.  Idempotent
    in effect: re-attaching replaces previous taps.
    """
    from repro_torch.obs import spans

    shards = getattr(runtime, "shards", None)
    if shards is None:
        runtime.telemetry.attach_sink(
            lambda ev: stream.push(dict(ev, host=0)))
    else:
        for h, shard in enumerate(shards):
            shard.telemetry.attach_sink(
                lambda ev, h=h: stream.push(dict(ev, host=h)))
    runtime.control.on_record = \
        lambda rec: stream.push(spans.epoch_event(rec))
    health = getattr(runtime, "health", None)
    if health is not None:
        health.on_transition = \
            lambda tr: stream.push(spans.health_event(tr))


def detach(runtime) -> None:
    """Undo ``attach``: stop all emission into the stream."""
    shards = getattr(runtime, "shards", None)
    for shard in ([runtime] if shards is None else shards):
        shard.telemetry.detach_sink()
    runtime.control.on_record = None
    health = getattr(runtime, "health", None)
    if health is not None:
        health.on_transition = None
