"""Bounded per-queue packet rings with explicit conservation accounting
(torch port: the reference's host ring; the device rings of the megastep
are not ported yet).

The AF_XDP analogue: each hardware queue drains into a fixed-size UMEM
fill ring; when producers outrun the consumer the NIC tail-drops and the
drop is *counted*, never silent.  The ring is host-side NumPy (packets are
staged here before a tick moves a batch onto the device), FIFO within a
queue, and keeps four monotonic counters whose invariants the runtime
audits after every scenario:

    offered   == admitted + dropped          (at the producer edge)
    admitted  == completed + occupancy       (nothing vanishes in flight)

``push`` admits a burst prefix and tail-drops the suffix; ``pop`` returns
up to ``max_n`` rows in arrival order together with their enqueue
timestamps (for latency accounting); ``mark_completed`` is called by the
runtime once the popped rows have actually been processed, so a crash
between pop and completion shows up as an audit failure instead of a
silently shrinking packet count.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import packet as pkt


@dataclasses.dataclass
class RingCounters:
    offered: int = 0    # rows presented to push()
    admitted: int = 0   # rows accepted into the ring
    dropped: int = 0    # rows tail-dropped (ring full)
    completed: int = 0  # rows processed and retired by the runtime

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class PacketRing:
    """Bounded FIFO ring of fixed-format packet rows."""

    def __init__(self, capacity: int, *, packet_words: int = pkt.PACKET_WORDS):
        if capacity < 1:
            raise ValueError("ring capacity must be >= 1")
        self.capacity = int(capacity)
        self._buf = np.zeros((self.capacity, packet_words), np.uint32)
        self._ts = np.zeros(self.capacity, np.float64)
        self._head = 0  # next row to pop
        self._size = 0
        self.counters = RingCounters()

    def __len__(self) -> int:
        return self._size

    @property
    def free(self) -> int:
        return self.capacity - self._size

    def push(self, packets: np.ndarray, now: float = 0.0) -> int:
        """Admit a burst prefix in arrival order; tail-drop the rest.

        Returns the number of admitted rows (the first ``n`` of the burst).
        """
        packets = np.asarray(packets)
        n_offered = packets.shape[0]
        n = min(n_offered, self.free)
        c = self.counters
        c.offered += n_offered
        c.admitted += n
        c.dropped += n_offered - n
        tail = (self._head + self._size) % self.capacity
        first = min(n, self.capacity - tail)
        self._buf[tail : tail + first] = packets[:first]
        self._ts[tail : tail + first] = now
        if n > first:  # wrap
            self._buf[: n - first] = packets[first:n]
            self._ts[: n - first] = now
        self._size += n
        return n

    def pop(self, max_n: int) -> tuple[np.ndarray, np.ndarray]:
        """Dequeue up to ``max_n`` rows FIFO -> (packets, enqueue_ts) copies."""
        n = min(max_n, self._size)
        head = self._head
        if head + n <= self.capacity:  # contiguous: plain slice copies
            out = self._buf[head : head + n].copy()
            ts = self._ts[head : head + n].copy()
        else:
            idx = (head + np.arange(n)) % self.capacity
            out = self._buf[idx].copy()
            ts = self._ts[idx].copy()
        self._head = (head + n) % self.capacity
        self._size -= n
        return out, ts

    def mark_completed(self, n: int) -> None:
        self.counters.completed += int(n)

    def conservation(self, *, in_flight: int = 0) -> dict:
        """Counter snapshot + the two ring invariants (see module docstring).

        ``in_flight`` is rows the consumer has popped but not yet retired
        (the pipelined runtime's device stage); they extend the consumer
        invariant to ``admitted == completed + occupancy + in_flight`` so
        conservation is checkable at any instant, not just when drained.
        """
        c = self.counters
        return {
            **c.as_dict(),
            "occupancy": self._size,
            "in_flight": int(in_flight),
            "producer_ok": c.offered == c.admitted + c.dropped,
            "consumer_ok": c.admitted == c.completed + self._size + in_flight,
        }

    def ok(self) -> bool:
        s = self.conservation()
        return bool(s["producer_ok"] and s["consumer_ok"])
