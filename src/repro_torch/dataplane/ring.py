"""Bounded per-queue packet rings with explicit conservation accounting
(torch port: the reference's host ring, and the megastep's device rings).

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
import torch

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


# ---------------------------------------------------------------------------
# Device-resident rings (the megastep's mirror of the host rings)
# ---------------------------------------------------------------------------
#
# Plain torch index ops over a dict of tensors on one device, so a whole
# window of ring traffic runs on the device with no host synchronisation:
#
#     {"buf":  (Q * capacity + 1, words) int32, flattened queue-major, with
#              one sink row at index Q * capacity,
#      "head": (Q,) int64,  "size": (Q,) int64}
#
# Semantics are those of ``PacketRing``: FIFO within a queue, burst-prefix
# admission, tail drop when full.  The host ``PacketRing`` stays
# authoritative for counters and timestamps; these ops reproduce the row
# content and order it predicts, and the megastep checks the two agree on
# pop counts at every flush.  Nothing here indexes with a boolean mask (on
# CUDA that calls ``nonzero`` and waits for the device): rows that are not
# admitted are written to the sink row instead.

def device_rings(num_queues: int, capacity: int, *,
                 packet_words: int = pkt.PACKET_WORDS, device=None) -> dict:
    """Fresh empty device ring state for ``num_queues`` rings."""
    return {
        "buf": torch.zeros((num_queues * capacity + 1, packet_words),
                           dtype=torch.int32, device=device),
        "head": torch.zeros(num_queues, dtype=torch.int64, device=device),
        "size": torch.zeros(num_queues, dtype=torch.int64, device=device),
    }


def device_push(rings: dict, rows: torch.Tensor, qids: torch.Tensor, count,
                *, capacity: int) -> dict:
    """Push a mixed-queue burst: ``rows[i]`` goes to ring ``qids[i]`` for
    ``i < count``; per-queue arrival order is burst order; each queue
    admits ``min(offered, free)`` and tail-drops the rest (``PacketRing.push``
    run per queue on the burst's subsets).  ``count`` may be a 0-d device
    tensor.  Writes ``rings["buf"]`` in place; returns the new state."""
    buf, head, size = rings["buf"], rings["head"], rings["size"]
    num_queues = head.shape[0]
    dev = buf.device
    qids = qids.to(torch.int64)
    valid = torch.arange(rows.shape[0], device=dev) < count
    # (Q, bmax): the scan runs along the contiguous axis, which CUDA scans
    # fast; a scan down the burst axis of a (bmax, Q) tensor is a slow kernel
    onehot = ((qids[None, :] == torch.arange(num_queues, device=dev)[:, None])
              & valid[None, :]).to(torch.int64)
    # rank of row i within its queue's subset of this burst
    rank = torch.cumsum(onehot, dim=1) - 1
    ri = torch.gather(rank, 0, qids[None, :])[0]
    offered = onehot.sum(dim=1)
    free = capacity - size
    admit = valid & (ri < free[qids])
    dest = (head[qids] + size[qids] + ri) % capacity
    sink = num_queues * capacity
    buf.index_copy_(0, torch.where(admit, qids * capacity + dest, sink),
                    rows)
    size = size + torch.minimum(offered, free.clamp_min(0))
    return {"buf": buf, "head": head, "size": size}


def device_pop(rings: dict, batch, width: int, *, capacity: int):
    """Pop up to ``batch`` rows FIFO from every ring and compact them
    queue-major into one ``(width, words)`` batch with no per-queue padding:
    row ``p`` is row ``p - offset[q]`` of queue ``q``'s pop, where ``q`` is
    the queue whose range covers ``p``.

    Returns ``(rings', popped, qq, pvalid, n)``: ``qq`` the per-row queue
    id, ``pvalid`` the compaction's validity mask and ``n`` the (Q,)
    per-queue pop counts.  ``width`` must be at least the total popped (the
    caller sizes it from the host mirror); ``batch`` may be a 0-d device
    tensor (the megastep pops 0 on padded steps)."""
    buf, head, size = rings["buf"], rings["head"], rings["size"]
    num_queues = head.shape[0]
    dev = buf.device
    n = torch.minimum(size, torch.as_tensor(batch, device=dev))
    csum = torch.cumsum(n, dim=0)
    off = csum - n                                          # exclusive
    pos = torch.arange(width, device=dev)
    qq = torch.searchsorted(csum, pos, right=True).clamp(0, num_queues - 1)
    pvalid = pos < csum[-1]
    rk = torch.where(pvalid, pos - off[qq], 0)
    popped = buf[qq * capacity + (head[qq] + rk) % capacity]
    out = {"buf": buf, "head": (head + n) % capacity, "size": size - n}
    return out, popped, qq, pvalid, n
