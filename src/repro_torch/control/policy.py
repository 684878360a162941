"""Pluggable routing policies: closing the loop from telemetry to RETA
(torch port: the reference's NumPy code, unchanged in behaviour).

The paper's emergency-HRL line of work (and the ROADMAP's "adaptive
per-queue routing" item) needs exactly one mechanism: observe per-queue
pressure, rewrite the indirection table, repeat.  A ``RoutingPolicy`` is
consulted by the runtime at tick boundaries with a frozen ``PolicyView``
of the telemetry it may react to; when it returns a new RETA the runtime
submits it as a ``ProgramReta`` epoch — policies never mutate anything
directly, so every rebalance is logged, versioned, and auditable like
any operator-issued command.

Policies are deterministic functions of their view (plus their own
internal deltas), so a replayed scenario reproduces the exact same
sequence of rebalance epochs.

* ``StaticReta``        — the do-nothing baseline: whatever table is
  installed stays installed.
* ``LeastDepth``        — greedy bucket migration from the deepest queue
  to the shallowest, weighted by observed per-bucket offered load.
* ``DropRateRebalance`` — reacts only to actual tail-drops: sheds the
  heaviest buckets off any queue that dropped packets since the last
  consultation onto the least-pressured survivor.
"""

from __future__ import annotations

import dataclasses
from typing import Protocol, runtime_checkable

import numpy as np


@dataclasses.dataclass(frozen=True)
class PolicyView:
    """Frozen snapshot a policy may react to (no live runtime access).

    On a mesh runtime the view spans every host: ``num_queues`` is the
    global queue count, queue-indexed arrays are in host-major global
    order, and RETA entries are global queue ids — so depth/drop policies
    written against this view rebalance across hosts without change.
    """
    tick: int
    num_queues: int
    reta: np.ndarray          # (RETA_SIZE,) current bucket -> queue map
    queue_depth: np.ndarray   # (Q,) ring occupancy at the tick boundary
    queue_dropped: np.ndarray  # (Q,) cumulative tail-drops per queue
    bucket_load: np.ndarray   # (RETA_SIZE,) cumulative offered per bucket
    failed_queues: frozenset[int] = frozenset()
    num_hosts: int = 1        # mesh host count (1 = single-host runtime)

    def live_queues(self) -> list[int]:
        return [q for q in range(self.num_queues) if q not in self.failed_queues]


@runtime_checkable
class RoutingPolicy(Protocol):
    """Protocol: ``propose`` returns a new RETA or None (keep current)."""
    name: str

    def propose(self, view: PolicyView) -> np.ndarray | None: ...


class StaticReta:
    """Baseline: never rebalances (the pre-policy behavior)."""
    name = "static"

    def propose(self, view: PolicyView) -> np.ndarray | None:
        return None


def _greedy_rebalance(reta: np.ndarray, weight: np.ndarray,
                      live: list[int], *, max_moves: int) -> np.ndarray | None:
    """Move heavy buckets from the most- to the least-loaded live queue.

    ``weight`` is the per-bucket pressure estimate; per-queue pressure is
    the sum over its buckets.  Each move takes the heaviest bucket off
    the max queue if doing so strictly reduces the max/min imbalance.
    Deterministic: ties break on the lowest queue / bucket index.
    """
    if len(live) < 2:
        return None
    reta = np.asarray(reta, np.int32).copy()
    qload = np.zeros(max(live) + 1, np.float64)
    live_mask = np.isin(reta, live)
    np.add.at(qload, reta[live_mask], weight[live_mask])
    live_arr = np.asarray(live)
    moved = False
    for _ in range(max_moves):
        loads = qload[live_arr]
        src = int(live_arr[int(np.argmax(loads))])
        dst = int(live_arr[int(np.argmin(loads))])
        if src == dst:
            break
        candidates = np.nonzero(reta == src)[0]
        if candidates.size == 0:
            break
        bucket = int(candidates[int(np.argmax(weight[candidates]))])
        w = float(weight[bucket])
        # only move if the bucket actually shrinks the imbalance: the
        # source must stay at least as loaded as the destination becomes
        if w <= 0 or qload[src] - w < qload[dst]:
            break
        reta[bucket] = dst
        qload[src] -= w
        qload[dst] += w
        moved = True
    return reta if moved else None


class LeastDepth:
    """Rebalance toward equal queue depth, weighted by recent bucket load.

    Pressure per bucket = offered packets since the last proposal; a
    queue's pressure additionally counts its current ring backlog,
    attributed to its buckets proportionally, so a queue that is already
    deep sheds load even when arrivals are momentarily quiet.
    """
    name = "least-depth"

    def __init__(self, *, interval: int = 1, max_moves: int = 32):
        self.interval = max(1, int(interval))
        self.max_moves = int(max_moves)
        self._last_load: np.ndarray | None = None

    def propose(self, view: PolicyView) -> np.ndarray | None:
        if view.tick % self.interval:
            return None
        if (self._last_load is not None
                and self._last_load.shape != view.bucket_load.shape):
            self._last_load = None  # RETA was resized: restart the deltas
        delta = (view.bucket_load if self._last_load is None
                 else view.bucket_load - self._last_load)
        self._last_load = view.bucket_load.copy()
        weight = delta.astype(np.float64)
        # spread each queue's backlog over its buckets in proportion to
        # their recent load (uniformly when the queue saw no arrivals)
        reta = np.asarray(view.reta, np.int32)
        for q in range(view.num_queues):
            mask = reta == q
            if not mask.any():
                continue
            qw = weight[mask]
            share = (qw / qw.sum() if qw.sum() > 0
                     else np.full(qw.shape, 1.0 / qw.size))
            weight[mask] += float(view.queue_depth[q]) * share
        if weight.sum() <= 0:
            return None
        return _greedy_rebalance(reta, weight, view.live_queues(),
                                 max_moves=self.max_moves)


class DropRateRebalance:
    """Shed load off queues that are actually dropping packets.

    Quieter than ``LeastDepth``: it proposes nothing while every queue
    keeps up, and rebalances by observed per-bucket load only when the
    drop counters move — the policy a conservative operator runs.
    """
    name = "drop-rate"

    def __init__(self, *, min_drops: int = 1, max_moves: int = 32):
        self.min_drops = int(min_drops)
        self.max_moves = int(max_moves)
        self._last_dropped: np.ndarray | None = None
        self._last_load: np.ndarray | None = None

    def propose(self, view: PolicyView) -> np.ndarray | None:
        dropped = view.queue_dropped.astype(np.int64)
        d_drop = (dropped if self._last_dropped is None
                  else dropped - self._last_dropped)
        self._last_dropped = dropped.copy()
        load = view.bucket_load.astype(np.float64)
        if (self._last_load is not None
                and self._last_load.shape != load.shape):
            self._last_load = None  # RETA was resized: restart the deltas
        d_load = load if self._last_load is None else load - self._last_load
        self._last_load = load.copy()
        if int(d_drop.max(initial=0)) < self.min_drops:
            return None
        weight = d_load + 1e-9  # strictly positive so moves are possible
        return _greedy_rebalance(np.asarray(view.reta, np.int32), weight,
                                 view.live_queues(), max_moves=self.max_moves)


#: CLI registry: ``--policy`` name -> constructor.
POLICIES = {
    "static": StaticReta,
    "least-depth": LeastDepth,
    "drop-rate": DropRateRebalance,
}


def make_policy(name: str) -> RoutingPolicy:
    try:
        return POLICIES[name]()
    except KeyError:
        raise ValueError(
            f"unknown policy {name!r} (known: {sorted(POLICIES)})") from None
