"""Per-host lease/heartbeat health monitor for the mesh barrier (torch port).

The mesh cannot ask a dead host whether it is dead; all it observes at
tick granularity is whether each host served its tick (a *heartbeat*)
or failed to (a *miss*).  ``HealthMonitor`` turns that stream into a
per-host lease state machine:

    HEALTHY --misses >= suspect_after--> SUSPECT
    HEALTHY/SUSPECT --misses >= lease_ticks--> DEAD
    DEAD --successful re-probe--> RECOVERING
    RECOVERING --clean heartbeat--> HEALTHY
    SUSPECT --clean_to_clear consecutive heartbeats--> HEALTHY

Misses are consecutive and deduplicated per (host, tick): a host that is
both unresponsive *and* blocking a barrier in the same tick burns one
tick of lease, not two.  DEAD hosts are re-probed with exponential
backoff (``probe_interval`` doubling up to ``probe_max``), so a crashed
host costs O(log t) probes, not one per tick.

The monitor is pure bookkeeping — it never touches the data plane.  The
mesh reads the transitions returned by ``observe()`` to synthesize
failover epochs (on ``-> dead``) and resync/restore (on
``-> recovering``), and consults ``state()`` to pick barrier
participants.  Everything is deterministic in the heartbeat/miss
stream, so faulted runs replay bit-exactly.
"""

from __future__ import annotations

import dataclasses
import enum


class HostState(enum.Enum):
    HEALTHY = "healthy"
    SUSPECT = "suspect"
    DEAD = "dead"
    RECOVERING = "recovering"


@dataclasses.dataclass(frozen=True)
class Transition:
    tick: int
    host: int
    frm: str
    to: str
    reason: str

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class _Lease:
    state: HostState = HostState.HEALTHY
    misses: int = 0                 # consecutive missed ticks
    clean: int = 0                  # consecutive clean heartbeats
    last_seen: int = -1
    last_miss_tick: int = -1
    died_at: int | None = None
    probe_at: int | None = None     # next re-probe tick (while DEAD)
    probe_gap: int = 0


class HealthMonitor:
    def __init__(self, num_hosts: int, *, lease_ticks: int = 8,
                 suspect_after: int = 2, clean_to_clear: int = 2,
                 probe_interval: int = 2, probe_factor: int = 2,
                 probe_max: int = 64):
        if num_hosts < 1:
            raise ValueError("num_hosts must be >= 1")
        if lease_ticks < 1 or suspect_after < 1:
            raise ValueError("lease_ticks and suspect_after must be >= 1")
        if suspect_after > lease_ticks:
            raise ValueError(f"suspect_after ({suspect_after}) must not "
                             f"exceed lease_ticks ({lease_ticks})")
        self.num_hosts = num_hosts
        self.lease_ticks = lease_ticks
        self.suspect_after = suspect_after
        self.clean_to_clear = clean_to_clear
        self.probe_interval = probe_interval
        self.probe_factor = probe_factor
        self.probe_max = probe_max
        self._leases = [_Lease() for _ in range(num_hosts)]
        self.transitions: list[Transition] = []
        self.total_misses = 0
        self.total_probes = 0
        # observability tap: called with each Transition as it happens —
        # obs.attach wires this into a TelemetryStream as health events
        self.on_transition = None

    def _move(self, tick: int, host: int, to: HostState,
              reason: str) -> Transition:
        lease = self._leases[host]
        tr = Transition(tick=tick, host=host, frm=lease.state.value,
                        to=to.value, reason=reason)
        lease.state = to
        self.transitions.append(tr)
        if self.on_transition is not None:
            self.on_transition(tr)
        return tr

    # -- the tick-granularity observation stream -----------------------------

    def heartbeat(self, host: int, tick: int) -> None:
        """The host served this tick.  A miss already recorded for the
        same tick wins (partially-responsive counts against the lease)."""
        lease = self._leases[host]
        if lease.last_miss_tick == tick:
            return
        lease.last_seen = tick
        lease.misses = 0
        lease.clean += 1
        if lease.state is HostState.RECOVERING:
            self._move(tick, host, HostState.HEALTHY, "rejoined")
        elif (lease.state is HostState.SUSPECT
              and lease.clean >= self.clean_to_clear):
            self._move(tick, host, HostState.HEALTHY, "lease renewed")

    def miss(self, host: int, tick: int) -> None:
        """The host failed to serve this tick (unresponsive, or blocking
        a pending epoch barrier).  Deduplicated per (host, tick)."""
        lease = self._leases[host]
        if lease.last_miss_tick == tick or lease.state is HostState.DEAD:
            return
        lease.last_miss_tick = tick
        lease.misses += 1
        lease.clean = 0
        self.total_misses += 1

    def mark_suspect(self, host: int, tick: int, reason: str) -> None:
        """Out-of-band suspicion (e.g. a dropped commit ack)."""
        lease = self._leases[host]
        if lease.state is HostState.HEALTHY:
            lease.clean = 0
            self._move(tick, host, HostState.SUSPECT, reason)

    def observe(self, tick: int, probe=None) -> list[Transition]:
        """Advance the state machine; returns this call's transitions.

        ``probe(host) -> bool`` is consulted for DEAD hosts whose
        backoff timer has expired; a successful probe moves the host to
        RECOVERING (the caller must resync it before it serves again).
        """
        out: list[Transition] = []
        for host, lease in enumerate(self._leases):
            if lease.state in (HostState.HEALTHY, HostState.SUSPECT):
                if lease.misses >= self.lease_ticks:
                    lease.died_at = tick
                    lease.probe_gap = self.probe_interval
                    lease.probe_at = tick + lease.probe_gap
                    out.append(self._move(
                        tick, host, HostState.DEAD,
                        f"lease expired ({lease.misses} missed ticks)"))
                elif (lease.misses >= self.suspect_after
                      and lease.state is HostState.HEALTHY):
                    out.append(self._move(
                        tick, host, HostState.SUSPECT,
                        f"{lease.misses} missed ticks"))
            elif (lease.state is HostState.DEAD and probe is not None
                  and lease.probe_at is not None and tick >= lease.probe_at):
                self.total_probes += 1
                if probe(host):
                    lease.misses = 0
                    lease.clean = 0
                    out.append(self._move(tick, host, HostState.RECOVERING,
                                          "probe succeeded"))
                else:
                    lease.probe_gap = min(
                        lease.probe_gap * self.probe_factor, self.probe_max)
                    lease.probe_at = tick + lease.probe_gap
        return out

    # -- queries -------------------------------------------------------------

    def state(self, host: int) -> HostState:
        return self._leases[host].state

    def is_dead(self, host: int) -> bool:
        return self._leases[host].state is HostState.DEAD

    def dead_hosts(self) -> tuple[int, ...]:
        return tuple(h for h, le in enumerate(self._leases)
                     if le.state is HostState.DEAD)

    def live_hosts(self) -> tuple[int, ...]:
        return tuple(h for h, le in enumerate(self._leases)
                     if le.state is not HostState.DEAD)

    @property
    def ever_missed(self) -> bool:
        return self.total_misses > 0

    def snapshot(self) -> dict:
        return {
            "lease_ticks": self.lease_ticks,
            "suspect_after": self.suspect_after,
            "total_misses": self.total_misses,
            "total_probes": self.total_probes,
            "hosts": [{"host": h, "state": le.state.value,
                       "misses": le.misses, "last_seen": le.last_seen,
                       "died_at": le.died_at}
                      for h, le in enumerate(self._leases)],
            "transitions": [t.as_dict() for t in self.transitions],
        }
