"""Multi-host mesh data plane: one facade over per-host runtime shards
(torch port).

``MeshDataplane`` lifts the single-host
`repro_torch.dataplane.runtime.DataplaneRuntime` to ``hosts`` runtime
shards, each with its own rings, fan-out and telemetry, behind one facade
with the runtime's API (``dispatch``/``tick``/``drain``/
``audit_conservation``/``snapshot``/``control``), so scenarios, policies,
traces and benchmarks drive a mesh and a single host the same way.  Every
shard sits on the mesh's one ``device`` (CUDA unless the caller asks for
the CPU) and serves through the port's fused kernel; there is no placement
per host.

**Cross-host RSS.**  Each of the 128 RETA buckets resolves to a global
queue id ``gid = host * Q + queue`` (``rss.global_queue_id``), so the mesh
table over ``H * Q`` ids is the single-host table over more queues: the
round-robin default, affinity-preserving failover and restore are the same
code, and ``MeshDataplane(hosts=1)`` is bit-identical to
``DataplaneRuntime``.  ``dispatch`` hashes each burst ONCE, counts bucket
load at mesh level only, and hands every shard its share with the resolved
local ids (``gid % Q``); each shard also holds the local projection of the
mesh table so its own RETA state stays valid.

**Epoch-barrier control fan-out.**  The facade implements the runtime
protocol `repro_torch.control.ControlPlane` drives, so ONE ``submit``
broadcasts an epoch to every host under a two-phase barrier:
``_validate_command`` stages it (mesh-scope checks, then every shard
validates its projection; one rejection rejects the epoch before anything
mutates), and ``_apply_command`` commits it to every host between the same
two mesh ticks, after ``retire_all`` has made every shard quiescent.
``_control_state`` snapshots mesh-wide, so a commit that fails on any host
rolls back every host.  Applied epochs carry ``host_ticks``, the per-host
apply tick, all equal on a healthy mesh.  SwapSlot payloads are prestaged
into every live shard's shadow bank at submit (``_prestage_epoch``) and
published by each shard's flip in ``_finish_epoch``.

**Fault-tolerant barriers.**  Each host holds a tick-granularity lease
(`repro_torch.control.health.HealthMonitor`): serving a tick heartbeats it,
failing to (unresponsive, or blocking a pending barrier) burns it.  A
straggler defers the barrier until it recovers or its lease expires; a DEAD
host gets a synthesized ``FailQueues`` epoch for its global ids, and
pending epochs commit *degraded* over a quorum of live, acked hosts
(``commit_mode``; losing quorum rolls the epoch back).  Dead hosts are
re-probed with exponential backoff; one that answers is resynced (bank
copied through ``adopt_bank``, RETA projection reinstalled, stale in-flight
work retired) before a ``RestoreQueues`` epoch gives its queues back, and
the conservation audit counts its parked rows as ``stranded`` while it is
down.  Faults come from `repro_torch.dataplane.faults.FaultInjector`; with
none armed the all-equal barrier stamp is a hard invariant.
"""

from __future__ import annotations

import math
import time

import numpy as np

from repro_torch.control import (ControlPlane, FailQueues, HealthMonitor,
                                 HostState, NonFatalControlError, ProgramReta,
                                 RestoreQueues, SetPolicy, SwapSlot)
from repro_torch.dataplane import rss
from repro_torch.dataplane import runtime as runtime_mod
from repro_torch.dataplane import telemetry as telemetry_mod
from repro_torch.dataplane.runtime import DataplaneRuntime
from repro_torch.device import resolve_device


class QuorumLost(NonFatalControlError):
    """Fewer live hosts acked a commit than the configured quorum: the
    epoch rolls back atomically and the run continues (non-fatal — a
    partitioned mesh refusing to commit is an outcome, not a bug)."""


class _MeshCounters:
    """Mesh-level control counters + live cross-host audit aggregation.

    ``slot_swaps``/``reta_updates`` count mesh *commands* (one broadcast
    = one event), while ``wrong_verdict`` sums the per-host audit
    counters live — the shape ``ControlPlane`` and ``continuity_audit``
    expect from a runtime's ``telemetry``.
    """

    def __init__(self, shards):
        self._shards = shards
        self.slot_swaps = 0
        self.reta_updates = 0
        self.degraded_commits = 0

    @property
    def wrong_verdict(self) -> int:
        return sum(s.telemetry.wrong_verdict for s in self._shards)


class MeshDataplane:
    """``hosts`` DataplaneRuntime shards behind one runtime-shaped facade.

    ``num_queues`` is *per host*; the mesh exposes ``hosts * num_queues``
    global queues (``self.num_queues``), and every queue-addressed
    control command (``ProgramReta`` / ``FailQueues`` / ``RestoreQueues``)
    speaks global ids.  Remaining keyword arguments (strategy, fanout,
    batch, ring_capacity, audit, record, pipeline_depth, ...) pass
    through to every shard; ``policy`` is held at mesh level and sees
    the merged, global-id view.

    ``megastep_ticks > 1`` puts every shard in deferred (megastep) mode:
    each host serves its staged tick windows with one fused launch per
    window *between* epoch barriers; the barrier's ``retire_all`` is the
    per-shard flush point, so a committing epoch still observes every
    shard quiescent, and mesh-level fault injection (leases, quorum,
    injected stalls) keeps per-tick host control because the injector stays
    with the mesh and never reaches the shards.

    ``device=None`` means CUDA (``RuntimeError`` without it); the bank must
    already sit on that device, and every shard is built on it.
    """

    def __init__(self, bank, *, hosts: int, num_queues: int,
                 policy=None, fault_injector=None, lease_ticks: int = 8,
                 suspect_after: int = 2, quorum: int | None = None,
                 megastep_ticks: int = 1,
                 log_capacity: int | None = None,
                 log_spill: str | None = None, device=None, **runtime_kw):
        if hosts < 1:
            raise ValueError("need at least one host")
        self.device = resolve_device(device)
        self.hosts = int(hosts)
        self.num_queues_per_host = int(num_queues)
        self.num_queues = self.hosts * self.num_queues_per_host
        self.rss_key = runtime_kw.get("rss_key", rss.DEFAULT_KEY)
        # shards never get the policy: rebalancing happens once, at mesh
        # scope, over global ids — not per host over local ids
        self.shards = [
            DataplaneRuntime(bank, num_queues=self.num_queues_per_host,
                             megastep_ticks=megastep_ticks,
                             device=self.device, **runtime_kw)
            for _ in range(self.hosts)
        ]
        self.reta = rss.mesh_indirection_table(
            self.hosts, self.num_queues_per_host)
        self.failed_queues: set[int] = set()     # global ids
        self.bucket_load = np.zeros(len(self.reta), np.int64)
        self.policy = policy
        self.telemetry = _MeshCounters(self.shards)
        self.control = ControlPlane(self, log_capacity=log_capacity,
                                    spill_path=log_spill)
        self._faults = fault_injector
        self.lease_ticks = int(lease_ticks)
        self.quorum = (int(quorum) if quorum is not None
                       else math.ceil(self.hosts / 2))
        if not 1 <= self.quorum <= self.hosts:
            raise ValueError(f"quorum must be in [1, {self.hosts}]")
        self.health = HealthMonitor(self.hosts, lease_ticks=self.lease_ticks,
                                    suspect_after=suspect_after)
        # hosts whose queues the mesh itself failed over (vs. operator
        # FailQueues): restored automatically when the host is healthy
        self._auto_failed: set[int] = set()
        self._participants: tuple[int, ...] = tuple(range(self.hosts))
        self._barrier_deferred = False
        self._deferred_since: int | None = None
        self.failover_epochs: list[int] = []
        self.restore_epochs: list[int] = []
        self._tick_count = 0
        self._t_start: float | None = None

    # -- liveness helpers ----------------------------------------------------

    def _responsive(self, host: int, tick: int | None = None) -> bool:
        if self._faults is None:
            return True
        return self._faults.responsive(
            host, self._tick_count if tick is None else tick)

    def _barrier_ready(self, host: int) -> bool:
        """Can this host quiesce at the barrier right now?"""
        if not self._responsive(host):
            return False
        return (self._faults is None
                or not self._faults.retire_blocked(host, self._tick_count))

    def _live_hosts(self) -> tuple[int, ...]:
        return self.health.live_hosts()

    def _host_gids(self, host: int) -> tuple[int, ...]:
        q = self.num_queues_per_host
        return tuple(range(host * q, (host + 1) * q))

    def _fault_point(self, point: str) -> None:
        """Consult the injector at a stage/apply point for every commit
        participant; an armed ``ShardError`` raises ``InjectedFault``."""
        if self._faults is not None:
            for h in self._participants:
                self._faults.check(point, h, self._tick_count)

    # -- shard-projection helpers -------------------------------------------

    @property
    def num_slots(self) -> int:
        """Resident bank size (identical on every shard)."""
        return self.shards[0].num_slots

    @property
    def pipeline_depth(self) -> int:
        """Bounded in-flight tick window (identical on every shard)."""
        return self.shards[0].pipeline_depth

    @property
    def rings(self) -> list:
        """All rings in host-major global-queue order."""
        return [r for s in self.shards for r in s.rings]

    @property
    def completed_seq(self) -> list:
        """Per-tick completed sequence numbers, concatenated shard-major
        (record mode only)."""
        return [seqs for s in self.shards for seqs in s.completed_seq]

    @property
    def completed_verdicts(self) -> list:
        """Per-tick verdict arrays, concatenated shard-major (record
        mode only) — the bit-exact replay/equivalence signal."""
        return [v for s in self.shards for v in s.completed_verdicts]

    @property
    def completed_slots(self) -> list:
        """Per-tick served-slot arrays, concatenated shard-major
        (record mode only)."""
        return [v for s in self.shards for v in s.completed_slots]

    @property
    def dropped_seq(self) -> list[int]:
        """Sequence numbers of tail-dropped packets across all shards
        (record mode only)."""
        return [x for s in self.shards for x in s.dropped_seq]

    def _shard_reta(self, reta: np.ndarray) -> np.ndarray:
        """Project the mesh RETA onto a host-local table: ``gid % Q`` is
        the exact queue for buckets the host owns and an in-range (but
        never-dispatched-to) value for buckets other hosts own.  The
        projection is host-independent, so one table serves every shard;
        mesh dispatch hands shards resolved queue ids directly, but the
        projection keeps each shard's own RETA state valid.
        """
        return (np.asarray(reta, np.int64)
                % self.num_queues_per_host).astype(np.int32)

    # -- control plane: the runtime protocol ControlPlane drives ------------

    def _validate_command(self, cmd) -> None:
        """STAGE phase of the two-phase broadcast: validate at mesh scope
        (global-id ranges), then stage the per-host projection on EVERY
        shard without mutating any — a single host's rejection rejects
        the whole epoch before any host commits.  Only the current
        barrier participants stage: a DEAD host cannot be asked, and its
        stale state is resynced wholesale when it rejoins."""
        self._fault_point("stage")
        if isinstance(cmd, SwapSlot):
            for h in self._participants:
                self.shards[h]._validate_command(cmd)
        elif isinstance(cmd, ProgramReta):
            reta = np.asarray(cmd.reta, np.int32)
            if reta.size == 0:
                raise ValueError("empty RETA")
            if reta.min() < 0 or reta.max() >= self.num_queues:
                raise ValueError("RETA entry out of global queue range")
            proj = ProgramReta(tuple(self._shard_reta(reta)))
            for h in self._participants:
                self.shards[h]._validate_command(proj)
        elif isinstance(cmd, (FailQueues, RestoreQueues)):
            if any(not 0 <= q < self.num_queues for q in cmd.queues):
                raise ValueError("queue id out of global range")
        elif isinstance(cmd, SetPolicy):
            if cmd.policy is not None and not hasattr(cmd.policy, "propose"):
                raise TypeError("policy must implement propose(view)")
        else:
            raise TypeError(f"not a control command: {cmd!r}")

    def _apply_command(self, cmd) -> None:
        """COMMIT phase: apply ONE mesh command to every host between the
        same two mesh ticks.  Only ``ControlPlane.apply_pending`` calls
        this; its mesh-wide ``_control_state`` snapshot makes a commit
        that fails on any host roll back every host."""
        self._fault_point("apply")
        if isinstance(cmd, SwapSlot):
            for h in self._participants:
                self.shards[h]._apply_command(cmd)
            self.telemetry.slot_swaps += 1
        elif isinstance(cmd, ProgramReta):
            self._install_reta(np.asarray(cmd.reta, np.int32))
        elif not runtime_mod.apply_routing_command(self, cmd):
            # the shared appliers see the mesh's global queue count and
            # its projecting _install_reta — the same audited code path
            # as the single-host runtime, over more queues
            raise TypeError(f"not a control command: {cmd!r}")

    def _install_reta(self, reta: np.ndarray) -> None:
        reta = np.asarray(reta, np.int32)
        if reta.min() < 0 or reta.max() >= self.num_queues:
            raise ValueError("RETA entry out of global queue range")
        proj = ProgramReta(tuple(self._shard_reta(reta)))
        for h in self._participants:
            self.shards[h]._apply_command(proj)
        if len(reta) != len(self.bucket_load):
            self.bucket_load = np.zeros(len(reta), np.int64)
        self.reta = reta
        self.telemetry.reta_updates += 1

    def _control_state(self) -> dict:
        """Mesh-wide snapshot: facade state plus every shard's control
        state, so a rejected epoch rolls back atomically across hosts."""
        return dict(
            reta=self.reta, failed=set(self.failed_queues),
            policy=self.policy, bucket_load=self.bucket_load,
            slot_swaps=self.telemetry.slot_swaps,
            reta_updates=self.telemetry.reta_updates,
            shards=[s._control_state() for s in self.shards],
        )

    def _rollback_control_state(self, st: dict) -> None:
        self.reta = st["reta"]
        self.failed_queues = st["failed"]
        self.policy = st["policy"]
        self.bucket_load = st["bucket_load"]
        self.telemetry.slot_swaps = st["slot_swaps"]
        self.telemetry.reta_updates = st["reta_updates"]
        for s, ss in zip(self.shards, st["shards"]):
            s._rollback_control_state(ss)

    def _apply_control(self) -> None:
        """Epoch-barrier commit: retire every in-flight tick on every
        live host (the barrier — all participating shards quiescent at
        one agreed mesh tick boundary), then apply the pending epochs.

        A live host that cannot reach the barrier right now (stalled, or
        its retire is injected-delayed) *defers* the whole commit — but
        every deferred tick burns a tick of that host's lease, so the
        deferral is bounded by ``lease_ticks``: the straggler either
        recovers or is declared DEAD at a coming ``observe``, at which
        point the epoch commits degraded over the survivors.  Each
        epoch's barrier stamp and commit mode are recorded per-epoch by
        ``_finish_epoch`` (called by ``ControlPlane.apply_pending``
        inside the transaction)."""
        if not self.control.has_pending:
            self._barrier_deferred = False
            self._deferred_since = None
            return
        tick = self._tick_count
        live = self._live_hosts()
        blocked = [h for h in live if not self._barrier_ready(h)]
        if blocked:
            self._barrier_deferred = True
            if self._deferred_since is None:
                self._deferred_since = tick
            for h in blocked:
                self.health.miss(h, tick)
            return
        self._barrier_deferred = False
        self._deferred_since = None
        self._participants = tuple(live)
        self.retire_all()
        self.control.apply_pending(tick)

    def _finish_epoch(self, rec) -> None:
        """Per-epoch commit finish, called inside the ``apply_pending``
        transaction after the last command applied: collect commit acks
        (the ``commit-ack`` injection point), enforce quorum, stamp the
        barrier proof and the commit mode.  Raising here rolls the epoch
        back on every host like any apply-time failure."""
        # barrier commit: every participant publishes its staged SwapSlot
        # params by flipping its double-buffered bank, O(1) per host with no
        # weights moved.  A quorum failure below rolls the flips back
        # through the mesh-wide snapshot.
        for h in self._participants:
            self.shards[h]._finish_epoch(rec)
        tick = self._tick_count
        dropped = [h for h in self._participants
                   if self._faults is not None
                   and self._faults.drop_ack(h, tick)]
        acked = [h for h in self._participants if h not in dropped]
        if len(acked) < self.quorum:
            raise QuorumLost(
                f"{len(acked)}/{self.hosts} commit acks "
                f"(quorum {self.quorum}) for epoch {rec.epoch}")
        host_ticks = tuple(s._tick_count for s in self.shards)
        part_ticks = {host_ticks[h] for h in self._participants}
        if len(part_ticks) > 1 and not self.health.ever_missed:
            # on a healthy mesh the all-equal stamp is a hard invariant;
            # once hosts have missed ticks their counters lag by design
            raise RuntimeError(f"shard tick drift across hosts: {host_ticks}")
        rec.host_ticks = host_ticks
        degraded = len(self._participants) < self.hosts or bool(dropped)
        rec.commit_mode = "degraded" if degraded else "atomic"
        if degraded:
            self.telemetry.degraded_commits += 1
        for h in dropped:
            # an applied-but-unacked host cannot be trusted with traffic
            # until it proves itself again: suspect it and fail it over
            self.health.mark_suspect(h, tick, "commit ack dropped")
            self._ensure_failover(h)

    # -- host failover / rejoin ---------------------------------------------

    def _ensure_failover(self, host: int) -> None:
        """Synthesize a ``FailQueues`` epoch for the host's global queue
        ids (those not already failed).  Synthesized epochs are internal
        — like policy rebalances they are NOT recorded into traces; a
        replay's own health layer regenerates them deterministically."""
        gids = tuple(g for g in self._host_gids(host)
                     if g not in self.failed_queues)
        self._auto_failed.add(host)
        if not gids:
            return
        survivors = (set(range(self.num_queues)) - self.failed_queues
                     - set(gids))
        if not survivors:
            return   # nothing to fail over to; leave routing untouched
        self.failover_epochs.append(self.control.submit(FailQueues(gids)))

    def _restore_host(self, host: int) -> None:
        gids = tuple(g for g in self._host_gids(host)
                     if g in self.failed_queues)
        self._auto_failed.discard(host)
        if gids:
            self.restore_epochs.append(
                self.control.submit(RestoreQueues(gids)))

    def _resync_shard(self, host: int) -> None:
        """A rejoining host's shard missed every epoch committed while it
        was DEAD: copy the bank from a live reference shard, reinstall
        the current RETA projection, and retire its stale in-flight work
        (stranded pre-crash packets complete instead of vanishing)."""
        shard = self.shards[host]
        ref = next((h for h in range(self.hosts) if h != host
                    and not self.health.is_dead(h)), None)
        if ref is not None:
            # copy, never alias: under double buffering each shard owns
            # its two device buffers, and an aliased bank would be staged
            # into and flipped under the reference shard
            shard.adopt_bank(self.shards[ref].bank)
        shard._install_reta(self._shard_reta(self.reta))
        # in deferred mode this flush closes the shard's window, and the
        # close resyncs its device RETA mirror with the table just
        # installed (which bypassed the window's epoch deltas)
        shard.retire_all()

    @property
    def barrier_log(self) -> list[dict]:
        """The barrier history, derived from the epoch log (no second
        always-growing list to keep consistent)."""
        return [{"epoch": r.epoch, "mesh_tick": r.applied_tick,
                 "host_ticks": list(r.host_ticks)}
                for r in self.control.log
                if r.applied and r.host_ticks is not None]

    def _tick_boundary(self) -> None:
        tick = self._tick_count
        for tr in self.health.observe(tick,
                                      probe=lambda h: self._responsive(h)):
            if tr.to == HostState.DEAD.value:
                self._ensure_failover(tr.host)
            elif tr.to == HostState.RECOVERING.value:
                self._resync_shard(tr.host)
        for h in sorted(self._auto_failed):
            if self.health.state(h) is HostState.HEALTHY:
                self._restore_host(h)
        self._apply_control()
        runtime_mod.consult_policy(self, num_hosts=self.hosts)

    def flush_control(self) -> None:
        """Force-apply pending epochs now (host code runs between ticks)."""
        self._apply_control()

    def _prestage_epoch(self, rec) -> None:
        """Broadcast staging overlap (``ControlPlane.submit`` hook): fan
        the epoch's SwapSlot payloads to every live shard's shadow bank at
        submit time, so the mesh barrier commit is a pointer flip on every
        host instead of a per-host bank re-stage.  Dead
        hosts are skipped; they re-adopt the bank at rejoin resync."""
        for h in range(self.hosts):
            if not self.health.is_dead(h):
                self.shards[h]._prestage_epoch(rec)

    # -- data plane ---------------------------------------------------------

    def dispatch(self, packets_np: np.ndarray, now: float | None = None) -> dict:
        """RSS-dispatch one arrival burst across hosts.

        ONE Toeplitz hash resolves every flow through the mesh RETA to a
        (host, queue); each shard then admits its share through its own
        rings exactly as a single-host runtime would, taking the already-
        resolved local queue ids (the burst is never hashed twice).  The
        arrival edge is a mesh tick boundary: pending epochs commit first.
        """
        self._apply_control()
        if self._t_start is None:
            self._t_start = time.perf_counter()
        packets_np = np.asarray(packets_np)
        h = rss.toeplitz_hash(rss.flow_words_of(packets_np), self.rss_key)
        bucket = rss.bucket_index(h, len(self.reta)).astype(np.int64)
        self.bucket_load += np.bincount(bucket, minlength=len(self.reta))
        host, queue = rss.split_host_queue(self.reta[bucket],
                                           self.num_queues_per_host)
        per_host = []
        for i, s in enumerate(self.shards):
            mine = host == i
            per_host.append(
                s.dispatch(packets_np[mine], now=now, queues=queue[mine]))
        return {"per_host": per_host,
                "dropped": sum(p["dropped"] for p in per_host)}

    def tick(self) -> int:
        """One lockstep tick of every live, responsive host shard (each
        keeps its own bounded dispatch/device/retire pipeline).  Serving
        a tick heartbeats the host's lease; failing to burns it.  DEAD
        hosts are skipped entirely until a re-probe rejoins them."""
        t = self._tick_count
        self._tick_boundary()
        self._tick_count += 1
        total = 0
        for h, s in enumerate(self.shards):
            if self.health.is_dead(h):
                continue
            if not self._responsive(h, t):
                self.health.miss(h, t)
                continue
            total += s.tick()
            self.health.heartbeat(h, t)
        return total

    def retire_all(self) -> None:
        """Flush the pipeline of every shard that can flush — live,
        responsive, and not retire-blocked (the cross-host barrier
        point).  A host that cannot flush keeps its in-flight rows;
        conservation accounts them (``in_flight`` / ``stranded``)."""
        for h, s in enumerate(self.shards):
            if (not self.health.is_dead(h) and self._responsive(h)
                    and (self._faults is None or not
                         self._faults.retire_blocked(h, self._tick_count))):
                s.retire_all()

    def in_flight_rows(self) -> list[int]:
        """Rows popped but not retired, host-major global-queue order."""
        return [n for s in self.shards for n in s.in_flight_rows()]

    def drain(self, max_ticks: int = 100_000) -> int:
        """Tick until every ring on every live host is empty and no
        barrier is deferred, then flush.  Backlog on DEAD hosts does not
        block convergence — it stays stranded (and conserved) until the
        host rejoins; stalled-but-live hosts are waited for (bounded by
        their lease)."""
        done = 0
        for _ in range(max_ticks):
            n = self.tick()
            done += n
            live_rings = [r for h in range(self.hosts)
                          if not self.health.is_dead(h)
                          for r in self.shards[h].rings]
            if (n == 0 and not any(len(r) for r in live_rings)
                    and not self._barrier_deferred):
                self.retire_all()
                return done
        raise RuntimeError("drain did not converge")

    # -- audit + reporting --------------------------------------------------

    def audit_conservation(self) -> dict:
        """Mesh-wide packet conservation: per-host audits, a flattened
        per-queue view in global order, and totals summed across hosts —
        ``offered == admitted + dropped`` and ``admitted == completed +
        occupancy + in_flight`` must hold per host and in aggregate."""
        per_host = [s.audit_conservation() for s in self.shards]
        totals = {k: sum(h["totals"][k] for h in per_host)
                  for k in ("offered", "admitted", "dropped", "completed",
                            "occupancy", "in_flight")}
        dead = self.health.dead_hosts()
        stranded = sum(per_host[h]["totals"]["occupancy"]
                       + per_host[h]["totals"]["in_flight"] for h in dead)
        return {
            "per_host": per_host,
            "per_queue": [q for h in per_host for q in h["per_queue"]],
            "totals": totals,
            # packets admitted to now-DEAD hosts, conserved but parked
            # until the host rejoins (kept out of ``totals`` so a healthy
            # mesh's audit is bit-identical to the single-host runtime's)
            "stranded": {"packets": stranded, "hosts": list(dead)},
            "ok": all(h["ok"] for h in per_host),
            "wrong_verdict": self.telemetry.wrong_verdict,
        }

    def snapshot(self) -> dict:
        """One-call mesh report: aggregated telemetry, the mesh-wide
        conservation audit, health/lease state, and control stats."""
        elapsed = (time.perf_counter() - self._t_start
                   if self._t_start is not None else None)
        merged = telemetry_mod.merge([s.telemetry for s in self.shards])
        out = merged.snapshot(elapsed_s=elapsed)
        # broadcast commands count once, not once per host
        out["slot_swaps"] = self.telemetry.slot_swaps
        out["reta_updates"] = self.telemetry.reta_updates
        out["degraded_commits"] = self.telemetry.degraded_commits
        out["hosts"] = self.hosts
        out["queues_per_host"] = self.num_queues_per_host
        out["conservation"] = self.audit_conservation()
        out["health"] = self.health.snapshot()
        out["fault_events"] = (list(self._faults.events)
                               if self._faults is not None else [])
        out["fanout"] = self.shards[0].fanout
        out["strategy"] = self.shards[0].strategy
        out["pipeline_depth"] = self.pipeline_depth
        out["policy"] = getattr(self.policy, "name", None)
        out["control"] = self.control.stats()
        return out
