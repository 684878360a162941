"""Workload generator library: parameterized regimes -> phase lists
(torch port).

Every regime is a pure function from parameters to ``Phase`` values —
command scripts over the five typed control commands — so new regimes
compose with routing policies, chaos events and the trace recorder for
free.  The phase lists equal the reference's field by field, at any
``hosts`` (queue ids are global over ``hosts * num_queues``); the port's
runtime plays them at ``hosts=1``.  The catalog:

* ``emergency``            — the canonical 4-phase storyline (steady ->
                             flash crowd -> link failover -> slot churn);
* ``elephant-skew``        — a few heavy flows rejection-sampled onto one
                             queue (the imbalance a static RETA cannot fix);
* ``cascading-failover``   — host dies -> buckets remap -> a second host
                             degrades under the absorbed load -> recovery;
* ``diurnal``              — a sampled sinusoidal day/night load curve;
                             the slot mix tracks the curve (day traffic
                             prefers the triage slot, night the updated
                             model), the regime the Emergency-HRL traces
                             replay;
* ``flash-crowd``          — an isolated surge: calm -> ramp -> spike
                             (x6 load collapsing onto few flows) -> decay;
* ``slot-thrash``          — adversarial control storm: a command epoch
                             EVERY tick (alternating ``SwapSlot`` and
                             rotated ``ProgramReta``) racing the epoch
                             barrier while traffic flows;
* ``chaos-queue-surge``    — a queue dies at the *peak* of a flash crowd
                             (mid-phase chaos event) and is restored two
                             ticks later;
* ``chaos-host-failover``  — an entire host's queues drop between two
                             barrier ticks mid-surge, then return;
* ``file-replay``          — the recorded-trace converter: ingests a file
                             corpus (``$REPRO_WORKLOAD_CORPUS`` when
                             set) and derives phases + payload
                             pools from the actual bytes;
* ``barrier-straggler``    — a host's retire is injected-delayed past its
                             lease while a command storm races the epoch
                             barrier: deferral -> lease expiry -> degraded
                             quorum commit + synthesized failover -> rejoin;
* ``crash-mid-commit``     — a host drops its commit ack and crashes the
                             next tick, mid-surge: degraded commit,
                             stranded packets conserved on the dead host.

The scripted ``chaos-*`` regimes express failures as *command* chaos
(typed ``FailQueues``/``RestoreQueues`` epochs the operator could have
sent); the two fault regimes express them as *injected* chaos — a
``Workload.fault_plan`` armed into the runtime's ``FaultInjector``
(`repro_torch.dataplane.faults`); on a mesh the reference's health layer
synthesizes the failover/restore epochs itself, and on one host both
regimes degenerate to a short injected stall.

``make_workload`` is the one registry entry point; ``REGIME_NAMES`` is
what callers enumerate to cover every regime.
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np

from repro_torch.control import FailQueues, ProgramReta, RestoreQueues, SwapSlot
from repro_torch.core import packet as pkt
from repro_torch.dataplane import faults as faults_mod
from repro_torch.dataplane import rss
from repro_torch.dataplane.workloads.phases import ChaosEvent, Phase


def _uniform(num_slots: int) -> tuple[float, ...]:
    return tuple(1.0 / num_slots for _ in range(num_slots))


def _peaked(num_slots: int, slot: int, weight: float) -> tuple[float, ...]:
    rest = (1.0 - weight) / max(num_slots - 1, 1)
    return tuple(weight if i == slot % num_slots else rest
                 for i in range(num_slots))


# ---------------------------------------------------------------------------
# the original storylines (moved verbatim from scenarios.py)
# ---------------------------------------------------------------------------

def emergency_phases(num_slots: int, *, scale: int = 1) -> list[Phase]:
    """The canonical 4-phase emergency storyline (steady -> flash crowd ->
    link failover -> slot-churn recovery)."""
    uniform = _uniform(num_slots)
    # flash crowd: traffic collapses onto slot 0 (the triage model)
    crowd = _peaked(num_slots, 0, 0.7)
    # recovery: the updated model (slot 1 if present) takes over
    churn_slot = 1 % num_slots
    recovery = _peaked(num_slots, churn_slot, 0.6)
    return [
        Phase("steady", ticks=8, burst=128 * scale, flows=64,
              slot_mix=uniform),
        Phase("flash_crowd", ticks=8, burst=512 * scale, flows=8,
              slot_mix=crowd, monitor_frac=0.1),
        Phase("link_failover", ticks=8, burst=256 * scale, flows=64,
              slot_mix=uniform, failed_queues=(0,)),
        Phase("slot_churn", ticks=8, burst=128 * scale, flows=64,
              slot_mix=recovery, swap_slot=churn_slot),
    ]


def elephant_skew_phases(
    num_slots: int,
    num_queues: int,
    *,
    scale: int = 1,
    ticks: int = 12,
    elephant_queue: int = 0,
) -> list[Phase]:
    """Elephant-flow skew: a few heavy flows all hash to one queue.

    A short uniform warmup, then a sustained phase where 4 elephant
    flows (rejection-sampled to land on ``elephant_queue`` under the
    default RETA) carry ~85% of a burst sized well above one queue's
    drain rate — the canonical imbalance a static RETA cannot fix and an
    adaptive policy must.
    """
    uniform = _uniform(num_slots)
    return [
        Phase("warmup", ticks=2, burst=64 * scale, flows=32,
              slot_mix=uniform),
        Phase("skew", ticks=ticks, burst=256 * scale, flows=32,
              slot_mix=uniform, elephant_flows=4,
              elephant_queue=elephant_queue, elephant_frac=0.85),
    ]


def cascading_failover_phases(
    num_slots: int,
    *,
    hosts: int,
    queues_per_host: int,
    scale: int = 1,
) -> list[Phase]:
    """Cascading host failover at mesh scale, in global queue ids.

    The mesh storyline: a steady
    baseline, then an entire host dies at once (all of its queues fail,
    so its RETA buckets remap across the surviving hosts), then a second
    host *degrades* under the absorbed load (half its queues fail on
    top), then service restores with a slot swap — composed entirely
    from the existing typed commands via ``phase_commands``.  On a
    1-host mesh it degenerates to a two-queue cascade (needs >= 3
    queues so a survivor remains).
    """
    total = hosts * queues_per_host
    uniform = _uniform(num_slots)
    if hosts > 1:
        dead_host = tuple(range(queues_per_host))            # host 0, entirely
        degraded = tuple(queues_per_host + q                 # half of host 1
                         for q in range((queues_per_host + 1) // 2))
    else:
        dead_host, degraded = (0,), (1,)
    if total - len(dead_host) - len(degraded) < 1:
        raise ValueError(
            "cascading failover would leave zero live (host, queue) pairs; "
            "add hosts or queues")
    return [
        Phase("steady", ticks=6, burst=128 * scale, flows=64,
              slot_mix=uniform),
        Phase("host_down", ticks=6, burst=192 * scale, flows=64,
              slot_mix=uniform, failed_queues=dead_host),
        Phase("cascade", ticks=6, burst=192 * scale, flows=64,
              slot_mix=uniform, failed_queues=dead_host + degraded),
        Phase("recovery", ticks=6, burst=128 * scale, flows=64,
              slot_mix=uniform, swap_slot=1 % num_slots),
    ]


# ---------------------------------------------------------------------------
# further regimes
# ---------------------------------------------------------------------------

def diurnal_phases(
    num_slots: int,
    *,
    scale: int = 1,
    steps: int = 8,
    ticks_per_step: int = 3,
    base: int = 96,
    amplitude: float = 0.75,
    flows: int = 48,
) -> list[Phase]:
    """A sampled diurnal (day/night) load curve.

    ``steps`` phases sample one full sinusoidal period starting at the
    nightly minimum; the slot mix tracks the curve — daytime traffic
    leans on slot 0 (triage), nighttime on slot ``1 % num_slots`` (the
    maintenance/updated model) — so load level and model demand co-vary
    the way the Emergency-HRL recorded traces do.
    """
    phases = []
    night_slot = 1 % num_slots
    for t in range(steps):
        # phase-shifted so step 0 is the minimum (deep night)
        level = 1.0 + amplitude * math.sin(
            2.0 * math.pi * t / steps - math.pi / 2.0)
        burst = max(16, int(round(base * scale * level)))
        day = 0.5 * (1.0 + math.sin(2.0 * math.pi * t / steps - math.pi / 2.0))
        mix = tuple(
            day * d + (1.0 - day) * n
            for d, n in zip(_peaked(num_slots, 0, 0.7),
                            _peaked(num_slots, night_slot, 0.7)))
        phases.append(Phase(f"diurnal_{t:02d}", ticks=ticks_per_step,
                            burst=burst, flows=flows, slot_mix=mix))
    return phases


def flash_crowd_phases(num_slots: int, *, scale: int = 1) -> list[Phase]:
    """An isolated flash-crowd surge: calm -> ramp -> spike -> decay.

    The spike collapses 6x the calm load onto 6 flows (everyone
    retransmitting the same few streams), with a heavy triage-slot mix
    and a sprinkling of monitor-only probes — the demand cliff the
    paper's switching latency argument is about.
    """
    uniform = _uniform(num_slots)
    crowd = _peaked(num_slots, 0, 0.8)
    return [
        Phase("calm", ticks=4, burst=64 * scale, flows=48, slot_mix=uniform),
        Phase("ramp", ticks=3, burst=160 * scale, flows=24, slot_mix=crowd),
        Phase("spike", ticks=5, burst=384 * scale, flows=6,
              slot_mix=crowd, monitor_frac=0.15),
        Phase("decay", ticks=3, burst=128 * scale, flows=24,
              slot_mix=uniform),
        Phase("after", ticks=3, burst=64 * scale, flows=48,
              slot_mix=uniform),
    ]


def slot_thrash_phases(
    num_slots: int,
    num_queues: int,
    *,
    scale: int = 1,
    storm_ticks: int = 8,
) -> list[Phase]:
    """Adversarial slot thrash: a command storm racing the epoch barrier.

    During the storm phase EVERY tick carries its own chaos epoch,
    alternating ``SwapSlot`` (rotating through the resident bank) and
    ``ProgramReta`` (the default table rolled by one bucket) — the
    worst-case control-plane arrival rate, submitted while packets are
    in flight.  The runtime's guarantee under test: every epoch still
    applies atomically at a tick boundary and no packet ever takes a
    wrong verdict, no matter how hard the control plane thrashes.
    """
    uniform = _uniform(num_slots)
    default = rss.indirection_table(num_queues)
    storm = []
    for t in range(storm_ticks):
        if t % 2 == 0:
            cmds: tuple = (SwapSlot(t // 2 % num_slots, None),)
        else:
            cmds = (ProgramReta(tuple(np.roll(default, 1 + t // 2))),)
        storm.append(ChaosEvent(at_tick=t, commands=cmds))
    return [
        Phase("steady", ticks=3, burst=96 * scale, flows=32,
              slot_mix=uniform),
        Phase("thrash", ticks=storm_ticks, burst=128 * scale, flows=32,
              slot_mix=uniform, chaos=tuple(storm)),
        Phase("settle", ticks=3, burst=96 * scale, flows=32,
              slot_mix=uniform),
    ]


def chaos_queue_surge_phases(
    num_slots: int,
    num_queues: int,
    *,
    scale: int = 1,
) -> list[Phase]:
    """A queue dies at the PEAK of a flash crowd (not at phase entry).

    The surge phase carries two chaos events: the highest-indexed queue
    fails mid-surge (its buckets remap onto survivors while the rings
    are at their fullest) and is restored two ticks later.  Composed
    from ``FailQueues``/``RestoreQueues`` like every other failover.
    """
    if num_queues < 2:
        raise ValueError("chaos-queue-surge needs >= 2 queues")
    uniform = _uniform(num_slots)
    victim = num_queues - 1
    surge_ticks = 8
    chaos = (
        ChaosEvent(at_tick=surge_ticks // 2,
                   commands=(FailQueues((victim,)),)),
        ChaosEvent(at_tick=surge_ticks // 2 + 2,
                   commands=(RestoreQueues((victim,)),)),
    )
    return [
        Phase("calm", ticks=3, burst=64 * scale, flows=32,
              slot_mix=uniform),
        Phase("surge", ticks=surge_ticks, burst=256 * scale, flows=12,
              slot_mix=_peaked(num_slots, 0, 0.7), chaos=chaos),
        Phase("recovery", ticks=3, burst=64 * scale, flows=32,
              slot_mix=uniform, swap_slot=1 % num_slots),
    ]


def chaos_host_failover_phases(
    num_slots: int,
    *,
    hosts: int,
    queues_per_host: int,
    scale: int = 1,
) -> list[Phase]:
    """An entire host drops between two barrier ticks, mid-surge.

    On a mesh (hosts > 1) the chaos event fails EVERY queue of the last
    host in one epoch — global ids, exactly what a host-loss event looks
    like to the control plane — and restores them three ticks later.  On
    one host it degenerates to losing the last queue (a host is its
    queues).  The epoch lands between two mesh ticks, so the barrier
    commit (stage on all hosts, apply between the same two ticks) is
    exercised while rings are loaded.
    """
    total = hosts * queues_per_host
    if total < 2:
        raise ValueError("chaos-host-failover needs >= 2 global queues")
    uniform = _uniform(num_slots)
    if hosts > 1:
        victim = tuple((hosts - 1) * queues_per_host + q
                       for q in range(queues_per_host))
    else:
        victim = (total - 1,)
    chaos = (
        ChaosEvent(at_tick=2, commands=(FailQueues(victim),)),
        ChaosEvent(at_tick=5, commands=(RestoreQueues(victim),)),
    )
    return [
        Phase("steady", ticks=3, burst=96 * scale, flows=48,
              slot_mix=uniform),
        Phase("host_loss", ticks=8, burst=192 * scale, flows=48,
              slot_mix=uniform, chaos=chaos),
        Phase("recovery", ticks=3, burst=96 * scale, flows=48,
              slot_mix=uniform, swap_slot=1 % num_slots),
    ]


# ---------------------------------------------------------------------------
# fault regimes: failures as injector plans, not command scripts (§10)
# ---------------------------------------------------------------------------

def barrier_straggler_workload(
    num_slots: int,
    *,
    hosts: int,
    queues_per_host: int,
    scale: int = 1,
    lease_ticks: int = 8,
) -> tuple[list[Phase], "faults_mod.FaultPlan"]:
    """A barrier straggler held past its lease during a command storm.

    The storm phase submits a ``SwapSlot`` chaos epoch every other tick
    while the last host's retire is injected-delayed for longer than the
    default lease: the barrier defers (bounded — every deferred tick
    burns lease), the straggler is declared DEAD, pending epochs commit
    degraded over the survivors with a synthesized failover epoch, and
    the host rejoins (resync + restore) once the delay window closes.
    On one host the plan degenerates to a short in-lease stall: the
    barrier defers and then commits atomically — the bounded-deferral
    half of the same guarantee.
    """
    uniform = _uniform(num_slots)
    storm = tuple(ChaosEvent(at_tick=t, commands=(SwapSlot(t // 2 % num_slots,
                                                           None),))
                  for t in range(0, 12, 2))
    phases = [
        Phase("steady", ticks=4, burst=96 * scale, flows=48,
              slot_mix=uniform),
        Phase("storm", ticks=12, burst=128 * scale, flows=48,
              slot_mix=uniform, chaos=storm),
        Phase("settle", ticks=8, burst=96 * scale, flows=48,
              slot_mix=uniform),
    ]
    if hosts > 1:
        plan = faults_mod.FaultPlan(
            faults=(faults_mod.DelayRetire(hosts - 1, at_tick=8,
                                           ticks=lease_ticks + 6),),
            name="barrier-straggler")
    else:
        plan = faults_mod.FaultPlan(
            faults=(faults_mod.StallHost(0, at_tick=8,
                                         ticks=max(lease_ticks - 2, 1)),),
            name="barrier-straggler")
    return phases, plan


def crash_mid_commit_workload(
    num_slots: int,
    *,
    hosts: int,
    queues_per_host: int,
    scale: int = 1,
) -> tuple[list[Phase], "faults_mod.FaultPlan"]:
    """A host loses its commit ack and crashes one tick later, mid-surge.

    The surge phase carries ``SwapSlot`` chaos epochs; the victim host
    drops the ack for one of them (degraded commit + suspect + failover)
    and then crashes outright, leaving its ring backlog stranded — the
    conservation audit must count every stranded packet while the mesh
    keeps serving on the survivors.  On one host: a short stall instead
    (crashing the only host leaves nothing to fail over to).
    """
    uniform = _uniform(num_slots)
    surge_chaos = tuple(ChaosEvent(at_tick=t,
                                   commands=(SwapSlot(t % num_slots, None),))
                        for t in (1, 3, 5, 7))
    phases = [
        Phase("steady", ticks=3, burst=96 * scale, flows=48,
              slot_mix=uniform),
        Phase("surge", ticks=10, burst=192 * scale, flows=24,
              slot_mix=_peaked(num_slots, 0, 0.7), chaos=surge_chaos),
        Phase("aftermath", ticks=5, burst=96 * scale, flows=48,
              slot_mix=uniform),
    ]
    if hosts > 1:
        victim = hosts - 1
        plan = faults_mod.FaultPlan(
            faults=(faults_mod.DropAck(victim, at_tick=6, count=1),
                    faults_mod.CrashHost(victim, at_tick=8)),
            name="crash-mid-commit")
    else:
        plan = faults_mod.FaultPlan(
            faults=(faults_mod.StallHost(0, at_tick=6, ticks=4),),
            name="crash-mid-commit")
    return phases, plan


# ---------------------------------------------------------------------------
# recorded-file converter (workload file sets)
# ---------------------------------------------------------------------------

#: Environment variable naming the corpus root when the caller gives none.
CORPUS_ENV = "REPRO_WORKLOAD_CORPUS"

#: Passing this as the corpus root skips the filesystem search and uses the
#: deterministic synthetic corpus — benchmarks pin it so BENCH baselines
#: compare across machines with different file sets.
SYNTHETIC_CORPUS = "synthetic:"


def _synthetic_corpus(n: int = 6, seed: int = 7) -> list[tuple[str, bytes]]:
    """Deterministic fallback corpus when no file set is available: byte
    blobs with realistic size spread and non-uniform byte histograms."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        size = int(2048 * (i + 1) * (1.5 if i % 2 else 1.0))
        # zipf-ish byte distribution so per-file slot mixes differ
        raw = (rng.zipf(1.3, size) % 256).astype(np.uint8)
        out.append((f"synthetic_{i}.bin", raw.tobytes()))
    return out


def file_corpus(
    root: str | None = None,
    *,
    max_files: int = 12,
    max_bytes: int = 1 << 20,
) -> list[tuple[str, bytes]]:
    """Collect (name, bytes) workload files, deterministically ordered.

    Search order: explicit ``root``, then ``$REPRO_WORKLOAD_CORPUS``.  When
    neither names a directory with files, a deterministic synthetic corpus
    stands in so the regime stays runnable everywhere.  (The reference
    also searches one fixed directory of the machine it was written on;
    the port has no such default.)
    """
    if root == SYNTHETIC_CORPUS:
        return _synthetic_corpus()
    candidates = [root, os.environ.get(CORPUS_ENV)]
    for cand in candidates:
        if not cand or not os.path.isdir(cand):
            continue
        files = []
        for dirpath, dirnames, filenames in os.walk(cand):
            dirnames.sort()
            for fn in sorted(filenames):
                path = os.path.join(dirpath, fn)
                try:
                    size = os.path.getsize(path)
                except OSError:
                    continue
                if 0 < size:
                    files.append((os.path.relpath(path, cand), path))
        files = files[:max_files]
        if files:
            out = []
            for name, path in files:
                with open(path, "rb") as f:
                    out.append((name, f.read(max_bytes)))
            return out
    return _synthetic_corpus()


def file_replay_workload(
    num_slots: int,
    *,
    scale: int = 1,
    root: str | None = None,
    max_files: int = 12,
) -> tuple[list[Phase], np.ndarray]:
    """Convert a file corpus into (phases, payload_pool).

    Each file becomes one phase replaying its content: the payload pool
    is the corpus' actual bytes packed into 1024-B payload rows, the
    burst size tracks the file's size (bigger artifacts = heavier
    demand), the flow count tracks its distinct-1KB-block count, and the
    slot mix is derived from the file's byte histogram (each file
    exercises the resident bank differently).  Fully deterministic in
    the corpus contents.
    """
    corpus = file_corpus(root, max_files=max_files)
    blob = b"".join(data for _, data in corpus)
    row_bytes = pkt.PAYLOAD_WORDS * 4
    n_rows = max(-(-len(blob) // row_bytes), 1)
    # zero-pad the tail so any corpus size (even < one payload row) packs
    padded = blob.ljust(n_rows * row_bytes, b"\0")
    pool = np.frombuffer(padded, dtype="<u4").reshape(
        n_rows, pkt.PAYLOAD_WORDS).astype(np.uint32)
    phases = []
    for name, data in corpus:
        hist = np.bincount(np.frombuffer(data, np.uint8), minlength=256)
        per_slot = hist.reshape(num_slots, -1).sum(axis=1) if (
            256 % num_slots == 0) else np.array_split(hist, num_slots)
        weights = np.array([np.sum(s) for s in per_slot], np.float64) + 1.0
        mix = tuple(float(w) for w in weights / weights.sum())
        burst = int(np.clip(len(data) // 64, 32, 256)) * scale
        blocks = max(len(data) // 1024, 1)
        flows = int(np.clip(blocks, 4, 64))
        safe = "".join(c if c.isalnum() else "_" for c in name)[:24]
        phases.append(Phase(f"file_{safe}", ticks=2, burst=burst,
                            flows=flows, slot_mix=mix))
    return phases, pool


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Workload:
    """One generated workload: its phases, an optional payload pool
    (``None`` = per-flow random payloads), and an optional fault plan
    the caller arms into the runtime's ``FaultInjector`` (fault regimes
    only — phases stay pure traffic + command scripts either way)."""
    name: str
    phases: tuple[Phase, ...]
    payload_pool: np.ndarray | None = None
    fault_plan: "faults_mod.FaultPlan | None" = None


def _mk(name, fn):
    return name, fn


def make_workload(
    name: str,
    *,
    num_slots: int,
    num_queues: int,
    scale: int = 1,
    hosts: int = 1,
    corpus_root: str | None = None,
) -> Workload:
    """Registry entry point: regime name -> ``Workload``.

    ``num_queues`` is per host; queue-addressed phase fields (failed
    queues, elephant pinning, chaos FailQueues) are in global ids over
    ``hosts * num_queues``.
    """
    total = hosts * num_queues
    pool = None
    plan = None
    if name == "emergency":
        phases = emergency_phases(num_slots, scale=scale)
    elif name == "elephant-skew":
        phases = elephant_skew_phases(num_slots, total, scale=scale)
    elif name == "cascading-failover":
        phases = cascading_failover_phases(
            num_slots, hosts=hosts, queues_per_host=num_queues, scale=scale)
    elif name == "diurnal":
        phases = diurnal_phases(num_slots, scale=scale)
    elif name == "flash-crowd":
        phases = flash_crowd_phases(num_slots, scale=scale)
    elif name == "slot-thrash":
        phases = slot_thrash_phases(num_slots, total, scale=scale)
    elif name == "chaos-queue-surge":
        phases = chaos_queue_surge_phases(num_slots, total, scale=scale)
    elif name == "chaos-host-failover":
        phases = chaos_host_failover_phases(
            num_slots, hosts=hosts, queues_per_host=num_queues, scale=scale)
    elif name == "file-replay":
        phases, pool = file_replay_workload(
            num_slots, scale=scale, root=corpus_root)
    elif name == "barrier-straggler":
        phases, plan = barrier_straggler_workload(
            num_slots, hosts=hosts, queues_per_host=num_queues, scale=scale)
    elif name == "crash-mid-commit":
        phases, plan = crash_mid_commit_workload(
            num_slots, hosts=hosts, queues_per_host=num_queues, scale=scale)
    else:
        raise ValueError(
            f"unknown workload {name!r} (known: {list(REGIME_NAMES)})")
    return Workload(name=name, phases=tuple(phases), payload_pool=pool,
                    fault_plan=plan)


#: Every regime the registry serves.
REGIME_NAMES = (
    "emergency",
    "elephant-skew",
    "cascading-failover",
    "diurnal",
    "flash-crowd",
    "slot-thrash",
    "chaos-queue-surge",
    "chaos-host-failover",
    "file-replay",
    "barrier-straggler",
    "crash-mid-commit",
)


def make_scenario(name: str, *, num_slots: int, num_queues: int,
                  scale: int = 1, hosts: int = 1) -> list[Phase]:
    """Back-compat registry (pre-workloads API): name -> phase list."""
    return list(make_workload(name, num_slots=num_slots,
                              num_queues=num_queues, scale=scale,
                              hosts=hosts).phases)
