"""Phased workload core: ``Phase`` values, trace rendering, and ``play``
(torch port).

Emergency communications traffic is not a steady stream — the FENIX /
Emergency-HRL line of work stresses exactly the regimes a disaster
produces: a calm baseline, a *flash crowd* when everyone transmits at
once, *link failover* when infrastructure dies and surviving queues absorb
remapped flows, and *slot churn* while operators push updated models into
the resident bank mid-event.  This module is the kernel every workload
regime is built from:

* a ``Phase`` describes one regime step: ticks, burst size (arrival
  rate), the number of active flows, the slot mix the traffic selects,
  queues that fail at phase entry, an optional resident-slot swap, and
  **chaos events** — typed command epochs injected at a tick *offset
  within the phase* (queue dies mid-surge, host drops between barrier
  ticks), not just at phase entry;
* ``render`` expands phases into per-tick packet bursts.  Every packet
  carries its flow tuple in reg0 words 4..7 (RSS input) and a globally
  monotonic sequence stamp in word 15, so conservation and per-queue
  ordering are checkable after the fact;
* ``phase_command_specs`` renders a phase's entry events (failover,
  restore, slot swap) as a typed control-plane command script — one
  atomic epoch.  ``SwapSlot`` specs carry ``params=None``; a
  ``swap_delivery`` materializes the delivered weights at play/replay
  time (so synthesized traces stay small and deterministic);
* ``play`` drives a runtime (single-host or mesh — same API) through a
  rendered trace, submitting each phase's command script and each chaos
  event's epoch through ``runtime.control``, and returning per-phase
  reports.  If the runtime exposes ``mark_phase`` (the trace recorder
  facade does), phase boundaries are forwarded to it so recorded traces
  keep the phase structure and its expected invariants.

Same phases + same seed -> byte-identical trace, always.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.control import FailQueues, RestoreQueues, SwapSlot
from repro_torch.core import executor, packet as pkt
from repro_torch.dataplane import rss

# reg0 spare word 15: globally monotonic emission sequence number.
SEQ_WORD = 15


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """A typed command epoch injected mid-phase, at tick offset ``at_tick``
    (0-based, before that tick's burst is dispatched).  Commands are the
    same five control-plane kinds phases compose from; ``SwapSlot`` with
    ``params=None`` is a spec materialized by ``swap_delivery``."""
    at_tick: int
    commands: tuple = ()

    def __post_init__(self):
        if self.at_tick < 0:
            raise ValueError("chaos at_tick must be >= 0")
        object.__setattr__(self, "commands", tuple(self.commands))


@dataclasses.dataclass(frozen=True)
class Phase:
    name: str
    ticks: int
    burst: int                      # packets per tick (arrival rate)
    flows: int                      # active flow count
    slot_mix: tuple[float, ...]     # per-slot selection probabilities
    failed_queues: tuple[int, ...] = ()   # queues that die at phase entry
    swap_slot: int | None = None    # resident slot replaced at phase entry
    monitor_frac: float = 0.0       # fraction sent with the monitor-only bit
    # elephant-flow skew: the first ``elephant_flows`` flows are forced
    # (by rejection-sampling their flow tuples against the default RETA)
    # to hash onto ``elephant_queue`` and carry ``elephant_frac`` of the
    # phase's packets — a few heavy flows crushing one queue.
    elephant_flows: int = 0
    elephant_queue: int | None = None
    elephant_frac: float = 0.0
    # chaos events: command epochs at tick offsets *inside* the phase
    chaos: tuple[ChaosEvent, ...] = ()


@dataclasses.dataclass
class ScenarioTrace:
    phases: list[Phase]
    bursts: list[list[np.ndarray]]  # bursts[i][t] = (burst, 272) uint32
    seed: int

    @property
    def total_packets(self) -> int:
        return sum(b.shape[0] for ph in self.bursts for b in ph)


def _sample_slots(rng, mix: tuple[float, ...], n: int) -> np.ndarray:
    p = np.asarray(mix, np.float64)
    return rng.choice(len(p), size=n, p=p / p.sum())


def _elephant_flow_words(rng, n: int, num_queues: int, queue: int) -> np.ndarray:
    """Rejection-sample ``n`` flow tuples that hash to ``queue`` under the
    default RETA (deterministic in the rng state)."""
    reta = rss.indirection_table(num_queues)
    out = np.empty((n, rss.FLOW_WORDS), np.uint32)
    filled = 0
    while filled < n:
        cand = rng.integers(0, 2**32,
                            (64 * num_queues, rss.FLOW_WORDS), dtype=np.uint32)
        h = rss.toeplitz_hash(cand)
        hits = cand[reta[rss.bucket_index(h, len(reta))] == queue]
        take = min(hits.shape[0], n - filled)
        out[filled : filled + take] = hits[:take]
        filled += take
    return out


def _sample_flows(rng, phase: Phase) -> np.ndarray:
    """Per-packet flow index; elephants carry ``elephant_frac`` of them."""
    if not phase.elephant_flows or phase.elephant_frac <= 0:
        return rng.integers(0, phase.flows, phase.burst)
    heavy = rng.random(phase.burst) < phase.elephant_frac
    elephants = rng.integers(0, phase.elephant_flows, phase.burst)
    mice = rng.integers(phase.elephant_flows, phase.flows, phase.burst)
    return np.where(heavy, elephants, mice)


def render(
    phases: list[Phase],
    *,
    num_slots: int,
    seed: int = 0,
    payload_pool: np.ndarray | None = None,
    num_queues: int | None = None,
) -> ScenarioTrace:
    """Expand phases into per-tick packet bursts (deterministic in seed).

    ``payload_pool`` (N, 256) uint32 reuses real payloads round-robin per
    flow; default is random payloads drawn per flow so a flow's packets
    are self-similar (same flow tuple, correlated payloads).
    """
    rng = np.random.default_rng(seed)
    seq = 0
    bursts: list[list[np.ndarray]] = []
    for phase in phases:
        if len(phase.slot_mix) != num_slots:
            raise ValueError(
                f"phase {phase.name!r}: slot_mix has {len(phase.slot_mix)} "
                f"entries for {num_slots} slots")
        for ev in phase.chaos:
            if ev.at_tick >= phase.ticks:
                raise ValueError(
                    f"phase {phase.name!r}: chaos event at tick "
                    f"{ev.at_tick} can never fire ({phase.ticks} ticks)")
        flow_words = rng.integers(
            0, 2**32, (phase.flows, rss.FLOW_WORDS), dtype=np.uint32)
        if phase.elephant_flows and phase.elephant_queue is not None:
            if num_queues is None:
                raise ValueError(
                    f"phase {phase.name!r} pins elephant flows to a queue; "
                    "render(..., num_queues=...) is required")
            if not 0 <= phase.elephant_queue < num_queues:
                raise ValueError(
                    f"phase {phase.name!r}: elephant_queue "
                    f"{phase.elephant_queue} out of range for "
                    f"{num_queues} queues")  # rejection sampling would spin
            if phase.elephant_flows >= phase.flows:
                raise ValueError(
                    f"phase {phase.name!r}: needs elephant_flows "
                    f"({phase.elephant_flows}) < flows ({phase.flows}) "
                    "so mice flows exist")
            flow_words[: phase.elephant_flows] = _elephant_flow_words(
                rng, phase.elephant_flows, num_queues, phase.elephant_queue)
        if payload_pool is None:
            flow_payload = rng.integers(
                0, 2**32, (phase.flows, pkt.PAYLOAD_WORDS), dtype=np.uint32)
        else:
            flow_payload = payload_pool[
                rng.integers(0, payload_pool.shape[0], phase.flows)]
        phase_bursts = []
        for _ in range(phase.ticks):
            fidx = _sample_flows(rng, phase)
            slots = _sample_slots(rng, phase.slot_mix, phase.burst)
            # payload: the flow's base payload with a per-packet twist so
            # verdicts are not constant within a flow
            payload = flow_payload[fidx].copy()
            payload[:, 0] ^= rng.integers(
                0, 2**32, phase.burst, dtype=np.uint32)
            control = np.where(
                rng.random(phase.burst) < phase.monitor_frac,
                int(pkt.CTRL_MONITOR_ONLY), 0)
            rows = pkt.make_packets(slots, payload)
            rows[:, pkt.CONTROL_WORD_LO] = control.astype(np.uint32)
            rows[:, rss.FLOW_WORD_LO : rss.FLOW_WORD_LO + rss.FLOW_WORDS] = \
                flow_words[fidx]
            rows[:, SEQ_WORD] = np.arange(seq, seq + phase.burst,
                                          dtype=np.uint32)
            seq += phase.burst
            phase_bursts.append(rows)
        bursts.append(phase_bursts)
    return ScenarioTrace(phases=phases, bursts=bursts, seed=seed)


def default_swap_delivery(slot: int, cfg=executor.H32):
    """Freshly 'delivered' replacement weights for ``slot`` (deterministic),
    as CPU tensors: the runtime stages them onto its device.

    They are drawn from ``np.random.default_rng(10_000 + slot)``, so they
    differ from the reference's, which come from
    ``jax.random.PRNGKey(10_000 + slot)``; to compare the two runtimes,
    pass both the same ``swap_delivery``."""
    return executor.init_params(np.random.default_rng(10_000 + slot), cfg,
                                device="cpu")


def materialize_command(cmd, swap_delivery=default_swap_delivery):
    """Resolve a command *spec* into a submittable command: a ``SwapSlot``
    with ``params=None`` gets its delivered weights from ``swap_delivery``;
    every other command is already a value."""
    if isinstance(cmd, SwapSlot) and cmd.params is None:
        return dataclasses.replace(
            cmd, params=swap_delivery(int(cmd.slot)))
    return cmd


def phase_command_specs(phase: Phase, *, num_queues: int) -> list:
    """A phase's entry events as typed command *specs* (one atomic epoch).

    ``failed_queues`` becomes a ``FailQueues`` command (RETA failover
    remap), phases without failures restore full service
    (``RestoreQueues``), and ``swap_slot`` becomes a ``SwapSlot`` spec
    with ``params=None`` (materialized at play/replay time).  A failover
    that would leave zero live queues is unservable — traffic stays
    where it is (the 1-queue degenerate case), expressed as a plain
    restore.
    """
    failed = tuple(q for q in phase.failed_queues if q < num_queues)
    if failed and set(failed) != set(range(num_queues)):
        cmds = [FailQueues(failed)]
    else:
        cmds = [RestoreQueues()]
    if phase.swap_slot is not None:
        cmds.append(SwapSlot(phase.swap_slot, None))
    return cmds


def phase_commands(
    phase: Phase,
    *,
    num_queues: int,
    swap_delivery=default_swap_delivery,
) -> list:
    """``phase_command_specs`` with ``SwapSlot`` payloads materialized."""
    return [materialize_command(c, swap_delivery)
            for c in phase_command_specs(phase, num_queues=num_queues)]


def chaos_by_tick(phase: Phase) -> dict[int, list[ChaosEvent]]:
    """Group a phase's chaos events by tick offset (submission order kept)."""
    out: dict[int, list[ChaosEvent]] = {}
    for ev in phase.chaos:
        out.setdefault(int(ev.at_tick), []).append(ev)
    return out


def play(
    runtime,
    trace: ScenarioTrace,
    *,
    swap_delivery=default_swap_delivery,
) -> list[dict]:
    """Drive a runtime through a rendered trace; per-phase reports.

    Each phase's entry events are submitted as one command epoch through
    ``runtime.control``; the runtime makes them effective at the next
    tick boundary (the first dispatch of the phase).  Chaos events fire
    as their own epochs at their tick offset, *before* that tick's burst
    is dispatched — on a mesh this lands between two barrier ticks.
    Each burst is dispatched then ticked once; the backlog drains inside
    the phase so phase reports are self-contained.
    """
    reports = []
    mark = getattr(runtime, "mark_phase", None)
    for phase, phase_bursts in zip(trace.phases, trace.bursts):
        runtime.control.submit(*phase_commands(
            phase, num_queues=runtime.num_queues,
            swap_delivery=swap_delivery))
        chaos = chaos_by_tick(phase)
        before = runtime.audit_conservation()["totals"]
        wrong0 = runtime.telemetry.wrong_verdict
        t0 = time.perf_counter()
        for t, burst in enumerate(phase_bursts):
            for ev in chaos.get(t, ()):
                runtime.control.submit(*(
                    materialize_command(c, swap_delivery)
                    for c in ev.commands))
            runtime.dispatch(burst)
            runtime.tick()
        runtime.drain()
        dt = time.perf_counter() - t0
        after = runtime.audit_conservation()["totals"]
        completed = after["completed"] - before["completed"]
        report = {
            "phase": phase.name,
            "offered": after["offered"] - before["offered"],
            "completed": completed,
            "dropped": after["dropped"] - before["dropped"],
            "wrong_verdict": runtime.telemetry.wrong_verdict - wrong0,
            "elapsed_s": dt,
            "kpps": completed / dt / 1e3 if dt > 0 else float("nan"),
        }
        reports.append(report)
        if mark is not None:
            mark(phase.name, report)
    return reports
