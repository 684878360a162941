"""Workload regimes as phase lists (torch port).

Only the canonical emergency storyline is ported so far; the other ten
regimes of the reference and the trace codec wait for ROADMAP.md Queue 1
item 6.
"""

from __future__ import annotations

from repro_torch.dataplane.workloads.phases import Phase


def _uniform(num_slots: int) -> tuple[float, ...]:
    return tuple(1.0 / num_slots for _ in range(num_slots))


def _peaked(num_slots: int, slot: int, weight: float) -> tuple[float, ...]:
    rest = (1.0 - weight) / max(num_slots - 1, 1)
    return tuple(weight if i == slot % num_slots else rest
                 for i in range(num_slots))


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
