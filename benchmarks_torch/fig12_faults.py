#!/usr/bin/env python3
"""Fig. 12 on the port: fault-tolerant epoch barriers.

    python3 benchmarks_torch/fig12_faults.py [--device cpu]
        [--json build/fig12_faults.json]

The port's counterpart of ``benchmarks/fig12_faults.py``, at its shapes: the
canonical one-fault ``demo_plan`` of every fault class on an audited,
recording 2-host mesh of 2 queues per host (4 slots, batch 128, ring 4096,
a 4-tick lease, the fault at tick 6), driven for 20 ticks of 96-packet
bursts over 24 flows with a SwapSlot epoch every third tick.  Per class:

* ``detect_ticks``: fault onset to the health monitor's first transition
  away from healthy for the victim;
* ``failover_latency_ticks``: that detection to the synthesized
  ``FailQueues`` epoch's commit (0 when the class resolves without one);
* ``packets_at_risk``: the peak packets stranded on a dead host at any
  tick boundary;

and the audits that must be 0: wrong verdicts over every epoch window,
epochs whose outcome is not exactly one of atomic / degraded / rollback,
and the mesh-wide conservation gap (stranded packets counted).  All are
tick or packet counts, deterministic in the plan and the seed.  Prints the
card's name and power limit first (on the card), one ``name,value,note``
line per number, and writes them as one JSON object to ``--json``
(``benchmarks_torch/common.py``).
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmarks_torch import common  # noqa: E402

NUM_SLOTS, HOSTS, QUEUES, LEASE = 4, 2, 2, 4
TICKS, FAULT_TICK, BURST, FLOWS = 20, 6, 96, 24


def _drive(mesh, bursts) -> int:
    """Dispatch and tick through ``bursts`` with a SwapSlot epoch every
    third tick; returns the peak stranded-packet count."""
    from repro_torch.control import SwapSlot
    from repro_torch.dataplane import scenarios

    at_risk = 0
    for t, burst in enumerate(bursts):
        if t % 3 == 1:
            slot = (t // 3) % NUM_SLOTS
            mesh.control.submit(SwapSlot(slot, scenarios.default_swap_delivery(slot)))
        mesh.dispatch(burst)
        mesh.tick()
        at_risk = max(at_risk, mesh.audit_conservation()["stranded"]["packets"])
    mesh.drain()
    return at_risk


def _outcome_violations(log) -> int:
    """Epochs whose outcome is not exactly one of atomic commit, degraded
    quorum commit, atomic rollback (with an error iff rolled back)."""
    return sum(rec.commit_mode not in ("atomic", "degraded", "rollback")
               or (rec.commit_mode == "rollback") != (rec.error is not None)
               for rec in log)


def fault_class(bank, bursts, kind: str, dev) -> dict:
    """One fault class's numbers; raises unless every audit is clean."""
    from repro_torch.dataplane import MeshDataplane, faults

    plan = faults.demo_plan(kind, hosts=HOSTS, lease_ticks=LEASE, at_tick=FAULT_TICK)
    mesh = MeshDataplane(bank, hosts=HOSTS, num_queues=QUEUES, batch=128,
                         ring_capacity=4096, audit=True, record=True,
                         lease_ticks=LEASE, fault_injector=faults.FaultInjector(plan),
                         device=dev)
    at_risk = _drive(mesh, bursts)
    detect = next((t.tick for t in mesh.health.transitions
                   if t.frm == "healthy" and t.to != "healthy"), None)
    onset = min(f.at_tick for f in plan.faults)
    failover = 0
    if mesh.failover_epochs:
        rec = next(r for r in mesh.control.log if r.epoch == mesh.failover_epochs[0])
        failover = rec.applied_tick - (detect if detect is not None else FAULT_TICK)
    cont = mesh.control.continuity_audit()
    aud = mesh.audit_conservation()
    t = aud["totals"]
    out = {"detect_ticks": 0 if detect is None else detect - onset,
           "failover_latency_ticks": failover,
           "packets_at_risk": at_risk,
           "wrong_verdict": cont["wrong_verdict_total"],
           "outcome_violations": _outcome_violations(mesh.control.log),
           "conservation_gap": (t["offered"] - t["completed"] - t["dropped"]
                                - t["occupancy"] - t["in_flight"]),
           "commit_modes": cont["commit_modes"]}
    if (not cont["ok"] or not aud["ok"] or out["conservation_gap"]
            or out["outcome_violations"]):
        raise RuntimeError(f"fault class {kind}: {out}")
    return out


def fault_matrix(bank, dev) -> dict:
    """``{kind: numbers}`` for every class of ``faults.FAULT_CLASSES``."""
    from repro_torch.dataplane import Phase, faults, render

    uniform = (1.0 / NUM_SLOTS,) * NUM_SLOTS
    trace = render([Phase("drive", ticks=TICKS, burst=BURST, flows=FLOWS,
                          slot_mix=uniform)],
                   num_slots=NUM_SLOTS, seed=0, num_queues=HOSTS * QUEUES)
    return {kind: fault_class(bank, trace.bursts[0], kind, dev)
            for kind in faults.FAULT_CLASSES}


def run(dev, emit) -> None:
    import numpy as np
    from repro_torch.core import executor

    bank = executor.init_bank(np.random.default_rng(0), NUM_SLOTS, device=dev)
    for kind, nums in fault_matrix(bank, dev).items():
        for key, value in nums.items():
            emit(f"fig12.{kind}.{key}", value)


def main(argv=None) -> int:
    return common.main(run, __doc__, "fig12_faults", argv)


if __name__ == "__main__":
    sys.exit(main())
