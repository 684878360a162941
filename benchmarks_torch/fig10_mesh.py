#!/usr/bin/env python3
"""Fig. 10 on the port: the multi-host mesh data plane.

    python3 benchmarks_torch/fig10_mesh.py [--device cpu]
        [--json build/fig10_mesh.json]

The port's counterpart of ``benchmarks/fig10_mesh.py``, at its shapes (4
slots, batch 128, the emergency storyline ``emergency_phases(4)`` from seed
0, fused strategy), over ``MeshDataplane``:

* the hosts x queues-per-host sweep: kpps over the scenario for hosts in
  {1, 2} and queues per host in {2, 4}, ring 8192 (no drops), best of 2;
* hosts=1 degeneracy: ``MeshDataplane(hosts=1)`` against
  ``DataplaneRuntime`` (ring 512, record on), the count of differing
  streams (completed seqs, verdicts, slots, drops, RETA), which must be 0;
* epoch broadcast: the median ``apply_us`` of one epoch of each kind
  (SwapSlot, ProgramReta, FailQueues, RestoreQueues) on a 2-host mesh of 4
  queues per host against the single-host runtime;
* cascading-failover continuity: the scenario at 2 hosts x 4 queues in
  audit mode, zero wrong verdicts, mesh-wide conservation and a
  barrier-tick spread of 0.

Prints the card's name and power limit first (on the card), one
``name,value,note`` line per number, and writes them as one JSON object to
``--json`` (under ``build/``; ``benchmarks_torch/common.py``).
``chip_smoke.py`` calls ``epoch_broadcast`` at the data plane's card shape.
"""

from __future__ import annotations

import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmarks_torch import common  # noqa: E402

NUM_SLOTS, BATCH = 4, 128
HOSTS, QUEUES = (1, 2), (2, 4)
EPOCH_KINDS = ("swap_slot", "program_reta", "fail_queues", "restore_queues")


def mesh_sweep(bank, scenario, dev, *, hosts=HOSTS, queues=QUEUES, batch=BATCH,
               ring=8192, reps: int = 2, **kw) -> dict:
    """``{(hosts, queues_per_host): best kpps}`` over ``scenario``; raises
    unless every run conserves packets with zero wrong verdicts."""
    from repro_torch.dataplane import MeshDataplane, play

    out = {}
    for h in hosts:
        for q in queues:
            best = 0.0
            for _ in range(reps):
                mesh = MeshDataplane(bank, hosts=h, num_queues=q, batch=batch,
                                     ring_capacity=ring, device=dev, **kw)
                t0 = time.perf_counter()
                play(mesh, scenario)
                dt = time.perf_counter() - t0
                aud = mesh.audit_conservation()
                if not aud["ok"] or aud["wrong_verdict"]:
                    raise RuntimeError(f"mesh h{h}q{q}: {aud['totals']}, "
                                       f"wrong_verdict {aud['wrong_verdict']}")
                best = max(best, aud["totals"]["completed"] / dt / 1e3)
            out[(h, q)] = best
    return out


def hosts1_mismatch(bank, scenario, dev, *, num_queues=4, batch=BATCH,
                    ring=512, **kw) -> int:
    """How many of the completion streams, drops and RETA differ between
    ``MeshDataplane(hosts=1)`` and ``DataplaneRuntime``."""
    from repro_torch.dataplane import DataplaneRuntime, MeshDataplane, play

    kw = dict(kw, strategy="fused", batch=batch, ring_capacity=ring, record=True,
              device=dev)
    rt = DataplaneRuntime(bank, num_queues=num_queues, **kw)
    play(rt, scenario)
    m1 = MeshDataplane(bank, hosts=1, num_queues=num_queues, **kw)
    play(m1, scenario)
    return sum((m1.completed_seq != rt.completed_seq,
                m1.completed_verdicts != rt.completed_verdicts,
                m1.completed_slots != rt.completed_slots,
                m1.dropped_seq != rt.dropped_seq,
                not (m1.reta == rt.reta).all()))


def _apply_us(rt, make_cmd, trials: int) -> float:
    samples = []
    for _ in range(trials):
        rt.control.submit(make_cmd(rt))
        rt.flush_control()
        rec = rt.control.log[-1]
        if not rec.applied:
            raise RuntimeError(f"epoch {rec.epoch} did not apply: {rec.error}")
        samples.append(rec.apply_us)
    return float(statistics.median(samples))


def epoch_broadcast(bank, dev, *, num_queues=4, batch=BATCH, trials: int = 7,
                    **kw) -> dict:
    """``{kind: {"single_host": us, "broadcast_h2": us}}``: median
    ``apply_us`` of one epoch of each kind on the single-host runtime and
    on a 2-host mesh (stage on every host and the barrier commit)."""
    from repro_torch.control import FailQueues, ProgramReta, RestoreQueues, SwapSlot
    from repro_torch.dataplane import DataplaneRuntime, MeshDataplane, rss, scenarios

    delivered = scenarios.default_swap_delivery(1)
    cmds = {
        "swap_slot": lambda rt: SwapSlot(1, delivered),
        "program_reta": lambda rt: ProgramReta(
            tuple(rss.indirection_table(rt.num_queues))),
        "fail_queues": lambda rt: FailQueues((0,)),
        "restore_queues": lambda rt: RestoreQueues(),
    }
    runtimes = {"single_host": DataplaneRuntime(bank, num_queues=num_queues,
                                                batch=batch, device=dev, **kw),
                "broadcast_h2": MeshDataplane(bank, hosts=2, num_queues=num_queues,
                                              batch=batch, device=dev, **kw)}
    return {kind: {label: _apply_us(rt, cmds[kind], trials)
                   for label, rt in runtimes.items()}
            for kind in EPOCH_KINDS}


def cascading_failover(bank, dev, *, hosts=2, queues=4, batch=BATCH, ring=512,
                       num_slots=NUM_SLOTS, **kw) -> dict:
    """The cascading host failover in audit mode: wrong verdicts,
    conservation gap, barrier-tick spread and the host_down phase's kpps."""
    from repro_torch.dataplane import (MeshDataplane, cascading_failover_phases,
                                       play, render)

    phases = cascading_failover_phases(num_slots, hosts=hosts, queues_per_host=queues)
    trace = render(phases, num_slots=num_slots, seed=0, num_queues=hosts * queues)
    mesh = MeshDataplane(bank, hosts=hosts, num_queues=queues, batch=batch,
                         ring_capacity=ring, audit=True, record=True, device=dev, **kw)
    reports = play(mesh, trace)
    t = mesh.audit_conservation()["totals"]
    cont = mesh.control.continuity_audit()
    out = {
        "wrong_verdict": cont["wrong_verdict_total"],
        "unaccounted_packets": t["offered"] - t["completed"] - t["dropped"],
        "barrier_tick_spread": max(max(r.host_ticks) - min(r.host_ticks)
                                   for r in mesh.control.log if r.applied),
        "host_down_kpps": next(r["kpps"] for r in reports if r["phase"] == "host_down"),
        "epochs": len(cont["epochs"]),
    }
    if (out["wrong_verdict"] or out["unaccounted_packets"]
            or out["barrier_tick_spread"] or not cont["ok"]
            or t["offered"] != trace.total_packets):
        raise RuntimeError(f"cascading failover: {out}, continuity {cont['ok']}")
    return out


def run(dev, emit) -> None:
    import numpy as np
    from repro_torch.core import executor
    from repro_torch.dataplane import emergency_phases, render

    bank = executor.init_bank(np.random.default_rng(0), NUM_SLOTS, device=dev)
    scenario = render(emergency_phases(NUM_SLOTS), num_slots=NUM_SLOTS, seed=0)
    for (h, q), kpps in mesh_sweep(bank, scenario, dev).items():
        emit(f"fig10.mesh.h{h}q{q}.kpps", kpps, "best of 2, no drops")
    mismatch = hosts1_mismatch(bank, scenario, dev)
    emit("fig10.audit.hosts1_mismatch", mismatch, "expect=0")
    for kind, by in epoch_broadcast(bank, dev).items():
        for label, us in by.items():
            emit(f"fig10.epoch.{kind}.{label}.apply_us", us, "median of 7")
    for key, value in cascading_failover(bank, dev).items():
        emit(f"fig10.failover.{key}", value)
    if mismatch:
        raise RuntimeError("MeshDataplane(hosts=1) differs from DataplaneRuntime")


def main(argv=None) -> int:
    return common.main(run, __doc__, "fig10_mesh", argv)


if __name__ == "__main__":
    sys.exit(main())
