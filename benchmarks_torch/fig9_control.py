#!/usr/bin/env python3
"""Fig. 9 on the port: control-plane epochs and adaptive routing.

    python3 benchmarks_torch/fig9_control.py [--device cpu]
        [--json build/fig9_control.json]

The port's counterpart of ``benchmarks/fig9_control.py``, at its shapes (a
4-slot bank from ``np.random.default_rng(0)``, 4 queues, batch 128, the
fused strategy):

* epoch apply latency: the median wall cost (7 trials) of applying one
  single-command epoch of each kind (SwapSlot, ProgramReta, FailQueues,
  RestoreQueues, SetPolicy) at a tick boundary;
* adaptive-policy rebalance: the elephant-skew storyline (seed 0) at ring
  256, batch 64 under ``StaticReta``, ``LeastDepth`` and
  ``DropRateRebalance``: the most any queue dropped, all drops, and the
  time from the skew's onset to the last rebalance epoch; raises unless
  both adaptive policies drop less at their worst queue than the static
  table;
* pipelined ticks: the emergency storyline at pipeline depth 1 and 4
  (ring 8192, best of 2, kpps); raises unless both complete every packet
  with equal completion streams, and unless an audited run that applies
  every command kind (a mid-run ``SetPolicy(LeastDepth())`` adds
  ``ProgramReta`` epochs) keeps continuity.
"""

import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmarks_torch import common  # noqa: E402

NUM_SLOTS = 4
NUM_QUEUES = 4
BATCH = 128


def check(ok: bool, what) -> None:
    if not ok:
        raise RuntimeError(f"fig9: {what}")


def _fresh_runtime(bank, dev, **kw):
    from repro_torch.dataplane import DataplaneRuntime

    kw.setdefault("num_queues", NUM_QUEUES)
    kw.setdefault("strategy", "fused")
    kw.setdefault("batch", BATCH)
    kw.setdefault("ring_capacity", 1024)
    return DataplaneRuntime(bank, device=dev, **kw)


def _apply_us(rt, cmd, trials: int = 7) -> float:
    """Median apply cost of one single-command epoch at a tick boundary."""
    samples = []
    for _ in range(trials):
        rt.control.submit(cmd)
        rt.flush_control()
        samples.append(rt.control.log[-1].apply_us)
    return float(statistics.median(samples))


def bench_epoch_latency(bank, dev, emit) -> None:
    from repro_torch.control import (FailQueues, LeastDepth, ProgramReta,
                                     RestoreQueues, SetPolicy, SwapSlot)
    from repro_torch.dataplane import rss, workloads

    rt = _fresh_runtime(bank, dev)
    delivered = workloads.default_swap_delivery(1)
    reta = tuple(rss.indirection_table(NUM_QUEUES))
    kinds = [
        ("swap_slot", SwapSlot(1, delivered)),
        ("program_reta", ProgramReta(reta)),
        ("fail_queues", FailQueues((0,))),
        ("restore_queues", RestoreQueues()),
        ("set_policy", SetPolicy(LeastDepth())),
    ]
    for name, cmd in kinds:
        emit(f"fig9.epoch.{name}.apply_us", _apply_us(rt, cmd),
             "single-command epoch at tick boundary")


def bench_policy_rebalance(bank, dev, trace, emit) -> None:
    from repro_torch.control import (DropRateRebalance, LeastDepth, ProgramReta,
                                     StaticReta)
    from repro_torch.dataplane import play

    results = {}
    for policy in (StaticReta(), LeastDepth(), DropRateRebalance()):
        rt = _fresh_runtime(bank, dev, ring_capacity=256, batch=64, policy=policy)
        t0 = time.perf_counter()
        reports = play(rt, trace)
        aud = rt.audit_conservation()
        check(aud["ok"], aud)
        dropped = [q["dropped"] for q in aud["per_queue"]]
        rebalances = [r for r in rt.control.log
                      if any(isinstance(c, ProgramReta) for c in r.commands)]
        # skew onset = end of the warmup phase; convergence = the last
        # rebalance epoch becoming effective
        skew_start = t0 + reports[0]["elapsed_s"]
        rebalance_us = (max(0.0, rebalances[-1].submitted_s - skew_start) * 1e6
                        + rebalances[-1].apply_latency_us if rebalances else 0.0)
        key = policy.name.replace("-", "_")
        results[policy.name] = max(dropped)
        emit(f"fig9.policy.{key}.max_queue_dropped", max(dropped),
             f"elephant skew, {len(rebalances)} rebalance epoch(s)")
        emit(f"fig9.policy.{key}.total_dropped", sum(dropped), "all queues")
        if rebalances:
            emit(f"fig9.policy.{key}.rebalance_us", rebalance_us,
                 "skew onset -> last rebalance effective")
    check(results["least-depth"] < results["static"], results)
    check(results["drop-rate"] < results["static"], results)


def bench_pipeline_and_continuity(bank, dev, emit) -> None:
    from repro_torch.control import LeastDepth, SetPolicy
    from repro_torch.dataplane import emergency_phases, play, render
    from repro_torch.device import synchronize

    trace = render(emergency_phases(NUM_SLOTS), num_slots=NUM_SLOTS, seed=0)
    verdicts = {}
    for depth in (1, 4):
        best = 0.0
        for _ in range(2):
            rt = _fresh_runtime(bank, dev, ring_capacity=8192,
                                pipeline_depth=depth, record=True)
            t0 = time.perf_counter()
            play(rt, trace)
            synchronize(dev)
            dt = time.perf_counter() - t0
            aud = rt.audit_conservation()
            check(aud["ok"], aud)
            done = aud["totals"]["completed"]
            check(done == trace.total_packets, aud)
            best = max(best, done / dt / 1e3)
        verdicts[depth] = (rt.completed_seq, rt.completed_verdicts,
                           rt.completed_slots)
        emit(f"fig9.pipeline.depth{depth}.kpps", best, f"{done} pkts best-of-2")
    check(verdicts[1] == verdicts[4], "pipelined ticks changed results")

    # continuity across every command kind
    rt = _fresh_runtime(bank, dev, ring_capacity=512, audit=True, pipeline_depth=2)
    rt.control.submit(SetPolicy(LeastDepth()))
    play(rt, trace)
    cont = rt.control.continuity_audit()
    kinds = {c for e in cont["epochs"] for c in e["commands"]}
    check(kinds >= {"restore_queues", "fail_queues", "swap_slot", "set_policy",
                    "program_reta"}, kinds)
    check(cont["ok"], cont)
    emit("fig9.audit.wrong_verdict_all_commands", cont["wrong_verdict_total"],
         f"expect=0 across {len(cont['epochs'])} epochs, {len(kinds)} command kinds")


def run(dev, emit) -> None:
    import numpy as np
    from repro_torch.core import executor
    from repro_torch.dataplane import elephant_skew_phases, render

    bank = executor.init_bank(np.random.default_rng(0), NUM_SLOTS, device=dev)
    skew = render(elephant_skew_phases(NUM_SLOTS, NUM_QUEUES),
                  num_slots=NUM_SLOTS, seed=0, num_queues=NUM_QUEUES)
    bench_epoch_latency(bank, dev, emit)
    bench_policy_rebalance(bank, dev, skew, emit)
    bench_pipeline_and_continuity(bank, dev, emit)


def main(argv=None) -> int:
    return common.main(run, __doc__, "fig9_control", argv)


if __name__ == "__main__":
    sys.exit(main())
