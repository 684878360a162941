#!/usr/bin/env python3
"""Fig. 14 on the port: continuous deployment under live traffic.

    python3 benchmarks_torch/fig14_deploy.py [--device cpu]
        [--json build/fig14_deploy.json]

The port's counterpart of ``benchmarks/fig14_deploy.py``, at its shapes (2
slots, 4 queues, batch 128, ring 4096, the emergency regime rendered from
the labeled corpus pool of 256 samples per capture group):

* **sampler overhead**: the regime (``scale=2``) played with and without a
  ``PacketSampler`` on the retire/drop taps: kpps both ways (min over 5
  alternating repeats, each started after a garbage collection), the
  overhead by the medians, the per-tick tap cost, the deferred flush cost
  per thousand rows, and the overhead against the reference's 5% budget
  (reported, not asserted: a miss is a finding);
* **rollout latency**: one scripted fine-tune -> canary -> promote rollout
  and one forced (corrupted weights) rollback, each under live traffic
  with ``audit=True``: the online fine-tune's wall time (24 STE steps on
  the device), canary start to promote and to rollback, and retrain to
  promote;
* **decision audits**, which must be 0 (raises): each rollout reaches
  exactly its expected terminal decision, zero wrong verdicts,
  conservation and epoch continuity intact.

Prints the card's name and power limit first (on the card), one
``name,value,note`` line per number, and writes them as one JSON object to
``--json`` (``benchmarks_torch/common.py``).
"""

from __future__ import annotations

import gc
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmarks_torch import common  # noqa: E402

NUM_SLOTS = 2
NUM_QUEUES = 4
BATCH = 128
OVERHEAD_BUDGET_PCT = 5.0
REPEATS = 5
TRAIN_STEPS = 24


def labeled_trace(scale: int = 1):
    """The emergency regime rendered from the labeled corpus pool (the
    oracle needs ground truth for every payload) and its oracle."""
    from repro_torch import deploy
    from repro_torch.dataplane import workloads

    pool, labels = deploy.labeled_pool(samples_per_group=256, seed=0)
    w = workloads.make_workload("emergency", num_slots=NUM_SLOTS,
                                num_queues=NUM_QUEUES, scale=scale)
    trace = workloads.render(list(w.phases), num_slots=NUM_SLOTS, seed=0,
                             num_queues=NUM_QUEUES, payload_pool=pool)
    return trace, deploy.LabelOracle(pool, labels)


def _runtime(bank, dev, **kw):
    from repro_torch.dataplane import DataplaneRuntime

    kw.setdefault("batch", BATCH)
    kw.setdefault("ring_capacity", 4096)
    return DataplaneRuntime(bank, num_queues=NUM_QUEUES, device=dev, **kw)


def sampler_overhead(bank, dev, emit) -> dict:
    from repro_torch import deploy
    from repro_torch.dataplane import workloads
    from repro_torch.device import synchronize

    trace, oracle = labeled_trace(scale=2)

    def run(with_sampler: bool):
        rt = _runtime(bank, dev)
        sampler = (deploy.PacketSampler(oracle, num_slots=NUM_SLOTS).attach(rt)
                   if with_sampler else None)
        gc.collect()  # the previous run's garbage, off the clock
        synchronize(dev)
        t0 = time.perf_counter()
        workloads.play(rt, trace)
        synchronize(dev)
        dt = time.perf_counter() - t0
        if sampler is not None:
            sampler.detach()  # flushes the deferred labeling queue
            if not sampler.labeled:
                raise RuntimeError("fig14: the sampler labeled nothing")
        return dt, rt.telemetry.snapshot()["completed_total"], rt.telemetry.runtime_ticks

    run(False)  # first launches off the clock
    base, tapped = [], []
    done = ticks = 0
    for _ in range(REPEATS):
        dt0, done, ticks = run(False)
        dt1, _, _ = run(True)
        base.append(dt0)
        tapped.append(dt1)
    dt0, dt1 = min(base), min(tapped)
    overhead_pct = max(dt1 - dt0, 0.0) / dt0 * 100.0

    # the deferred consumer-side cost: one flush of everything a play enqueued
    rt = _runtime(bank, dev)
    sampler = deploy.PacketSampler(oracle, num_slots=NUM_SLOTS).attach(rt)
    workloads.play(rt, trace)
    t0 = time.perf_counter()
    sampler.flush()
    flush_s = time.perf_counter() - t0
    sampler.detach()
    out = {"kpps_untapped": done / dt0 / 1e3, "kpps_tapped": done / dt1 / 1e3,
           "per_tick_us": max(dt1 - dt0, 0.0) * 1e6 / max(ticks, 1),
           "flush_us_per_krow": flush_s * 1e6 / max(sampler.sampled / 1e3, 1e-9),
           "overhead_pct": overhead_pct,
           "overhead_pct_median": (statistics.median(tapped)
                                   / statistics.median(base) - 1.0) * 100.0,
           "ticks": ticks, "packets": done}
    emit("fig14.sampler.kpps_untapped", out["kpps_untapped"],
         f"{done} pkts emergency play, taps empty")
    emit("fig14.sampler.kpps_tapped", out["kpps_tapped"],
         "same play, sampler labeling + reservoirs attached")
    emit("fig14.sampler.overhead_pct_median", out["overhead_pct_median"],
         f"median wall tapped over median untapped, {REPEATS} runs each")
    emit("fig14.sampler.per_tick_us", out["per_tick_us"],
         f"per-tick tap cost over {ticks} ticks")
    emit("fig14.sampler.flush_us_per_krow", out["flush_us_per_krow"],
         f"deferred label+file cost, {sampler.sampled} rows one flush")
    emit("fig14.audit.sampler_overhead_over_budget",
         int(overhead_pct > OVERHEAD_BUDGET_PCT),
         f"overhead {overhead_pct:.2f}% against the "
         f"{OVERHEAD_BUDGET_PCT:.0f}% budget (reported, not asserted)")
    return out


def run_rollout(bank, dev, trace, oracle, *, corrupt: bool):
    """One scripted rollout under live traffic; returns (pilot, runtime)."""
    from repro_torch import deploy
    from repro_torch.dataplane import workloads

    rt = _runtime(bank, dev, audit=True)
    sampler = deploy.PacketSampler(oracle, num_slots=NUM_SLOTS).attach(rt)
    driver = deploy.DeployDriver(rt)
    pilot = deploy.ScheduledRollout(
        driver, sampler,
        deploy.OnlineTrainer(steps=TRAIN_STEPS, seed=0, device=dev),
        warmup_ticks=8, min_samples=48, corrupt=corrupt,
        canary_kw=dict(bake_ticks=8, min_samples=24))
    driver.add(pilot)
    workloads.play(driver, trace)
    driver.flush_deploy()
    sampler.detach()
    return pilot, rt


def rollout_latency(bank, dev, emit) -> dict:
    trace, oracle = labeled_trace()
    bad_outcome = wrong = 0
    out = {}
    for corrupt, want in ((False, "promoted"), (True, "rolled_back")):
        pilot, rt = run_rollout(bank, dev, trace, oracle, corrupt=corrupt)
        rec = pilot.decision
        bad_outcome += int(rec is None or rec["event"] != want)
        wrong += int(rt.telemetry.wrong_verdict)
        bad_outcome += int(not rt.audit_conservation()["ok"])
        bad_outcome += int(not rt.control.continuity_audit()["ok"])
        if rec is None:
            continue
        bake_us = rec["metrics"]["elapsed_us"]
        if corrupt:
            out["rollback_latency_us"] = bake_us
            emit("fig14.deploy.rollback_latency_us", bake_us,
                 f"canary start -> rolled_back ({rec['metrics']['bake_window_ticks']}"
                 f" ticks bake, reason: {rec['reason']})")
        else:
            train_us = pilot.result.train_us
            out.update(fine_tune_us=train_us, promote_latency_us=bake_us,
                       retrain_to_promote_us=train_us + bake_us)
            emit("fig14.deploy.fine_tune_us", train_us,
                 f"{pilot.result.metrics['samples']} sampled examples, "
                 f"{TRAIN_STEPS} STE steps, holdout err "
                 f"{pilot.result.metrics['err']:.3f}")
            emit("fig14.deploy.promote_latency_us", bake_us,
                 f"canary start -> promoted ({rec['metrics']['bake_window_ticks']}"
                 " ticks bake)")
            emit("fig14.deploy.retrain_to_promote_us", train_us + bake_us,
                 "operator-visible: fine-tune + canary bake + promote epoch")
    emit("fig14.audit.rollout_outcome_mismatch", bad_outcome,
         "expect=0: promote run promoted, corrupted run rolled back, "
         "conservation + epoch continuity intact on both")
    emit("fig14.audit.deploy_wrong_verdict", wrong,
         "expect=0: zero wrong verdicts across both audited rollouts")
    if bad_outcome or wrong:
        raise RuntimeError(f"fig14: outcome mismatches {bad_outcome}, wrong {wrong}")
    return out


def run(dev, emit) -> dict:
    import numpy as np
    from repro_torch.core import executor

    bank = executor.init_bank(np.random.default_rng(0), NUM_SLOTS, device=dev)
    return {"sampler": sampler_overhead(bank, dev, emit),
            "rollout": rollout_latency(bank, dev, emit)}


def main(argv=None) -> int:
    return common.main(run, __doc__, "fig14_deploy", argv)


if __name__ == "__main__":
    sys.exit(main())
