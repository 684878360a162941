#!/usr/bin/env python3
"""Fig. 11 on the port: the trace-driven workload engine.

    python3 benchmarks_torch/fig11_workloads.py [--device cpu]
        [--json build/fig11_workloads.json]

The port's counterpart of ``benchmarks/fig11_workloads.py``, at its shapes
(a 2-slot bank from ``np.random.default_rng(0)``, batch 128):

* regime sweep: every regime of ``REGIME_NAMES`` synthesized into a trace
  (seed 0; ``file-replay`` pinned to the synthetic corpus) and replayed
  through an audited, recording runtime at ring 4096 (4 queues; the two
  host-addressed regimes on a 2 x 2 mesh): replay kpps per regime; raises
  on any wrong verdict, invariant mismatch or broken continuity;
* record -> replay: a live emergency run (4 queues, ring 2048, seed 7)
  recorded, saved, loaded and replayed on ``make_runtime``: raises unless
  the digest and the raw per-queue (seq, verdict, slot) streams and drops
  are equal;
* the codec's cost: save and load wall time and compressed bytes per
  packet of that trace (the port's own MessagePack codec and zlib).
"""

import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmarks_torch import common  # noqa: E402

NUM_SLOTS = 2
BATCH = 128

#: regimes whose phases address hosts (global queue ids over 2 hosts)
MESH_REGIMES = ("cascading-failover", "chaos-host-failover")


def check(ok: bool, what) -> None:
    if not ok:
        raise RuntimeError(f"fig11: {what}")


def runtime_shape(regime: str) -> tuple[int, int]:
    """(hosts, queues per host) the sweep runs ``regime`` at."""
    return (2, 2) if regime in MESH_REGIMES else (1, 4)


def _runtime_for(bank, dev, regime: str):
    from repro_torch.dataplane import DataplaneRuntime, MeshDataplane

    kw = dict(batch=BATCH, ring_capacity=4096, record=True, audit=True, device=dev)
    hosts, queues = runtime_shape(regime)
    if hosts > 1:
        return MeshDataplane(bank, hosts=hosts, num_queues=queues, **kw)
    return DataplaneRuntime(bank, num_queues=queues, **kw)


def bench_regime_sweep(bank, dev, emit) -> None:
    from repro_torch.dataplane import workloads
    from repro_torch.device import synchronize

    for regime in workloads.REGIME_NAMES:
        hosts, queues = runtime_shape(regime)
        w = workloads.make_workload(
            regime, num_slots=NUM_SLOTS, num_queues=queues, hosts=hosts,
            corpus_root=workloads.SYNTHETIC_CORPUS)
        trace = workloads.synthesize(
            w.phases, num_slots=NUM_SLOTS, num_queues=hosts * queues,
            seed=0, name=regime, payload_pool=w.payload_pool)
        rt = _runtime_for(bank, dev, regime)
        t0 = time.perf_counter()
        rep = workloads.replay(trace, rt)
        synchronize(dev)
        dt = time.perf_counter() - t0
        done = rep["totals"]["completed"]
        cont = rt.control.continuity_audit()
        label = regime.replace("-", "_")
        emit(f"fig11.{label}.kpps", done / dt / 1e3,
             f"{done}/{trace.total_packets} pkts {hosts}h x {queues}q "
             f"{len(rt.control.log)} epochs audited replay")
        emit(f"fig11.audit.{label}.wrong_verdict", rt.telemetry.wrong_verdict,
             "expect=0: zero-wrong-verdict continuity under this regime")
        bad = len(rep["mismatches"]) + (0 if cont["ok"] else 1)
        emit(f"fig11.audit.{label}.invariant_mismatch", bad,
             "expect=0: per-phase invariants + epoch continuity hold")
        check(rt.telemetry.wrong_verdict == 0, f"{regime}: wrong verdicts")
        check(bad == 0, (regime, rep["mismatches"]))


def bench_record_replay(bank, dev, emit) -> None:
    from repro_torch.dataplane import DataplaneRuntime, workloads

    w = workloads.make_workload("emergency", num_slots=NUM_SLOTS, num_queues=4)
    rendered = workloads.render(list(w.phases), num_slots=NUM_SLOTS, seed=7,
                                num_queues=4)
    rt = DataplaneRuntime(bank, num_queues=4, batch=BATCH, ring_capacity=2048,
                          record=True, device=dev)
    rec = workloads.record(rt)
    workloads.play(rec, rendered)
    trace = rec.finish(name="emergency", seed=7)

    with tempfile.TemporaryDirectory(prefix="fig11_") as tmp:
        path = os.path.join(tmp, "emergency.bswt")
        t0 = time.perf_counter()
        nbytes = workloads.save(trace, path)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = workloads.load(path)
        load_s = time.perf_counter() - t0
    emit("fig11.trace.save_us", save_s * 1e6,
         f"{nbytes} bytes, {trace.total_packets} pkts")
    emit("fig11.trace.load_us", load_s * 1e6, "zlib + MessagePack decode")
    emit("fig11.trace.bytes_per_packet", nbytes / trace.total_packets,
         "compressed trace size amortized")

    rt2 = workloads.make_runtime(loaded, device=dev)
    rep = workloads.replay(loaded, rt2)
    mismatch = len(rep["mismatches"])
    mismatch += sum((
        rep["digest_ok"] is not True,
        rt2.completed_seq != rt.completed_seq,
        rt2.completed_verdicts != rt.completed_verdicts,
        rt2.completed_slots != rt.completed_slots,
        sorted(rt2.dropped_seq) != sorted(rt.dropped_seq),
    ))
    emit("fig11.audit.record_replay_mismatch", mismatch,
         "expect=0: replay of a recorded trace is bit-identical "
         "(digest + raw per-queue seq/verdict/slot streams)")
    check(mismatch == 0, rep["mismatches"])


def run(dev, emit) -> None:
    import numpy as np
    from repro_torch.core import executor

    bank = executor.init_bank(np.random.default_rng(0), NUM_SLOTS, device=dev)
    bench_regime_sweep(bank, dev, emit)
    bench_record_replay(bank, dev, emit)


def main(argv=None) -> int:
    return common.main(run, __doc__, "fig11_workloads", argv)


if __name__ == "__main__":
    sys.exit(main())
