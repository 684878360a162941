#!/usr/bin/env python3
"""Fig. 13 on the port: the observability pipeline's cost and detection.

    python3 benchmarks_torch/fig13_obs.py [--device cpu]
        [--json build/fig13_obs.json]

The port's counterpart of ``benchmarks/fig13_obs.py``, at its shapes (2
slots, batch 128, ring 4096, 4 queues; the four mesh regimes at 2 hosts x 2
queues with their fault plans armed):

* **telemetry streaming overhead**: the emergency regime (``scale=2``)
  replayed on the fused path with and without ``obs.attach`` (delta sink,
  epoch spans): kpps both ways (min over 5 alternating repeats, each
  started after a garbage collection), the per-tick difference, the
  overhead by the medians, the host time of ``emit_delta`` itself per
  tick, and the overhead against the reference's 5% budget (reported, not
  asserted: a miss is a finding; runs on the card spread by +-10%, more
  than the stream costs);
* **anomaly detection sweep**: every regime replayed with the stream
  attached and classified by ``AnomalyDetector``: the detect tick per
  regime, and the misclassification count, which must be 0 (raises);
* **streaming trace codec**: the end-of-run stall of a streamed recording
  against the v1 monolithic save (``trace._save_v1``) and the buffered v2
  save of the same run, load time, bytes per packet; the streamed and
  buffered files must be byte-identical and the replay must reproduce the
  digest (raises), the stall speedup over v1 is reported.

Prints the card's name and power limit first (on the card), one
``name,value,note`` line per number, and writes them as one JSON object to
``--json`` (``benchmarks_torch/common.py``).
"""

from __future__ import annotations

import gc
import os
import statistics
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmarks_torch import common  # noqa: E402

NUM_SLOTS = 2
BATCH = 128
OVERHEAD_BUDGET_PCT = 5.0
STREAM_SPEEDUP_FLOOR = 5.0
REPEATS = 5

#: regimes the detector needs the mesh + armed fault plan for
MESH_REGIMES = ("cascading-failover", "chaos-host-failover",
                "barrier-straggler", "crash-mid-commit")


def workload_trace(regime: str, scale: int = 1):
    from repro_torch.dataplane import workloads
    from repro_torch.dataplane.workloads import generators

    hosts = 2 if regime in MESH_REGIMES else 1
    queues = 2 if regime in MESH_REGIMES else 4
    w = workloads.make_workload(
        regime, num_slots=NUM_SLOTS, num_queues=queues, hosts=hosts,
        scale=scale, corpus_root=generators.SYNTHETIC_CORPUS)
    trace = workloads.synthesize(
        w.phases, num_slots=NUM_SLOTS, num_queues=hosts * queues, seed=0,
        name=regime, payload_pool=w.payload_pool)
    return w, trace, hosts, queues


def runtime_for(bank, w, hosts: int, queues: int, dev, **kw):
    from repro_torch.dataplane import DataplaneRuntime, MeshDataplane, faults

    kw.setdefault("batch", BATCH)
    kw.setdefault("ring_capacity", 4096)
    if hosts > 1:
        injector = (faults.FaultInjector(w.fault_plan)
                    if w.fault_plan is not None else None)
        return MeshDataplane(bank, hosts=hosts, num_queues=queues,
                             fault_injector=injector, device=dev, **kw)
    return DataplaneRuntime(bank, num_queues=queues, device=dev, **kw)


def time_emit_delta(rt) -> dict:
    """Wrap every shard's ``telemetry.emit_delta`` with a host timer;
    returns the accumulator ``{"s": seconds, "calls": n}``."""
    acc = {"s": 0.0, "calls": 0}
    for shard in getattr(rt, "shards", None) or [rt]:
        tel = shard.telemetry
        real = tel.emit_delta

        def timed(*a, _real=real, **kw):
            t0 = time.perf_counter()
            try:
                return _real(*a, **kw)
            finally:
                acc["s"] += time.perf_counter() - t0
                acc["calls"] += 1
        tel.emit_delta = timed
    return acc


def stream_overhead(bank, dev, emit, *, scale: int = 2) -> dict:
    """Emergency replay, stream detached against attached; min over
    alternating repeats (jitter only ever adds time)."""
    from repro_torch.dataplane import workloads
    from repro_torch.device import synchronize
    from repro_torch.obs import TelemetryStream, attach, detach

    w, trace, hosts, queues = workload_trace("emergency", scale=scale)

    def run(with_sink: bool):
        rt = runtime_for(bank, w, hosts, queues, dev)
        acc = None
        if with_sink:
            attach(rt, TelemetryStream(capacity=1 << 16))
            acc = time_emit_delta(rt)
        gc.collect()  # the previous run's garbage, off the clock
        synchronize(dev)
        t0 = time.perf_counter()
        rep = workloads.replay(trace, rt)
        synchronize(dev)
        dt = time.perf_counter() - t0
        if with_sink:
            detach(rt)
        return dt, rep["totals"]["completed"], rt.telemetry.runtime_ticks, acc

    run(False)  # first launches (and kernel loads) off the clock
    base, sunk, emit_us = [], [], []
    done = ticks = 0
    for _ in range(REPEATS):
        dt0, done, ticks, _ = run(False)
        dt1, _, _, acc = run(True)
        base.append(dt0)
        sunk.append(dt1)
        emit_us.append(acc["s"] * 1e6 / max(ticks, 1))
    dt0, dt1 = min(base), min(sunk)
    overhead_pct = max(dt1 - dt0, 0.0) / dt0 * 100.0
    out = {"kpps_nosink": done / dt0 / 1e3, "kpps_sink": done / dt1 / 1e3,
           "delta_emit_us": max(dt1 - dt0, 0.0) * 1e6 / max(ticks, 1),
           "emit_delta_host_us_per_tick": min(emit_us),
           "overhead_pct": overhead_pct,
           "overhead_pct_median": (statistics.median(sunk)
                                   / statistics.median(base) - 1.0) * 100.0,
           "ticks": ticks, "packets": done}
    emit("fig13.telemetry.kpps_nosink", out["kpps_nosink"],
         f"{done} pkts fused replay, no delta sink")
    emit("fig13.telemetry.kpps_sink", out["kpps_sink"],
         "same replay, delta stream + spans attached")
    emit("fig13.telemetry.delta_emit_us", out["delta_emit_us"],
         f"per-tick wall difference over {ticks} ticks")
    emit("fig13.telemetry.overhead_pct_median", out["overhead_pct_median"],
         f"median wall with the sink over median without, {REPEATS} runs each")
    emit("fig13.telemetry.emit_delta_host_us_per_tick",
         out["emit_delta_host_us_per_tick"], "host time inside emit_delta")
    emit("fig13.audit.telemetry_overhead_over_budget",
         int(overhead_pct > OVERHEAD_BUDGET_PCT),
         f"overhead {overhead_pct:.2f}% against the "
         f"{OVERHEAD_BUDGET_PCT:.0f}% budget (reported, not asserted)")
    return out


def detector_sweep(bank, dev, emit) -> dict:
    """Every regime through an attached detector; raises unless each is
    classified as itself."""
    from repro_torch.dataplane import workloads
    from repro_torch.obs import AnomalyDetector, TelemetryStream, attach

    wrong, ticks = 0, {}
    for regime in workloads.REGIME_NAMES:
        w, trace, hosts, queues = workload_trace(regime)
        rt = runtime_for(bank, w, hosts, queues, dev, record=True)
        stream = TelemetryStream(capacity=1 << 16)
        attach(rt, stream)
        det = AnomalyDetector(stream, num_queues=hosts * queues,
                              num_slots=NUM_SLOTS, hosts=hosts)
        t0 = time.perf_counter()
        workloads.replay(trace, rt)
        det.poll()
        dt = time.perf_counter() - t0
        got = det.classify()
        ok = got["regime"] == regime
        wrong += int(not ok)
        detect = det.detect_tick()
        ticks[regime] = -1 if detect is None else detect
        emit(f"fig13.detector.{regime.replace('-', '_')}.detect_tick",
             ticks[regime], f"classified {got['regime']!r} ({len(det.findings)} "
             f"findings, {dt * 1e3:.0f} ms replay+poll)")
    emit("fig13.audit.regime_misclassified", wrong,
         f"expect=0: all {len(workloads.REGIME_NAMES)} regimes named")
    if wrong:
        raise RuntimeError(f"fig13: {wrong} regimes misclassified")
    return {"misclassified": wrong, "detect_tick": ticks}


def stream_codec(bank, dev, emit, tmp_dir: str | None = None) -> dict:
    """Streamed against buffered against v1-monolithic save of one run."""
    from repro_torch.dataplane import workloads
    from repro_torch.dataplane.workloads import trace as trace_mod

    w, _, hosts, queues = workload_trace("emergency")
    rendered = workloads.render(list(w.phases), num_slots=NUM_SLOTS, seed=7,
                                num_queues=queues, payload_pool=w.payload_pool)

    def run_recorder(path=None):
        rt = runtime_for(bank, w, hosts, queues, dev, record=True)
        rec = workloads.record(rt, path=path)
        workloads.play(rec, rendered)
        return rec

    tmp = tmp_dir or tempfile.mkdtemp(prefix="fig13_")
    os.makedirs(tmp, exist_ok=True)
    buffered = run_recorder().finish(name="emergency", seed=7)
    v1_path = os.path.join(tmp, "v1.bswt")
    t0 = time.perf_counter()
    trace_mod._save_v1(buffered, v1_path)
    v1_save_us = (time.perf_counter() - t0) * 1e6
    v2_path = os.path.join(tmp, "v2.bswt")
    t0 = time.perf_counter()
    nbytes = workloads.save(buffered, v2_path)
    v2_save_us = (time.perf_counter() - t0) * 1e6

    stream_path = os.path.join(tmp, "streamed.bswt")
    rec = run_recorder(path=stream_path)
    t0 = time.perf_counter()
    streamed = rec.finish(name="emergency", seed=7)
    stall_us = (time.perf_counter() - t0) * 1e6
    t0 = time.perf_counter()
    loaded = workloads.load(stream_path)
    load_us = (time.perf_counter() - t0) * 1e6
    with open(v2_path, "rb") as a, open(stream_path, "rb") as b:
        identical = a.read() == b.read()
    rep = workloads.replay(loaded, workloads.make_runtime(loaded, device=dev))
    speedup = v1_save_us / max(stall_us, 1.0)
    out = {"stream_save_stall_us": stall_us, "chunked_save_us": v2_save_us,
           "v1_save_us": v1_save_us, "load_us": load_us,
           "bytes_per_packet": streamed.nbytes / streamed.total_packets,
           "v1_bytes": os.path.getsize(v1_path), "v2_bytes": nbytes,
           "stall_speedup_over_v1": speedup}
    emit("fig13.trace.stream_save_stall_us", stall_us,
         f"end-of-run stall of a streamed recording ({streamed.nbytes} bytes "
         "already on disk)")
    emit("fig13.trace.chunked_save_us", v2_save_us, f"buffered v2 save, {nbytes} bytes")
    emit("fig13.trace.v1_save_us", v1_save_us,
         f"v1 monolithic save, {out['v1_bytes']} bytes")
    emit("fig13.trace.load_us", load_us, "chunked decode + dict expand")
    emit("fig13.trace.bytes_per_packet", out["bytes_per_packet"],
         f"payload-dictionary chunks, {streamed.total_packets} pkts")
    emit("fig13.trace.stall_speedup_over_v1", speedup,
         f"the reference's floor is {STREAM_SPEEDUP_FLOOR:.0f}x (reported)")
    bad = sum((not identical, not rep["ok"], rep["digest_ok"] is not True))
    emit("fig13.audit.stream_codec_mismatch", bad,
         f"expect=0: byte-identical={identical} replay_ok={rep['ok']} "
         f"digest_ok={rep['digest_ok']}")
    if bad:
        raise RuntimeError(f"fig13 codec: identical={identical} rep={rep['ok']} "
                           f"digest_ok={rep['digest_ok']}")
    return out


def run(dev, emit) -> dict:
    import numpy as np
    from repro_torch.core import executor

    bank = executor.init_bank(np.random.default_rng(0), NUM_SLOTS, device=dev)
    return {"stream": stream_overhead(bank, dev, emit),
            "detector": detector_sweep(bank, dev, emit),
            "codec": stream_codec(bank, dev, emit)}


def main(argv=None) -> int:
    return common.main(run, __doc__, "fig13_obs", argv)


if __name__ == "__main__":
    sys.exit(main())
