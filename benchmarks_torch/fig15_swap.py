#!/usr/bin/env python3
"""Fig. 15 on the port: zero-copy model switching and the LRU slot cache.

    python3 benchmarks_torch/fig15_swap.py [--device cpu]
        [--json build/fig15_swap.json]

The port's counterpart of ``benchmarks/fig15_swap.py``, at its shapes:

* commit latency: the median barrier-apply cost (9 trials after 3 warm-up
  trials) of one ``SwapSlot`` epoch on the double-buffered runtime (the
  params staged into the shadow bank at submit, the commit a reference
  flip) against the single-bank runtime (``update_slot`` at the barrier),
  a 4-slot bank from ``np.random.default_rng(0)``, 4 queues, batch 128;
  ``flip_not_10x_faster`` is reported, not asserted, as in the reference;
* flip against re-stage: the emergency storyline through both commit
  paths with the audit and recording on; raises unless the completion
  streams are equal, packets conserved and no verdict wrong;
* LRU slot-cache churn: 16 resident slots (``default_rng(3)``) serving 96
  demands over 16, 32 and 48 registered models (``default_rng(7)``), 64
  packets of the demanded model per tick, audited: kpps, hits, misses and
  evictions per working set; raises on a wrong verdict or broken
  conservation; then the wall cost of a hit, a cold miss and a prefetched
  miss.
"""

import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmarks_torch import common  # noqa: E402

NUM_SLOTS = 4       # commit-latency section mirrors fig9's shape
NUM_QUEUES = 4
BATCH = 128

CACHE_SLOTS = 16    # churn section: the paper's max resident bank
CACHE_MODELS = (16, 32, 48)
CHURN_STEPS = 96
CHURN_BURST = 64


def check(ok: bool, what) -> None:
    if not ok:
        raise RuntimeError(f"fig15: {what}")


def _fresh_runtime(bank, dev, **kw):
    from repro_torch.dataplane import DataplaneRuntime

    kw.setdefault("num_queues", NUM_QUEUES)
    kw.setdefault("strategy", "fused")
    kw.setdefault("batch", BATCH)
    kw.setdefault("ring_capacity", 1024)
    return DataplaneRuntime(bank, device=dev, **kw)


def _swap_apply_us(rt, params, trials: int = 9, warmup: int = 3) -> float:
    """Median barrier-apply cost of a fresh single-SwapSlot epoch (a new
    command object per trial: staging keys on command identity)."""
    from repro_torch.control import SwapSlot

    samples = []
    for i in range(warmup + trials):
        rt.control.submit(SwapSlot(1, params))
        rt.flush_control()
        if i >= warmup:
            samples.append(rt.control.log[-1].apply_us)
    return float(statistics.median(samples))


def bench_commit_latency(bank, dev, emit) -> dict:
    from repro_torch.dataplane import workloads

    delivered = workloads.default_swap_delivery(1)
    flip_us = _swap_apply_us(_fresh_runtime(bank, dev), delivered)
    restage_us = _swap_apply_us(_fresh_runtime(bank, dev, double_buffer=False),
                                delivered)
    speedup = restage_us / max(flip_us, 1e-9)
    emit("fig15.commit.flip_us", flip_us,
         "shadow prestaged at submit; barrier commit = pointer flip")
    emit("fig15.commit.restage_us", restage_us,
         f"update_slot at the barrier; flip is {speedup:.1f}x faster")
    emit("fig15.audit.flip_not_10x_faster", int(flip_us * 10 > restage_us),
         f"expect=0 (flip {flip_us:.1f}us vs re-stage {restage_us:.1f}us; "
         "reported, not asserted)")
    return {"flip_us": flip_us, "restage_us": restage_us}


def bench_flip_restage_equivalence(bank, dev, emit) -> None:
    from repro_torch.dataplane import emergency_phases, play, render

    trace = render(emergency_phases(NUM_SLOTS), num_slots=NUM_SLOTS, seed=0)
    streams = {}
    wrong = 0
    for name, db in (("flip", True), ("restage", False)):
        rt = _fresh_runtime(bank, dev, ring_capacity=8192, audit=True,
                            record=True, double_buffer=db)
        play(rt, trace)
        aud = rt.audit_conservation()
        check(aud["ok"], aud)
        wrong += aud["wrong_verdict"]
        streams[name] = (rt.completed_seq, rt.completed_verdicts,
                         rt.completed_slots)
    mismatch = int(streams["flip"] != streams["restage"])
    emit("fig15.audit.flip_vs_restage_verdict_mismatch", mismatch,
         "expect=0: pointer-flip commits change nothing observable")
    emit("fig15.audit.flip_wrong_verdict", wrong,
         "expect=0 across both commit paths, audit mode")
    check(mismatch == 0, "flip and re-stage completion streams differ")
    check(wrong == 0, f"{wrong} wrong verdicts across the commit paths")


def _demand_sequence(n_models: int, steps: int, seed: int = 0) -> list[int]:
    """Deterministic skewed working set: a hot third revisits often, the
    cold tail returns periodically."""
    import numpy as np

    rng = np.random.default_rng(seed)
    hot = max(1, n_models // 3)
    out = []
    for i in range(steps):
        if rng.random() < 0.7:
            out.append(int(rng.integers(hot)))
        else:
            out.append(hot + (i % max(1, n_models - hot)))
    return out


def _register_models(cache, n_models: int, dev) -> list[str]:
    import numpy as np
    from repro_torch.core import bank as bank_lib, executor

    src = executor.init_bank(np.random.default_rng(7), n_models, device=dev)
    names = [f"m{i:02d}" for i in range(n_models)]
    for i, name in enumerate(names):
        cache.register(name, bank_lib.select_slot(src, i))
    return names


def bench_cache_churn(payload, dev, emit) -> None:
    import numpy as np
    from repro_torch.control import SlotCache
    from repro_torch.core import executor, packet as pkt
    from repro_torch.dataplane import DataplaneRuntime

    wrong_total = 0
    for n_models in CACHE_MODELS:
        bank = executor.init_bank(np.random.default_rng(3), CACHE_SLOTS, device=dev)
        rt = DataplaneRuntime(bank, num_queues=2, strategy="fused",
                              batch=CHURN_BURST, ring_capacity=2048, audit=True,
                              device=dev)
        cache = SlotCache(rt)
        names = _register_models(cache, n_models, dev)
        demand = _demand_sequence(n_models, CHURN_STEPS)
        done = 0
        t0 = time.perf_counter()
        for step, m in enumerate(demand):
            slot = cache.ensure(names[m])
            burst = pkt.make_packets(
                np.full(CHURN_BURST, slot),
                payload[(step * CHURN_BURST) % len(payload):][:CHURN_BURST])
            rt.dispatch(burst)
            done += rt.tick()
        done += rt.drain()
        dt = time.perf_counter() - t0
        aud = rt.audit_conservation()
        check(aud["ok"], aud)
        wrong_total += aud["wrong_verdict"]
        s = cache.stats()
        emit(f"fig15.cache.models{n_models}.kpps", done / dt / 1e3,
             f"{done} pkts, {CACHE_SLOTS} slots, hit_rate={s['hit_rate']:.2f}, "
             f"misses={s['misses']}, evictions={s['evictions']}")
    emit("fig15.audit.cache_wrong_verdict", wrong_total,
         f"expect=0 over {len(CACHE_MODELS)} churn sweeps, audit mode")
    check(wrong_total == 0, f"{wrong_total} wrong verdicts under cache churn")


def bench_cache_op_costs(dev, emit) -> None:
    """Wall cost of the three cache outcomes: resident hit (host-only),
    cold miss (stage + flip), prefetched miss (flip-only commit)."""
    import numpy as np
    from repro_torch.control import SlotCache
    from repro_torch.core import executor
    from repro_torch.dataplane import DataplaneRuntime
    from repro_torch.device import synchronize

    bank = executor.init_bank(np.random.default_rng(3), CACHE_SLOTS, device=dev)
    rt = DataplaneRuntime(bank, num_queues=2, strategy="fused",
                          batch=CHURN_BURST, ring_capacity=2048, device=dev)
    cache = SlotCache(rt)
    names = _register_models(cache, CACHE_SLOTS + 8, dev)
    for n in names[:CACHE_SLOTS]:      # fill the resident set
        cache.ensure(n)
    emit("fig15.cache.hit_us",
         common.time_us(lambda: cache.ensure(names[0]), dev, iters=200),
         "resident hit: pure host bookkeeping")

    cold = list(names[CACHE_SLOTS:])

    def miss(prefetch):
        m = cold.pop(0)
        cold.append(m)  # rotate so each trial is a genuine miss
        if prefetch:
            cache.prefetch(m)
        synchronize(dev)
        t0 = time.perf_counter()
        cache.ensure(m)
        rt.flush_control()
        synchronize(dev)
        return (time.perf_counter() - t0) * 1e6

    for _ in range(3):
        miss(False), miss(True)
    emit("fig15.cache.miss_us",
         float(statistics.median([miss(False) for _ in range(9)])),
         "cold miss: submit-time stage + flip commit")
    emit("fig15.cache.prefetched_miss_us",
         float(statistics.median([miss(True) for _ in range(9)])),
         "predicted miss: shadow pre-staged, commit flip-only")


def run(dev, emit) -> None:
    import numpy as np
    from repro_torch.core import executor, packet as pkt

    bank = executor.init_bank(np.random.default_rng(0), NUM_SLOTS, device=dev)
    rng = np.random.default_rng(11)
    payload = rng.integers(0, 2**32, size=(4096, pkt.PAYLOAD_WORDS), dtype=np.uint32)
    bench_commit_latency(bank, dev, emit)
    bench_flip_restage_equivalence(bank, dev, emit)
    bench_cache_churn(payload, dev, emit)
    bench_cache_op_costs(dev, emit)


def main(argv=None) -> int:
    return common.main(run, __doc__, "fig15_swap", argv)


if __name__ == "__main__":
    sys.exit(main())
