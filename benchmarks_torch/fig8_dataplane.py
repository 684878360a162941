#!/usr/bin/env python3
"""Fig. 8 on the port: the multi-queue data plane's scaling and audits.

    python3 benchmarks_torch/fig8_dataplane.py [--device cpu]
        [--json build/fig8_dataplane.json]

The port's counterpart of ``benchmarks/fig8_dataplane.py``, at its shapes:
a 4-slot bank from ``np.random.default_rng(0)``, the emergency storyline
``emergency_phases(4)`` rendered from seed 0, batch 128, ``block_b`` 32.
It sweeps 1, 2 and 4 queues against the ``fused`` strategy (megastep
window 8, best of 3) and ``take`` (per-tick loop, best of 2) at ring 8192
(no drops: every run must complete every packet and conserve), and
reports how many queue counts have fused slower than take
(``fused_beats_take``, which must be 0, as in the reference).  On the card
the structural audit counts the fused kernel's launches for one
queue-block's ``packet_step`` (it must be 1); the reference walks a traced
program for ``pallas_call`` sites instead, and its
``payload_roundtrip_bytes`` (payload-sized scatters and gathers in that
program) has no counterpart in an eagerly run PyTorch program, so it is
not reported.  Last, the backpressure run: 4 queues at ring 512 with the
audit on and window 8; it raises unless packets are conserved, the flash
crowd tail-drops, and no verdict is wrong across the online swap.
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmarks_torch import common  # noqa: E402

NUM_SLOTS = 4
BATCH = 128
BLOCK_B = 32
MEGASTEP_TICKS = 8       # the fused sweep's window, as in the reference
QUEUES = (1, 2, 4)


def _run_scenario(bank, trace, dev, num_queues: int, strategy: str, *,
                  ring_capacity: int = 1024, audit: bool = False,
                  megastep_ticks: int = 1):
    from repro_torch.dataplane import DataplaneRuntime, play

    rt = DataplaneRuntime(
        bank, num_queues=num_queues, strategy=strategy, batch=BATCH,
        block_b=BLOCK_B, ring_capacity=ring_capacity, audit=audit,
        megastep_ticks=megastep_ticks, device=dev)
    t0 = time.perf_counter()
    reports = play(rt, trace)
    dt = time.perf_counter() - t0
    return rt, reports, dt


def check(ok: bool, what) -> None:
    if not ok:
        raise RuntimeError(f"fig8: {what}")


def run(dev, emit) -> None:
    import numpy as np
    from repro_torch.core import executor, packet as pkt, pipeline
    from repro_torch.dataplane import emergency_phases, render
    from repro_torch.kernels import fused_forward as ff

    bank = executor.init_bank(np.random.default_rng(0), NUM_SLOTS, device=dev)
    trace = render(emergency_phases(NUM_SLOTS), num_slots=NUM_SLOTS, seed=0)

    # queue count x strategy, best of 3 (fused, deferred window) or 2 (take)
    best_by = {}
    for num_queues in QUEUES:
        for strategy in ("fused", "take"):
            mt = MEGASTEP_TICKS if strategy == "fused" else 1
            reps = 3 if strategy == "fused" else 2
            best = 0.0
            for _ in range(reps):
                rt, _, dt = _run_scenario(bank, trace, dev, num_queues, strategy,
                                          ring_capacity=8192, megastep_ticks=mt)
                aud = rt.audit_conservation()
                check(aud["ok"], aud)
                done = aud["totals"]["completed"]
                check(done == trace.total_packets, aud)  # big rings: no drops
                best = max(best, done / dt / 1e3)
            best_by[(strategy, num_queues)] = best
            emit(f"fig8.{strategy}.q{num_queues}.kpps", best,
                 f"{done} pkts {rt.fanout}-fanout best-of-{reps}")
    losses = sum(best_by[("fused", q)] < best_by[("take", q)] for q in QUEUES)
    emit("fig8.audit.fused_beats_take", losses,
         "expect=0 queue counts where fused < take")
    check(losses == 0, f"fused slower than take at some queue count: {best_by}")

    # one fused launch per queue-block (counted on the card)
    if dev.type == "cuda":
        qpackets = pkt.to_device(pkt.make_packets(
            np.arange(BATCH) % NUM_SLOTS,
            np.random.default_rng(0).integers(
                0, 2**32, (BATCH, pkt.PAYLOAD_WORDS), dtype=np.uint32)), dev)
        ff.fused_forward.launches.clear()
        pipeline.packet_step(bank, qpackets, num_slots=NUM_SLOTS, strategy="fused",
                             block_b=BLOCK_B)
        n = sum(ff.fused_forward.launches.values())
        emit("fig8.audit.launches_per_queue_block", n, "expect=1")
        check(n == 1, f"{n} fused launches for one queue-block")

    # conservation under backpressure + swap continuity
    rt, reports, _ = _run_scenario(bank, trace, dev, 4, "fused", ring_capacity=512,
                                   audit=True, megastep_ticks=MEGASTEP_TICKS)
    aud = rt.audit_conservation()
    check(aud["ok"], aud)
    t = aud["totals"]
    check(t["offered"] == t["completed"] + t["dropped"], t)
    check(t["offered"] == trace.total_packets, t)
    crowd = next(r for r in reports if r["phase"] == "flash_crowd")
    emit("fig8.audit.flash_crowd_dropped", crowd["dropped"],
         "counted tail-drops under backpressure")
    emit("fig8.audit.wrong_verdict_during_swap", aud["wrong_verdict"],
         "expect=0 across online slot swap")
    check(crowd["dropped"] > 0, crowd)
    check(aud["wrong_verdict"] == 0, aud)


def main(argv=None) -> int:
    return common.main(run, __doc__, "fig8_dataplane", argv)


if __name__ == "__main__":
    sys.exit(main())
