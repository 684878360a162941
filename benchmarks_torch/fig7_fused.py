#!/usr/bin/env python3
"""Fig. 7 on the port: the fused forwarding kernel against the staged paths.

    python3 benchmarks_torch/fig7_fused.py [--device cpu]
        [--json build/fig7_fused.json]

The port's counterpart of ``benchmarks/fig7_fused.py``, at its shapes: 512
random payloads over a random 16-slot bank, slots from the random access
trace over 4 and 16 slots; microseconds per packet of ``packet_step`` with
the ``fused`` (one launch of ``csrc/fused_forward.cu`` reading the packet
rows in place), ``grouped`` (the kernel on the payload view) and
``grouped_staged`` (scatter to a padded layout, the kernel in contiguous
mode, gather back) strategies at ``block_b`` 32 and 128, and the per-row
``take`` baseline.  On the card the structural audit counts the fused
kernel's launches per ``packet_step`` (the fused path must launch it once;
the reference counts ``pallas_call`` sites in a traced program instead).
Last, the boundary replay of 2048 packets at batch 256, blocking per batch
against the bounded in-flight stream (kpps, best of 3).
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmarks_torch import common  # noqa: E402

BATCH = 512
STRATEGIES = ("fused", "grouped", "grouped_staged")


def run(dev, emit, batch: int = BATCH) -> None:
    import numpy as np
    from repro_torch.core import executor, packet as pkt, pipeline, switching
    from repro_torch.kernels import fused_forward as ff

    bank16 = executor.init_bank(np.random.default_rng(0), 16, device=dev)
    rng = np.random.default_rng(0)
    payload = rng.integers(0, 2**32, (batch, pkt.PAYLOAD_WORDS), dtype=np.uint32)
    for num_slots in (4, 16):
        slots = switching.access_trace("random", batch, num_slots, seed=2)
        packets = pkt.to_device(pkt.make_packets(slots, payload), dev)
        for strategy in STRATEGIES:
            for block_b in (32, 128):
                t = common.time_us(lambda: pipeline.packet_step(
                    bank16, packets, num_slots=num_slots, strategy=strategy,
                    block_b=block_b), dev, iters=10) / batch
                emit(f"fig7.{strategy}.K{num_slots}.bb{block_b}.us_per_packet", t,
                     "one-launch" if strategy == "fused" else "staged")
        t = common.time_us(lambda: pipeline.packet_step(
            bank16, packets, num_slots=num_slots, strategy="take"), dev, iters=10) / batch
        emit(f"fig7.take.K{num_slots}.us_per_packet", t, "per-row gather baseline")

    if dev.type == "cuda":
        slots = switching.access_trace("hotspot", batch, 16, seed=3)
        packets = pkt.to_device(pkt.make_packets(slots, payload), dev)
        for strategy in ("fused", "grouped_staged"):
            ff.fused_forward.launches.clear()
            pipeline.packet_step(bank16, packets, num_slots=16, strategy=strategy,
                                 block_b=128)
            n = sum(ff.fused_forward.launches.values())
            emit(f"fig7.audit.{strategy}.kernel_launches", n, "expect=1")
            if n != 1:
                raise RuntimeError(f"fig7: {strategy} launched the kernel {n} times")

    n = 2048
    trace = switching.boundary_trace(n, payload[np.arange(n) % batch])
    bank2 = executor.init_bank(np.random.default_rng(1), 2, device=dev)

    def kpps(stream: bool) -> float:
        best = 0.0
        for _ in range(3):
            res = switching.replay_trace(bank2, trace, num_slots=2, batch=256,
                                         stream=stream)
            if res.wrong_verdict:
                raise RuntimeError(f"fig7: replay wrong_verdict={res.wrong_verdict}")
            best = max(best, n / res.timestamps_us[-1] * 1e3)
        return best

    emit("fig7.replay.sync_kpps", kpps(False), "block per batch")
    emit("fig7.replay.stream_kpps", kpps(True), "bounded in-flight window")


def main(argv=None) -> int:
    return common.main(run, __doc__, "fig7_fused", argv)


if __name__ == "__main__":
    sys.exit(main())
