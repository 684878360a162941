#!/usr/bin/env python3
"""Table IV on the port: switching continuity on the paced 8192-packet run.

    python3 benchmarks_torch/table4_continuity.py [--device cpu]
        [--json build/table4_continuity.json]

The port's counterpart of ``benchmarks/table4_continuity.py``: the boundary
trace of 8192 validation payloads (slot 0, then slot 1) replayed one packet
per step at 10 us pacing over the two trained slots: median and boundary
inter-completion gaps, the forwarding rate in the 512 packets before and
after the boundary, the wrong-slot and wrong-verdict counts, and the
slot-1 packets delivered after it.  The paper: gaps 93.03 / 95.58 us,
10.49 / 10.85 kpps, zero wrong packets, 4096 delivered.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmarks_torch import common  # noqa: E402

N_PACKETS, PACING_US = 8192, 10.0


def run(dev, emit, n_packets: int = N_PACKETS, pacing_us: float = PACING_US) -> None:
    from repro_torch.core import switching

    bank, _, _ = common.trained_bank(dev)
    payload, _ = common.val_payload(n_packets)
    trace = switching.boundary_trace(n_packets, payload)
    res = switching.replay_trace(bank, trace, num_slots=2, pacing_us=pacing_us, batch=1)
    g, k = res.gap_stats_us(), res.rate_kpps(window=512)
    emit("table4.median_gap_us", g["median_gap_us"], "paper=93.03")
    emit("table4.boundary_gap_us", g["boundary_gap_us"], "paper=95.58")
    emit("table4.rate_before_kpps", k["before_kpps"], "paper=10.49")
    emit("table4.rate_after_kpps", k["after_kpps"], "paper=10.85")
    emit("table4.wrong_slot", float(res.wrong_slot), "paper=0")
    emit("table4.wrong_verdict", float(res.wrong_verdict), "paper=0")
    sink = res.slots[res.boundary_index:]
    emit("table4.sink_phase_delivered", float((sink == 1).sum()),
         f"paper=4096 (of {n_packets // 2})")
    if res.wrong_slot or res.wrong_verdict:
        raise RuntimeError(f"table4: wrong_slot={res.wrong_slot} "
                           f"wrong_verdict={res.wrong_verdict}")


def main(argv=None) -> int:
    return common.main(run, __doc__, "table4_continuity", argv)


if __name__ == "__main__":
    sys.exit(main())
