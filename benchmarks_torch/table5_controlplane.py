#!/usr/bin/env python3
"""Table V on the port: resident switching against online control-plane
replacement.

    python3 benchmarks_torch/table5_controlplane.py [--device cpu]
        [--json build/table5_controlplane.json]

The port's counterpart of ``benchmarks/table5_controlplane.py``, on the
boundary trace of 2048 validation payloads over the two trained slots:
the per-packet slot-resolution cost of resident switching and its wrong
packets on the first 1024 packets (one per step), then the control-plane
baseline paced at 10 us (slot 1's weights serialized, delivered and loaded
after the boundary): its switch latency, boundary-to-effective window and
wrong-model / wrong-verdict packets, and the ratio of the two latencies.
The paper: 0.005 us and 0 wrong against 484.896 us, 8479 us, 99 and 99.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmarks_torch import common  # noqa: E402

N_PACKETS, PACING_US = 2048, 10.0


def run(dev, emit, n_packets: int = N_PACKETS, pacing_us: float = PACING_US) -> None:
    from repro_torch.core import switching

    bank, s0, s1 = common.trained_bank(dev)
    payload, _ = common.val_payload(n_packets)
    trace = switching.boundary_trace(n_packets, payload)
    res = switching.replay_trace(bank, trace[:1024], num_slots=2, batch=1)
    cost = switching.resident_switch_cost_us(bank, trace[:1024], 2)
    emit("table5.resident.switch_latency_us", cost, "paper=0.005")
    emit("table5.resident.wrong_packets", float(res.wrong_verdict), "paper=0")
    cp = switching.control_plane_replay(s0, s1, trace, pacing_us=pacing_us)
    emit("table5.controlplane.switch_latency_us", cp.switch_latency_us, "paper=484.896")
    emit("table5.controlplane.boundary_to_effective_us", cp.boundary_to_effective_us,
         "paper=8479.45")
    emit("table5.controlplane.wrong_model_packets", float(cp.wrong_model_packets),
         "paper=99")
    emit("table5.controlplane.wrong_verdict_packets", float(cp.wrong_verdict_packets),
         "paper=99")
    emit("table5.latency_ratio_controlplane_over_resident",
         cp.switch_latency_us / max(cost, 1e-9), "paper~97000x")


def main(argv=None) -> int:
    return common.main(run, __doc__, "table5_controlplane", argv)


if __name__ == "__main__":
    sys.exit(main())
