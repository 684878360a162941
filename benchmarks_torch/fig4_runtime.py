#!/usr/bin/env python3
"""Fig. 4 on the port: runtime breakdown of the packet path.

    python3 benchmarks_torch/fig4_runtime.py [--device cpu]
        [--json build/fig4_runtime.json]

The port's counterpart of ``benchmarks/fig4_runtime.py``, at its shape: 4096
packets of the validation payloads over the two trained slots, alternating;
slot selection alone, single-slot inference alone, and the whole
``packet_step`` (take strategy), each in microseconds per packet, and the
throughput in Mpps and Gbps.  The paper's numbers (x86 AVX-512, one core)
ride along as notes: selection 0.005 us, inference 0.528 us, e2e 0.894 us,
1.894 Mpps.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmarks_torch import common  # noqa: E402

BATCH = 4096


def run(dev, emit, batch: int = BATCH) -> None:
    import numpy as np
    from repro_torch.core import packet as pkt, pipeline

    bank, s0, _ = common.trained_bank(dev)
    payload, _ = common.val_payload(batch)
    packets = pkt.to_device(pkt.make_packets(np.arange(batch) % 2, payload), dev)
    pw = pkt.payload_of(packets)
    t_sel = common.time_us(lambda: pipeline.slot_select_only(packets, 2), dev) / batch
    t_inf = common.time_us(lambda: pipeline.inference_only(s0, pw), dev) / batch
    t_e2e = common.time_us(lambda: pipeline.packet_step(
        bank, packets, num_slots=2, strategy="take"), dev) / batch
    mpps = 1.0 / t_e2e
    emit("fig4.slot_selection_us", t_sel, "paper=0.005")
    emit("fig4.inference_us", t_inf, "paper=0.528")
    emit("fig4.e2e_packet_path_us", t_e2e, "paper=0.894")
    emit("fig4.throughput_mpps", mpps, "paper=1.894")
    emit("fig4.gbps_1024B", mpps * pkt.PAYLOAD_BYTES * 8 / 1e3, "paper=15.52")
    emit("fig4.gbps_1500B", mpps * 1500 * 8 / 1e3, "paper=22.73")
    emit("fig4.selection_vs_inference_ratio", t_sel / t_inf, "selection<<inference")


def main(argv=None) -> int:
    return common.main(run, __doc__, "fig4_runtime", argv)


if __name__ == "__main__":
    sys.exit(main())
