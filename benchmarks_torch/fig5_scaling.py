#!/usr/bin/env python3
"""Fig. 5 on the port: resident-bank scaling from 2 to 16 slots.

    python3 benchmarks_torch/fig5_scaling.py [--device cpu]
        [--json build/fig5_scaling.json]

The port's counterpart of ``benchmarks/fig5_scaling.py``, at its shape: 2048
validation payloads, banks of 2 and 16 slots (the two trained slots
alternated), under the fixed, round-robin, random and hotspot slot-access
traces: slot selection alone and selection plus inference (``packet_step``,
take strategy), in microseconds per packet, and a check that every slot id
resolves.  The paper: selection flat at about 0.0037 us, selection plus
inference 0.67-0.92 us.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmarks_torch import common  # noqa: E402

BATCH = 2048
SLOTS = (2, 16)
TRACES = ("fixed", "round_robin", "random", "hotspot")


def run(dev, emit, batch: int = BATCH) -> None:
    import numpy as np
    from repro_torch.core import packet as pkt, pipeline, switching

    payload, _ = common.val_payload(batch)
    for n_slots in SLOTS:
        bank = common.bank_with_slots(n_slots, dev)
        for kind in TRACES:
            slots = switching.access_trace(kind, batch, n_slots)
            packets = pkt.to_device(pkt.make_packets(slots, payload), dev)
            t_sel = common.time_us(
                lambda: pipeline.slot_select_only(packets, n_slots), dev) / batch
            t_both = common.time_us(lambda: pipeline.packet_step(
                bank, packets, num_slots=n_slots, strategy="take"), dev) / batch
            emit(f"fig5.select_us.{n_slots}slots.{kind}", t_sel, "paper~0.0037")
            emit(f"fig5.select_plus_infer_us.{n_slots}slots.{kind}", t_both,
                 "paper=0.67-0.92")
            res = pipeline.packet_step(bank, packets, num_slots=n_slots)
            if not (res.slots.cpu().numpy() == slots).all():
                raise RuntimeError(f"fig5: slot ids misresolved ({n_slots} slots, {kind})")


def main(argv=None) -> int:
    return common.main(run, __doc__, "fig5_scaling", argv)


if __name__ == "__main__":
    sys.exit(main())
