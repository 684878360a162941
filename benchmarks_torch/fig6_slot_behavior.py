#!/usr/bin/env python3
"""Fig. 6 on the port: slot-conditioned behaviour.

    python3 benchmarks_torch/fig6_slot_behavior.py [--device cpu]
        [--json build/fig6_slot_behavior.json]

The port's counterpart of ``benchmarks/fig6_slot_behavior.py``: precision,
recall and F1 (percent) of the recall-oriented slot 0 (pos_weight 4.0)
and the precision-oriented slot 1 (pos_weight 0.5) on 2048 validation
payloads, then the single-sample flip: the payload whose two scores differ
most (with a verdict flip where there is one) sent through ``packet_step``
under slot 0 and under slot 1, only reg0 changed.  The paper: 1.98715
under slot 0, -0.0181384 under slot 1.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmarks_torch import common  # noqa: E402

SAMPLES = 2048


def run(dev, emit, n: int = SAMPLES) -> None:
    import numpy as np
    from repro_torch.core import executor, packet as pkt, pipeline
    from repro_torch.train import bnn

    bank, s0, s1 = common.trained_bank(dev)
    payload, labels = common.val_payload(n)
    for name, slot in (("slot0_recall_oriented", s0), ("slot1_precision_oriented", s1)):
        m = bnn.evaluate(slot, payload, labels)
        for metric in ("precision", "recall", "f1"):
            emit(f"fig6.{name}.{metric}", m[metric] * 100, "percent")
    x = pkt.to_device(payload, dev)
    sc0 = executor.forward(s0, x)[:, 0].cpu().numpy()
    sc1 = executor.forward(s1, x)[:, 0].cpu().numpy()
    flip = (sc0 > 0) != (sc1 > 0)
    gap = np.abs(sc0 - sc1)
    idx = int(np.argmax(gap * flip)) if flip.any() else int(np.argmax(gap))
    p0 = pkt.to_device(pkt.make_packets(np.zeros(1), payload[idx:idx + 1]), dev)
    p1 = pkt.to_device(pkt.make_packets(np.ones(1), payload[idx:idx + 1]), dev)
    y0 = float(pipeline.packet_step(bank, p0, num_slots=2).scores[0])
    y1 = float(pipeline.packet_step(bank, p1, num_slots=2).scores[0])
    emit("fig6.single_sample.slot0_score", y0, "paper=1.98715")
    emit("fig6.single_sample.slot1_score", y1, "paper=-0.0181384")
    emit("fig6.single_sample.verdict_flipped", float((y0 > 0) != (y1 > 0)),
         "1.0=behaviour altered by slot choice alone")


def main(argv=None) -> int:
    return common.main(run, __doc__, "fig6_slot_behavior", argv)


if __name__ == "__main__":
    sys.exit(main())
