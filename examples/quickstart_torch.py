"""Quickstart on the PyTorch/CUDA port: the BoundSwitch mechanism.

Build a resident bank of two BNN models, assemble fixed-format packets whose
reg0 metadata selects the slot, and run them through the shared forwarding
path — switching models at packet granularity with no pipeline change.
The bank is random, drawn from ``np.random.default_rng(0)``, so its scores
are not the reference quickstart's (which draws from ``jax.random``).

Run:  PYTHONPATH=src python examples/quickstart_torch.py            # CUDA
      PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""

import argparse

import numpy as np

from repro_torch.core import bank as bank_lib
from repro_torch.core import executor, packet as pkt, pipeline
from repro_torch.device import resolve_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    dev = resolve_device(ap.parse_args(argv).device)

    # 1. preload K=2 resident models (paper Eq. 2-3): one bank, fixed layout
    bank = executor.init_bank(np.random.default_rng(0), num_slots=2, device=dev)
    print(f"resident bank: {bank_lib.bank_size(bank)} slots, "
          f"{bank_lib.bank_bytes(bank)} bytes on {dev} "
          f"(paper Table II: 2 slots = 65864 B)")

    # 2. make packets: 1088 B = reg0 metadata + 1024 B payload (paper §II-B)
    rng = np.random.default_rng(0)
    payload = rng.integers(0, 2**32, (8, pkt.PAYLOAD_WORDS), dtype=np.uint32)
    slots = np.array([0, 1, 0, 1, 0, 0, 1, 1])   # the 4-byte Model Slot ID field
    packets = pkt.to_device(pkt.make_packets(slots, payload), dev)

    # 3. one shared pipeline: parse -> sigma -> resident slot -> BNN -> Pi
    result = pipeline.packet_step(bank, packets, num_slots=2, strategy="take")
    for i in range(8):
        print(f"packet {i}: slot={int(result.slots[i])} "
              f"score={float(result.scores[i]):+8.3f} "
              f"action={'DROP' if int(result.actions[i]) else 'FORWARD'}")

    # 4. the paper's single-sample demo: same payload, different reg0 ->
    #    different verdict, same program
    p = pkt.make_packets(np.array([0]), payload[:1])
    s0 = float(pipeline.packet_step(bank, pkt.to_device(p, dev), num_slots=2).scores[0])
    p[:, pkt.SLOT_WORD] = 1
    s1 = float(pipeline.packet_step(bank, pkt.to_device(p, dev), num_slots=2).scores[0])
    print(f"\nslot flip on identical payload: {s0:+.4f} -> {s1:+.4f} "
          f"(paper: +1.98715 -> -0.01814)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
