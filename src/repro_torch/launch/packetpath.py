"""The serving half of the paper's end-to-end driver, on the port.

Builds a K-slot resident bank from ``--seed`` (or loads one saved by the
reference with ``--bank file.npz``: keys ``w1p`` uint32, ``b1``, ``w2``,
``b2`` float32, each with a leading slot axis), then replays a boundary
stream over the synthetic IoT-23-like payloads through the shared
forwarding pipeline and reports the batched rate and the continuity
counts ``wrong_slot`` / ``wrong_verdict``.  Training is not ported.

    python -m repro_torch.launch.packetpath --packets 8192 --strategy fused
    python -m repro_torch.launch.packetpath --device cpu --packets 512 --batch 64
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.core import bank as bank_lib
from repro_torch.core import executor, packet as pkt, pipeline, switching
from repro_torch.data import packets as pk
from repro_torch.device import resolve_device, synchronize

STRATEGIES = ("take", "onehot", "grouped", "grouped_staged", "fused")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--packets", type=int, default=8192)
    ap.add_argument("--slots", type=int, default=2,
                    help="bank size K when the bank is made from --seed")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bank", default=None,
                    help="load the bank from this .npz instead")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--strategy", default="fused", choices=STRATEGIES)
    ap.add_argument("--stream", action="store_true",
                    help="streaming replay: a bounded window of in-flight "
                         "batches instead of waiting on each")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    return ap


def run(args: argparse.Namespace) -> dict:
    dev = resolve_device(args.device)
    if args.bank:
        with np.load(args.bank) as z:
            bank = bank_lib.from_jax_bank({k: z[k] for k in z.files}, dev)
    else:
        bank = executor.init_bank(np.random.default_rng(args.seed),
                                  args.slots, device=dev)
    k = bank_lib.bank_size(bank)
    print(f"resident bank: {k} slots, {bank_lib.bank_bytes(bank)} bytes on {dev}")

    xb, _ = pk.load_split("val", 1024, args.seed)
    w = pk.to_payload_words(xb)
    trace = switching.boundary_trace(args.packets, w[np.arange(args.packets) % w.shape[0]])

    print("== boundary replay ==")
    x = pkt.to_device(trace, dev)

    def step():
        return pipeline.packet_step(bank, x, num_slots=k, strategy=args.strategy)

    step()
    synchronize(dev)
    iters = 5
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    synchronize(dev)
    dt = (time.perf_counter() - t0) / iters
    mpps = args.packets / dt / 1e6
    print(f"batched pipeline: {mpps:.3f} Mpps ({dt / args.packets * 1e6:.4f} us/pkt), "
          f"{mpps * pkt.PAYLOAD_BYTES * 8 / 1e3:.2f} Gbps @1024B payload")

    rr = switching.replay_trace(bank, trace, num_slots=k, batch=args.batch,
                                strategy=args.strategy, stream=args.stream)
    g = rr.gap_stats_us()
    r = rr.rate_kpps()
    print(f"replay: wrong_slot={rr.wrong_slot} wrong_verdict={rr.wrong_verdict} "
          f"median_gap={g['median_gap_us']:.2f}us "
          f"boundary_gap={g['boundary_gap_us']:.2f}us "
          f"rate before/after boundary: {r['before_kpps']:.1f}/{r['after_kpps']:.1f} kpps")
    return {"mpps": mpps, "seconds_per_batch": dt, "packets": args.packets,
            "slots": k, "strategy": args.strategy,
            "wrong_slot": rr.wrong_slot, "wrong_verdict": rr.wrong_verdict,
            "boundary_index": rr.boundary_index, **g, **r}


def main(argv=None) -> int:
    res = run(build_parser().parse_args(argv))
    return 0 if res["wrong_slot"] == 0 and res["wrong_verdict"] == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
