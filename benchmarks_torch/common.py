"""Shared helpers of the port's paper-figure benchmarks (``fig4_runtime``,
``fig5_scaling``, ``fig6_slot_behavior``, ``fig7_fused``,
``table4_continuity``, ``table5_controlplane``): wall-clock timing that
waits for the device, the two trained slots and the validation payloads
they are timed on, and the standalone entry point every script shares.

Each script exposes ``run(dev, emit)``, which measures at the reference
benchmark's shapes and reports through ``emit(name, value, note)``;
``chip_smoke.py`` calls each ``run`` once.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if os.path.join(ROOT, "src") not in sys.path:
    sys.path.insert(0, os.path.join(ROOT, "src"))

TRAIN_EPOCHS, TRAIN_SAMPLES = 2, 512      # the reference's ``trained_bank``


def time_us(fn, dev, iters: int = 50, warmup: int = 3) -> float:
    """Median over 5 repeats of the mean wall time per call of ``fn`` in
    microseconds, waiting for the device's queued work at the end of each
    repeat (the reference's ``block_until_ready``)."""
    import numpy as np
    from repro_torch.device import synchronize

    for _ in range(warmup):
        fn()
    synchronize(dev)
    per = max(iters // 5, 1)
    reps = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(per):
            fn()
        synchronize(dev)
        reps.append((time.perf_counter() - t0) / per)
    return float(np.median(reps)) * 1e6


@functools.lru_cache(maxsize=2)
def trained_bank(dev):
    """The paper's two slots, trained once per device: (bank, slot0, slot1)."""
    from repro_torch.core import bank as bank_lib
    from repro_torch.train import bnn

    s0, s1 = bnn.train_slot_pair(seed=0, epochs=TRAIN_EPOCHS,
                                 samples_per_group=TRAIN_SAMPLES, device=dev)
    return bank_lib.stack_bank([s0, s1]), s0, s1


@functools.lru_cache(maxsize=4)
def val_payload(n: int = 4096):
    """``n`` validation payloads (uint32 words) and labels, the split tiled."""
    import numpy as np
    from repro_torch.data import packets as pk

    xb, yb = pk.load_split("val", max(n // 2, 256), 0)
    w = pk.to_payload_words(xb)
    reps = -(-n // w.shape[0])
    return np.tile(w, (reps, 1))[:n], np.tile(yb, reps)[:n]


def bank_with_slots(num_slots: int, dev):
    """The paper's scaling setup: the two trained slots alternated."""
    from repro_torch.core import bank as bank_lib

    _, s0, s1 = trained_bank(dev)
    return bank_lib.stack_bank([s0 if i % 2 == 0 else s1 for i in range(num_slots)])


def main(run, doc: str, name: str, argv=None) -> int:
    """The standalone entry of a figure script: ``--device`` (CUDA unless
    ``cpu`` is asked for), the card's name and power limit on the card, one
    ``name,value,note`` line per number, and the numbers as one JSON object
    under ``build/`` (``--json``)."""
    p = argparse.ArgumentParser(description=doc.splitlines()[0])
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--json", default=os.path.join(ROOT, "build", f"{name}.json"))
    args = p.parse_args(argv)

    import torch
    from repro_torch.device import resolve_device

    dev = resolve_device(args.device)
    out = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
    if dev.type == "cuda":
        if ROOT not in sys.path:
            sys.path.insert(0, ROOT)
        from chip_smoke import nvidia_smi
        out["card"] = nvidia_smi("name,power.limit")
        print(out["card"], flush=True)

    def emit(key: str, value, note: str = "") -> None:
        out[key] = value
        print(f"{key},{value},{note}", flush=True)

    run(dev, emit)
    os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
    with open(args.json, "w") as f:
        json.dump(out, f, indent=1)
    return 0
