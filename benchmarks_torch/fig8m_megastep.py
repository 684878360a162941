#!/usr/bin/env python3
"""Fig. 8m on the port: the megastep window-length sweep.

    python3 benchmarks_torch/fig8m_megastep.py [--device cpu] [--reps 3]
        [--json build/fig8m_megastep.json]

The port's counterpart of ``benchmarks/fig8_dataplane.py::megastep_main``,
at its shapes (4 slots, batch 128, ``block_b`` 32, ring 8192, the
emergency storyline ``emergency_phases(4)`` from seed 0, fused strategy):
the served rate (kpps, best of ``--reps``) at ``megastep_ticks`` 1, 8 and
64 with 4 queues, and at window 8 with 1 and 2 queues; then the structural
audit, a recorded sequential run against a recorded, audited window-8 run,
whose completion-stream digests must be equal with zero wrong verdicts.
Prints the card's name and power limit first (on the card), one line per
number, and writes them as one JSON object to ``--json`` (under
``build/``, never a ``BENCH_*.json``).  ``chip_smoke.py`` runs ``sweep`` at
the emergency runtime's shape.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if os.path.join(ROOT, "src") not in sys.path:
    sys.path.insert(0, os.path.join(ROOT, "src"))

NUM_SLOTS, BATCH, BLOCK_B, RING = 4, 128, 32, 8192
WINDOWS = (1, 8, 64)
MEGASTEP_TICKS = 8           # the launch CLI's --megastep-ticks default


def sweep(new_runtime, scenario, windows=WINDOWS, *, reps: int = 3) -> dict:
    """Play ``scenario`` on ``new_runtime(w)`` ``reps`` times for each
    window ``w``; returns ``{w: best run}``, each run with its kpps over the
    whole scenario, its kpps per phase and, for a recording runtime, its
    completion-stream digest.  Raises unless every run conserves packets
    with zero wrong verdicts, runs the engine exactly when ``w > 1``, and
    (recording) every digest is equal."""
    from repro_torch.dataplane import play
    from repro_torch.dataplane.workloads.trace import digest

    best, digests = {}, set()
    for w in windows:
        for _ in range(reps):
            rt = new_runtime(w)
            t0 = time.perf_counter()
            reports = play(rt, scenario)
            dt = time.perf_counter() - t0
            aud = rt.audit_conservation()
            if not aud["ok"] or aud["wrong_verdict"]:
                raise RuntimeError(f"window {w}: conservation {aud['ok']}, "
                                   f"wrong_verdict {aud['wrong_verdict']}")
            if (rt._mega is not None) != (w > 1):
                raise RuntimeError(f"window {w}: engine {rt._mega}")
            if rt._record:
                digests.add(digest(rt)["sha256"])
            done = sum(r["completed"] for r in reports)
            run = {"kpps": done / dt / 1e3, "completed": done,
                   "wrong_verdict": aud["wrong_verdict"],
                   "phase_kpps": {r["phase"]: r["kpps"] for r in reports}}
            if w not in best or run["kpps"] > best[w]["kpps"]:
                best[w] = run
    if len(digests) > 1:
        raise RuntimeError(f"completion streams differ across windows {windows}")
    for run in best.values():
        run["digest"] = next(iter(digests), None)
    return best


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--json", default=os.path.join(ROOT, "build", "fig8m_megastep.json"))
    args = p.parse_args(argv)

    import numpy as np
    import torch
    from repro_torch.core import executor
    from repro_torch.dataplane import DataplaneRuntime, emergency_phases, render
    from repro_torch.device import resolve_device

    dev = resolve_device(args.device)
    out = {"device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu")}
    if dev.type == "cuda":
        from chip_smoke import nvidia_smi
        out["card"] = nvidia_smi("name,power.limit")
        print(out["card"], flush=True)
    bank = executor.init_bank(np.random.default_rng(0), NUM_SLOTS, device=dev)
    scenario = render(emergency_phases(NUM_SLOTS), num_slots=NUM_SLOTS, seed=0)

    def factory(num_queues, **kw):
        return lambda w: DataplaneRuntime(
            bank, num_queues=num_queues, strategy="fused", batch=BATCH,
            block_b=BLOCK_B, ring_capacity=RING, megastep_ticks=w,
            device=dev, **kw)

    def emit(key, value):
        out[key] = value
        print(f"{key} {value}", flush=True)

    for w, run in sweep(factory(4), scenario, WINDOWS, reps=args.reps).items():
        emit(f"fig8m.fused.q4.t{w}.kpps", run["kpps"])
    for q in (1, 2):
        run = sweep(factory(q), scenario, (MEGASTEP_TICKS,), reps=args.reps)
        emit(f"fig8m.fused.q{q}.t{MEGASTEP_TICKS}.kpps", run[MEGASTEP_TICKS]["kpps"])

    # structural audit: a recorded sequential run and a recorded, audited
    # window run must give the same completion streams (sweep raises if not)
    seq = sweep(factory(4, record=True), scenario, (1,), reps=1)
    meg = sweep(factory(4, record=True, audit=True), scenario,
                (MEGASTEP_TICKS,), reps=1)
    emit("fig8m.audit.megastep_digest_mismatch",
         int(seq[1]["digest"] != meg[MEGASTEP_TICKS]["digest"]))
    emit("fig8m.audit.wrong_verdict", meg[MEGASTEP_TICKS]["wrong_verdict"])
    if out["fig8m.audit.megastep_digest_mismatch"]:
        raise RuntimeError("the window's completion streams differ from the sequential loop's")
    os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
    with open(args.json, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    sys.exit(main())
