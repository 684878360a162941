#!/usr/bin/env python3
"""Hillclimb driver: run optimization variants of the port's dry-run for
the three selected cells and report deltas against the baseline dry-run
JSONs (the counterpart of ``benchmarks/hillclimb.py``).

    python3 benchmarks_torch/hillclimb.py [--out build/perf_torch]
        [--baseline-dir build/dryrun_torch] [--cells ABC]

Each variant runs in this process (``run_cell`` builds and destroys its
own fake process group).
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmarks_torch import common  # noqa: E402,F401  (puts src/ on the path)

CELLS = {
    # worst useful-FLOPs ratio in the reference: 15 heads % 16 != 0 ->
    # attention replicated across the TP axis
    "A": ("smollm-360m", "train_4k",
          ["flashremat", "seqshard", "flashremat+seqshard"]),
    # most collective-bound in the reference: FSDP contraction-dim sharding
    # makes partial-sum all-reduces of (B, 32k, d) activations
    "B": ("arctic-480b", "prefill_32k", ["serve2d", "serve2d+seqshard"]),
    # most technique-representative: decode against a 32k cache
    "C": ("glm4-9b", "decode_32k", ["int8cache"]),
}


def main(argv=None):
    from repro_torch.launch import dryrun

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "perf_torch"))
    ap.add_argument("--baseline-dir", default=os.path.join(ROOT, "build", "dryrun_torch"))
    ap.add_argument("--cells", default="ABC")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    failed = 0
    for key in args.cells:
        arch, shape, variants = CELLS[key]
        base_file = os.path.join(args.baseline_dir, f"{arch}_{shape}_single.json")
        with open(base_file) as f:
            base = json.load(f)
        br = base["roofline"]
        print(f"\n=== cell {key}: {arch} | {shape} | single ===")
        print(f"baseline: compute={br['compute_s']:.4f}s "
              f"memory={br['memory_s']:.4f}s collective={br['collective_s']:.4f}s "
              f"dominant={br['dominant']} bound={br['step_s_lower_bound']:.4f}s")
        for variant in variants:
            try:
                res = dryrun.run_cell(arch, shape, multi_pod=False, variant=variant)
            except Exception as e:  # reported and counted: the run exits 1
                print(f"  {variant}: ERROR {type(e).__name__}: {e}")
                failed += 1
                continue
            if res["status"] != "ok":
                print(f"  {variant}: {res['status']} {res.get('error', '')[:200]}")
                failed += 1
                continue
            r = res["roofline"]
            speedup = br["step_s_lower_bound"] / max(r["step_s_lower_bound"], 1e-12)
            print(f"  {variant}: compute={r['compute_s']:.4f}s "
                  f"memory={r['memory_s']:.4f}s collective={r['collective_s']:.4f}s "
                  f"dominant={r['dominant']} bound={r['step_s_lower_bound']:.4f}s "
                  f"speedup={speedup:.2f}x "
                  f"mem/dev={res['memory'].get('per_device_total', 0)/2**30:.1f}GiB "
                  f"seconds={res['compile_seconds']:.1f}")
            fname = f"{arch}_{shape}_single_{variant.replace('+', '_')}.json"
            with open(os.path.join(args.out, fname), "w") as f:
                json.dump(res, f, indent=1)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
