#!/usr/bin/env python3
"""Roofline report: aggregates the port's dry-run JSONs
(``python -m repro_torch.launch.dryrun --out build/dryrun_torch``) — per
(arch x shape x mesh): three terms, dominant bottleneck, MODEL_FLOPS ratio,
per-device memory.  The counterpart of ``benchmarks/roofline.py``; the
terms are one H100's (``repro_torch.distributed.roofline.HW``).

    python3 benchmarks_torch/roofline.py [--dir build/dryrun_torch]
"""

import argparse
import json
import os

RESULTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "build",
                       "dryrun_torch")


def load_cells(results_dir: str = RESULTS) -> list[dict]:
    cells = []
    if not os.path.isdir(results_dir):
        return cells
    for name in sorted(os.listdir(results_dir)):
        if name.endswith(".json"):
            with open(os.path.join(results_dir, name)) as f:
                cells.append(json.load(f))
    return cells


def fmt_table(cells: list[dict], mesh: str = "single") -> str:
    rows = ["| arch | shape | compute_s | memory_s | collective_s | dominant "
            "| useful_flops | mem/dev GiB |",
            "|---|---|---|---|---|---|---|---|"]
    for c in cells:
        if c.get("mesh") != mesh:
            continue
        if c.get("status") == "skipped":
            rows.append(f"| {c['cell'].split('|')[0]} | {c['cell'].split('|')[1]} "
                        f"| — | — | — | skipped | — | — |")
            continue
        if c.get("status") != "ok":
            continue
        r = c["roofline"]
        mem = c["memory"].get("per_device_total", 0) / 2**30
        ratio = c.get("useful_flops_ratio")
        rows.append(
            f"| {c['arch']} | {c['shape']} | {r['compute_s']:.4f} "
            f"| {r['memory_s']:.4f} | {r['collective_s']:.4f} "
            f"| {r['dominant']} | {ratio:.3f} | {mem:.2f} |")
    return "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=RESULTS)
    args = ap.parse_args(argv)
    cells = load_cells(args.dir)
    ok = [c for c in cells if c.get("status") == "ok"]
    if not ok:
        print("roofline.cells,0,no dry-run results found — run "
              "`python -m repro_torch.launch.dryrun --all --mesh both "
              "--out build/dryrun_torch`")
        return
    print(f"roofline.cells,{len(ok)},counted cells")
    by_dom = {}
    for c in ok:
        by_dom.setdefault(c["roofline"]["dominant"], []).append(c["cell"])
    for dom, cs in sorted(by_dom.items()):
        print(f"roofline.dominant.{dom},{len(cs)},e.g. {cs[0]}")
    train = [c for c in ok if c["kind"] == "train"]
    if train:
        worst = min(train, key=lambda c: c.get("useful_flops_ratio") or 0)
        print(f"roofline.worst_useful_flops,{worst.get('useful_flops_ratio'):.4f},"
              f"{worst['cell']}")
    most_coll = max(
        ok, key=lambda c: c["roofline"]["collective_s"]
        / max(c["roofline"]["step_s_lower_bound"], 1e-12))
    print(f"roofline.most_collective_bound,"
          f"{most_coll['roofline']['collective_s']:.4f},{most_coll['cell']}")


if __name__ == "__main__":
    main()
