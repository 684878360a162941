#!/usr/bin/env python3
"""Render the roofline table from the port's dry-run JSONs (the
counterpart of ``benchmarks/report.py``).

    python3 benchmarks_torch/report.py [--dir build/dryrun_torch]   # print tables
    python3 benchmarks_torch/report.py --write    # splice into EXPERIMENTS.md
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmarks_torch.roofline import RESULTS, load_cells  # noqa: E402


def roofline_markdown(cells) -> str:
    out = []
    for mesh in ("single", "multi"):
        out.append(f"\n### {'Single-pod 16×16 (256 GPUs)' if mesh == 'single' else 'Multi-pod 2×16×16 (512 GPUs)'}\n")
        out.append("| arch | shape | compute_s | memory_s | collective_s | "
                   "dominant | useful_FLOPs | mem/dev GiB | what would move the dominant term |")
        out.append("|---|---|---|---|---|---|---|---|---|")
        for c in cells:
            if c.get("mesh") != mesh and c.get("status") == "ok":
                continue
            parts = c["cell"].split("|")
            if c.get("status") == "skipped":
                if parts[2] != mesh:
                    continue
                out.append(f"| {parts[0]} | {parts[1]} | — | — | — | *skipped* | — | — | "
                           f"full attention: no sub-quadratic 500k decode |")
                continue
            if c.get("status") != "ok" or c.get("variant", "baseline") != "baseline":
                continue
            r = c["roofline"]
            mem = c["memory"].get("per_device_total", 0) / 2**30
            ratio = c.get("useful_flops_ratio") or 0
            out.append(
                f"| {c['arch']} | {c['shape']} | {r['compute_s']:.4g} "
                f"| {r['memory_s']:.4g} | {r['collective_s']:.4g} "
                f"| **{r['dominant']}** | {ratio:.3f} | {mem:.2f} "
                f"| {_advice(c)} |")
    return "\n".join(out)


def _advice(c) -> str:
    r = c["roofline"]
    dom = r["dominant"]
    coll = c["analysis"]["collective_bytes"]
    if dom == "collective":
        top = max((k for k in coll), key=lambda k: coll[k])
        return f"cut {top} traffic (dominant collective class)"
    if dom == "memory":
        if c["kind"] == "decode":
            return "KV/state cache traffic: quantize cache or widen batch"
        return "fuse the eager elementwise passes (flash attention, fused norms)"
    return "tensor-core-align block shapes; remove masked-block waste"


def splice(path: str, marker: str, content: str):
    with open(path) as f:
        text = f.read()
    if marker not in text:
        raise ValueError(f"{path}: no {marker} marker")
    text = text.replace(marker, marker + "\n" + content)
    with open(path, "w") as f:
        f.write(text)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--write", action="store_true")
    ap.add_argument("--dir", default=RESULTS)
    args = ap.parse_args(argv)
    cells = load_cells(args.dir)
    md = roofline_markdown(cells)
    if args.write:
        splice(os.path.join(ROOT, "EXPERIMENTS.md"), "<!-- ROOFLINE_TABLE -->", md)
        print("spliced roofline table into EXPERIMENTS.md")
    else:
        print(md)


if __name__ == "__main__":
    main()
