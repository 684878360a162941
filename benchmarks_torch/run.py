#!/usr/bin/env python3
"""The port's benchmark suite: every figure of ``benchmarks_torch`` in one run.

    python3 benchmarks_torch/run.py [--device cpu] [--only NAME[,NAME]]
        [--json PATH] [--compare BASELINE.json]

The counterpart of ``benchmarks/run.py``.  Runs each figure's
``run(dev, emit)`` (``--only`` picks figures by script name, e.g.
``fig8_dataplane,fig15_swap``), prints one ``name,value,note`` line per
number, keeps going when a figure raises (and exits 1 at the end),
writes the numbers as one name -> value JSON map with ``--json``, and with
``--compare`` exits 2 when any number shared with the baseline regressed
by more than 25%: a rate (``*kpps``, ``*mpps``, ``*pps``) by dropping,
anything else (µs, bytes, counts) by growing, and an ``expect=0`` audit
whose baseline is 0 by any non-zero value.  A baseline must be a map that
this script wrote (it carries the key ``PORT_KEY``): the ``BENCH_*.json``
files hold the JAX package's numbers on a CPU and are never a baseline
for the port.  On the card it prints the card's name and power limit
first.
"""

import argparse
import importlib
import json
import os
import sys
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmarks_torch import common  # noqa: E402,F401  (puts src/ on the path)

FIGURES = ("fig4_runtime", "fig5_scaling", "fig6_slot_behavior", "fig7_fused",
           "fig8_dataplane", "fig8m_megastep", "fig9_control", "fig10_mesh",
           "fig11_workloads", "fig12_faults", "fig13_obs", "fig14_deploy",
           "fig15_swap", "table4_continuity", "table5_controlplane")
REGRESSION_THRESHOLD = 0.25
# keys where larger is better (throughput); everything else is
# us/bytes/launch-count style where smaller is better
HIGHER_BETTER = ("kpps", "mpps", "pps")
PORT_KEY = "benchmarks_torch.run"       # marks a map this script wrote


def is_throughput(key: str) -> bool:
    return any(key.endswith(suf) for suf in HIGHER_BETTER)


def compare_results(results: dict, baseline: dict,
                    threshold: float = REGRESSION_THRESHOLD) -> list[str]:
    """Regressions of ``results`` against ``baseline`` over their shared
    keys (the reference's rule, without its machine-speed normalization)."""
    regressions = []
    for key in sorted(set(results) & set(baseline)):
        base, new = baseline[key], results[key]
        if is_throughput(key):
            if base > 0 and new < base * (1 - threshold):
                regressions.append(f"{key}: {new:.4g} < {base:.4g} "
                                   f"(-{(1 - new / base) * 100:.0f}%)")
        elif base == 0:
            if new > 0:
                regressions.append(f"{key}: {new:.4g} > 0 (baseline 0)")
        elif new > base * (1 + threshold):
            regressions.append(f"{key}: {new:.4g} > {base:.4g} "
                               f"(+{(new / base - 1) * 100:.0f}%)")
    return regressions


def load_baseline(path: str) -> dict:
    """A baseline written by this script; anything else is refused."""
    with open(path) as f:
        baseline = json.load(f)
    if not isinstance(baseline, dict) or PORT_KEY not in baseline:
        raise SystemExit(f"{path} was not written by benchmarks_torch/run.py "
                         f"(no {PORT_KEY!r} key): the BENCH_*.json files are the "
                         "JAX package's CPU numbers, not a baseline for the port")
    return baseline


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--only", default=None,
                    help="comma-separated figure names (default: all)")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="also write the numbers as a name -> value JSON map")
    ap.add_argument("--compare", metavar="BASELINE", default=None,
                    help="a map written by --json; exit 2 on a regression of "
                         f"more than {REGRESSION_THRESHOLD:.0%}".replace("%", "%%")
                         + " in any shared key")
    args = ap.parse_args(argv)
    names = list(FIGURES)
    if args.only:
        wanted = args.only.split(",")
        unknown = sorted(set(wanted) - set(FIGURES))
        if unknown:
            ap.error(f"unknown figure(s) {unknown} (known: {list(FIGURES)})")
        names = [n for n in FIGURES if n in wanted]
    baseline = load_baseline(args.compare) if args.compare else None

    from repro_torch.device import resolve_device

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        from chip_smoke import nvidia_smi
        print(nvidia_smi("name,power.limit"), flush=True)

    results = {PORT_KEY: 1}

    def emit(key: str, value, note: str = "") -> None:
        print(f"{key},{value},{note}", flush=True)
        if isinstance(value, (int, float)) and not isinstance(value, bool):
            results[key] = value

    print("name,value,note")
    failures = 0
    for name in names:
        try:
            importlib.import_module(f"benchmarks_torch.{name}").run(dev, emit)
        except Exception as e:  # keep the suite running
            failures += 1
            print(f"{name}.ERROR,0,{type(e).__name__}: {e}", flush=True)
            traceback.print_exc(file=sys.stderr)

    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(results, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"# wrote {len(results)} entries to {args.json}", file=sys.stderr)
    if baseline is not None:
        regressions = compare_results(results, baseline)
        shared = len(set(results) & set(baseline))
        print(f"# compared {shared} shared keys vs {args.compare}: "
              f"{len(regressions)} regression(s)", file=sys.stderr)
        for r in regressions:
            print(f"# REGRESSION {r}", file=sys.stderr)
        if regressions:
            return 2
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
