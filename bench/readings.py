"""The two readings the correctness limit is set from, for one cell.

    python bench/readings.py --workload <cell> --seeds 1,2,3 --seconds 3

runs the cell once per seed in one process, as ``run.py`` does, and prints a
JSON line per seed with the program's count of wrong answers (the lower
reading) and the control's: the plain reference with W2 rounded to TF32, the
precision next below the configuration's float32, put in the program's place
for the same served packets and judged by the same comparison (the upper
reading).  It exits 1 where the program is not correct or the control is.
The benchmark's own runs do not run the control.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    a = p.parse_args(argv)
    sys.path.insert(0, str(HERE))
    from benchkit import runner

    ok = True
    for seed in (int(s) for s in a.seeds.split(",")):
        t = time.perf_counter()
        res = runner.run_cell(HERE.parent, a.workload, seed, a.seconds, False,
                              control=True)
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "wrong_answers": res["checks"]["wrong_answers"]["value"],
                          "conservation_errors":
                              res["checks"]["conservation_errors"]["value"],
                          "correct": res["correct"],
                          "control_wrong":
                              res["control"]["checks"]["wrong_answers"]["value"],
                          "control_correct": res["control"]["correct"],
                          "attempted": res["attempted"], "failed": res["failed"],
                          "metrics": {k: v["value"] for k, v in res["metrics"].items()},
                          "seconds": time.perf_counter() - t}), flush=True)
        ok &= res["correct"] and not res["control"]["correct"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
