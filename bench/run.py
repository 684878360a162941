"""Run one cell of the benchmark once and print its result line.

    python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``src/repro_torch``.  The last line of
standard output is one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` a ``breakdown``, and last the
``checks``: each compared number with its limit).  The same checks are the
last lines of standard error.  Exit codes: 0 a result was printed; 2 the
card the cell asks for is missing; 3 JAX or the JAX package was loaded;
4 the latency tail is not finite (too many packets failed); 1 anything else.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "1")
    # every cache a library could keep lives at a fixed path in the checkout
    # (``build/`` is ignored by git); the program's own kernel libraries go
    # to ``build/kernels``
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR",
                     "torch_extensions"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(ROOT / "build" / "cache" / sub)
    sys.path.insert(0, str(HERE))
    from benchkit import runner

    try:
        res = runner.run_cell(ROOT, a.workload, a.seed, a.seconds, bool(a.trace),
                              t_start=T_START)
    except runner.NoDevice as e:
        print(f"no result: {e}", file=sys.stderr)
        return 2
    except runner.ForbiddenImport as e:
        print(f"no result: {e}", file=sys.stderr)
        return 3
    except runner.Overloaded as e:
        print(f"no result: {e}", file=sys.stderr)
        return 4
    except Exception:  # noqa: BLE001 - the run's boundary: report and fail
        traceback.print_exc()
        print("no result: the run failed", file=sys.stderr)
        return 1
    found = runner.forbidden_modules()
    if found:
        print("no result: loaded " + ", ".join(found), file=sys.stderr)
        return 3
    for name, c in res["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {name} {c['value']} limit {c['limit']} {ok}",
              file=sys.stderr)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
