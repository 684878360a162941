"""A run loads neither JAX nor the JAX package, and reads nothing of the
JAX package's benchmarks: ``run.py`` on the CPU gets as far as it can
before the card is needed (spec, program import, traffic), exits 2 with no
result, and the modules it loaded are listed."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT

PROBE = r"""
import json, runpy, sys
sys.argv = ["bench/run.py", "--workload", sys.argv[1], "--seed", "4294967311",
            "--seconds", "1", "--trace", "0"]
try:
    runpy.run_path("bench/run.py", run_name="__main__")
except SystemExit as e:
    code = e.code
print(json.dumps({"code": code,
                  "top": sorted({m.split(".")[0] for m in sys.modules})}))
"""


def _env():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return env


@pytest.mark.parametrize("cell", ["h32-k16-q4.steady-sat", "mamba2-130m-h4.chat-sat"])
def test_setup_loads_no_jax_and_no_reference_package(cell):
    out = subprocess.run([sys.executable, "-c", PROBE, cell],
                         cwd=ROOT, env=_env(), capture_output=True, text=True,
                         timeout=300)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["code"] == 2, out.stderr[-2000:]
    assert "needs 1 CUDA device" in out.stderr
    top = set(res["top"])
    assert "repro_torch" in top and "torch" in top      # it got that far
    assert not top & {"jax", "jaxlib", "flax", "repro", "benchmarks",
                      "benchmarks_torch"}


def test_harness_sources_name_no_reference_package():
    for path in BENCH.rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.replace(",", " ").split()
            if words[:1] in (["import"], ["from"]):
                top = words[1].split(".")[0]
                assert top not in {"jax", "jaxlib", "flax", "repro", "benchmarks",
                                   "benchmarks_torch"}, (path, line)


def test_a_checkout_of_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "bench/run.py", "--workload",
                          "h32-k2-q1.boundary-sat", "--seed", "1", "--seconds",
                          "1", "--trace", "0"], cwd=tmp_path, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
