"""The harness's own tests (CPU; card-only cases carry the ``cuda`` marker
and skip without a card).  Run from the repository root:

    python -m pytest -q bench/tests
"""

import json
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))

# Tiny shapes for runs of whole cells on the CPU: the same code paths at a
# size a test can hold (the plain kernel versions run there).
SMALL = {
    "h32-k16-q4.steady-sat": {
        "config": {"runtime": {"batch": 64, "ring_capacity": 512}},
        "mix": {"burst": 256, "pool_bursts": 4}},
    "h32-k2-q1.boundary-sat": {
        "config": {"runtime": {"batch": 128, "ring_capacity": 512}},
        "mix": {"burst": 128, "pool_bursts": 4, "phases": [
            {"name": "boundary", "flows": 64, "monitor_frac": 0.1,
             "slots": {"kind": "blocks", "block": 64, "order": [0, 1]}}]}},
    "h32-k16-q4.emergency-paced": {
        "config": {"runtime": {"batch": 64, "ring_capacity": 4096}},
        "mix": {"burst": 16, "base_rate_pps": 1500}},
    "h32-k2-q1.trickle-paced": {
        "config": {"runtime": {"batch": 128, "ring_capacity": 1024}},
        "mix": {"burst": 4, "base_rate_pps": 800, "pool_rows": 1024}},
}


@pytest.fixture(scope="session")
def bench_root(tmp_path_factory):
    """A checkout whose ``BENCHMARK.json`` also lists the held cells
    (``held_cells.json``): built and tested here, left out of the benchmark
    until their runs spread less (PERF.md, Open questions)."""
    held = json.loads((BENCH / "tests" / "held_cells.json").read_text())
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    for key in ("workloads", "end_to_end", "per_layer"):
        doc[key] += held[key]
    root = tmp_path_factory.mktemp("checkout")
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    (root / "bench").symlink_to(BENCH)
    (root / "src").symlink_to(ROOT / "src")
    return root


@pytest.fixture
def card():
    """The card, or a skip: decided inside the test, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
