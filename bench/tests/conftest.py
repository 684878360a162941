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
    "h32-k16-q4-mega8.steady-sat": {
        "config": {"runtime": {"batch": 64, "ring_capacity": 512}},
        "mix": {"burst": 256, "pool_bursts": 4}},
}

# The serving cells at a tiny size: a reduced model (every width cut, the
# padded vocabulary kept), four rows and short requests.  The tolerance is
# the tiny model's own: its bfloat16 runs read widest gaps of 0 to 0.014
# and its float8 control 0.155 to 0.46 (six seeds each),
# so 0.06 lies between them as the cell's limit lies between its readings.
SERVE_SMALL = {
    "mamba2-130m-h4.chat-sat": {
        "config": {"model": {"n_layers": 2, "d_model": 64, "ssm_head_dim": 16,
                             "ssm_state": 16, "ssm_chunk": 16, "vocab_size": 250,
                             "vocab_pad_multiple": 32},
                   "engine": {"max_batch": 4, "max_seq": 256,
                              "prefill_buckets": [16, 32, 64]},
                   "max_prompt_tokens": 64, "max_new_tokens": 40,
                   "check": {"tol": 0.06}},
        "mix": {"in_flight": 4, "requests": 64,
                "prompt": {"lognormal": {"mean": 30, "sigma": 0.7}},
                "output": {"lognormal": {"mean": 18, "sigma": 0.5}}}},
}


@pytest.fixture(scope="session")
def bench_root(tmp_path_factory):
    """A checkout whose ``BENCHMARK.json`` also lists the held cells
    (``held_cells.json``): built and tested here, left out of the benchmark
    until their runs spread less (PERF.md, Open questions)."""
    held = json.loads((BENCH / "tests" / "held_cells.json").read_text())
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        doc[key] += held.get(key, [])
    # held cells that report metrics the benchmark already has
    for m in doc["end_to_end"] + doc["per_layer"]:
        m.get("workloads", []).extend(held.get("also", {}).get(m["name"], []))
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


@pytest.fixture
def one_thread():
    """One torch thread, as ``run.py`` runs: several test workers on one
    host would otherwise share its cores among all their threads, and a
    timed window would serve too little to judge."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
