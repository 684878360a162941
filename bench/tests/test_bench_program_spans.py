"""The readers of the program's own spans (``ctx["spans"]``, the data
plane's ``SpanRecorder.summary()``): each reads its spans per 1000 rows of
its denominator's span, None where the run recorded no spans, and each
resolves as the per-layer entry that names it would ask."""

import json
import math
import shutil
import sys

import numpy as np
import pytest

from benchkit.spec import Spec
from conftest import BENCH, ROOT

CELLS = ["h32-k16-q4.steady-sat", "h32-k2-q1.boundary-sat"]

SPANS = {       # name: (total_s, self_s, rows)
    "dp.dispatch": (1.0, 0.05, 4000),
    "dp.dispatch.hash": (0.6, 0.6, None),
    "dp.dispatch.push": (0.3, 0.3, None),
    "dp.tick": (0.9, 0.02, None),
    "dp.tick.pop": (0.04, 0.04, 3000),
    "dp.tick.stage": (0.11, 0.11, 2000),
    "dp.tick.h2d": (0.2, 0.2, None),
    "dp.tick.launch": (0.25, 0.25, None),
    "dp.retire": (0.28, 0.03, 2000),
    "dp.retire.wait": (0.1, 0.1, None),
    "dp.retire.d2h": (0.05, 0.05, None),
    "dp.retire.tap": (0.07, 0.07, None),
    "dp.retire.account": (0.03, 0.03, None),
}

# metric: host seconds it reads in SPANS, over the rows of its denominator
EXPECTED = {
    "rss_hash_us_per_kpkt.sat": (0.6, 4000),
    "ring_push_us_per_kpkt.sat": (0.3, 4000),
    "tick_stage_us_per_kpkt.sat": (0.04 + 0.11, 2000),
    "h2d_us_per_kpkt.sat": (0.2, 2000),
    "launch_us_per_kpkt.sat": (0.25, 2000),
    "retire_wait_us_per_kpkt.sat": (0.1, 2000),
    "retire_host_us_per_kpkt.sat": (0.03 + 0.05 + 0.03, 2000),
}


def _summary():
    out = {}
    for name, (total, own, rows) in SPANS.items():
        out[name] = {"count": 10, "total_s": total, "self_s": own,
                     "parent": name.rsplit(".", 1)[0] if name.count(".") > 1 else None}
        if rows is not None:
            out[name]["rows"] = rows
    return out


def _entries():
    return [{"name": m, "unit": "us/kpkt", "better": "lower",
             "source": "program_span",
             "layer": "arrival edge" if m.split("_")[0] in ("rss", "ring") else "tick",
             "moves": "fwd_kpps", "workloads": list(CELLS)} for m in EXPECTED]


@pytest.fixture(scope="module")
def readers(tmp_path_factory):
    """The seven entries added to a copy of the benchmark, resolved by the
    harness as a benchmark that lists them would resolve them."""
    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(BENCH, root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "src").symlink_to(ROOT / "src")
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    doc["per_layer"] += _entries()
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    spec = Spec(root)
    out = {}
    for cell in CELLS:
        c = spec.cell(cell)
        names = [m.name for m in c.per_layer]
        assert names[-len(EXPECTED):] == list(EXPECTED)
        out.update({m.name: m.reader for m in c.per_layer if m.name in EXPECTED})
    return out


@pytest.mark.parametrize("metric", list(EXPECTED))
def test_reader_of_program_spans(readers, metric):
    seconds, rows = EXPECTED[metric]
    reader = readers[metric]
    assert reader.read({"spans": _summary()}) == pytest.approx(
        seconds * 1e6 / (rows / 1e3))
    assert reader.read({"spans": None}) is None
    assert reader.read({}) is None          # a run that hands over no spans
    empty = {k: dict(v, rows=0) if "rows" in v else v
             for k, v in _summary().items()}
    assert reader.read({"spans": empty}) is None


def test_readers_of_a_recorded_run_split_the_layers(readers):
    """Spans a runtime recorded on the CPU: every reader finite and
    positive, and the arrival edge's two parts inside ``dp.dispatch``."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import executor
    from repro_torch.dataplane import DataplaneRuntime

    rng = np.random.default_rng(7)
    bank = executor.init_bank(rng, 2, executor.BNNConfig(hidden=16),
                              device="cpu")
    rt = DataplaneRuntime(bank, num_queues=2, batch=64, ring_capacity=256,
                          backend="ref", device="cpu")
    rt.spans.start()
    for _ in range(4):
        rows = rng.integers(0, 2**32, (100, 272), dtype=np.uint32)
        rows[:, 0] = rng.integers(0, 2, 100)
        rt.dispatch(rows)
        rt.tick()
    rt.drain()
    rt.spans.stop()
    ctx = {"spans": rt.spans.summary()}
    vals = {m: readers[m].read(ctx) for m in EXPECTED}
    assert all(math.isfinite(v) and v > 0 for v in vals.values()), vals
    d = ctx["spans"]["dp.dispatch"]
    edge = vals["rss_hash_us_per_kpkt.sat"] + vals["ring_push_us_per_kpkt.sat"]
    assert edge <= d["total_s"] * 1e6 / (d["rows"] / 1e3)
