"""A cell made of added files alone (a configuration, a mix and a metric
copied under new names; a configuration that turns the recorder on, names a
routing policy and attaches an observer; a mix with a generator of its
own; a serving configuration with a reference of its own) is found,
validated and run by the harness with no edit to any file it already has.
A configuration resolves to the runner it names, and without one to the
data plane's."""

import json
import shutil
from pathlib import Path

import pytest

from benchkit import runner
from benchkit.spec import Spec, SpecError
from conftest import BENCH, ROOT, SERVE_SMALL, SMALL


@pytest.fixture
def checkout(tmp_path):
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "src").symlink_to(ROOT / "src")
    return tmp_path


def test_added_files_make_a_cell(checkout):
    before = {p: p.read_bytes() for p in (checkout / "bench").rglob("*") if p.is_file()}
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    shutil.copy(checkout / "bench/configs/h32-k2-q1.json",
                checkout / "bench/configs/h32-k2-q1-copy.json")
    shutil.copy(checkout / "bench/traffic/boundary-sat.json",
                checkout / "bench/traffic/boundary-copy.json")
    shutil.copy(checkout / "bench/metrics/tick_us_per_kpkt.py",
                checkout / "bench/metrics/tick_copy_us_per_kpkt.py")
    doc["configs"].append(dict(doc["configs"][1], name="h32-k2-q1-copy",
                               file="bench/configs/h32-k2-q1-copy.json"))
    cell = "h32-k2-q1-copy.boundary-copy"
    doc["workloads"].append({"name": cell, "config": "h32-k2-q1-copy",
                             "traffic": "boundary-copy", "chips": 1,
                             "why": "a copy"})
    for m in doc["end_to_end"]:
        if m["name"] == "fwd_kpps":
            m["workloads"].append(cell)
    doc["per_layer"].append({"name": "tick_copy_us_per_kpkt", "unit": "us/kpkt",
                             "better": "lower", "source": "host_clock",
                             "layer": "tick", "moves": "fwd_kpps",
                             "workloads": [cell]})
    (checkout / "BENCHMARK.json").write_text(json.dumps(doc))

    c = Spec(checkout).cell(cell)
    assert c.config["runtime"]["batch"] == 8192
    assert [m.name for m in c.end_to_end] == ["fwd_kpps", "setup_s"]
    assert [m.name for m in c.per_layer] == ["tick_copy_us_per_kpkt"]
    res = runner.run_cell(checkout, cell, 11, 0.5, False, device="cpu",
                          overrides=SMALL["h32-k2-q1.boundary-sat"], log=lambda s: None)
    assert res["correct"] and res["metrics"]["fwd_kpps"]["value"] > 0
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_a_missing_reader_is_refused(checkout):
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    doc["per_layer"].append({"name": "no_such_metric", "unit": "us",
                             "better": "lower", "source": "host_clock",
                             "layer": "tick", "moves": "fwd_kpps",
                             "workloads": ["h32-k2-q1.boundary-sat"]})
    (checkout / "BENCHMARK.json").write_text(json.dumps(doc))
    with pytest.raises(SpecError, match="no_such_metric"):
        Spec(checkout).cell("h32-k2-q1.boundary-sat")


HOOK = """from repro_torch.deploy import PacketSampler
from repro_torch.obs import TelemetryStream, attach as wire


def attach(runtime):
    wire(runtime, TelemetryStream())
    runtime.sampler = PacketSampler(num_slots=runtime.num_slots).attach(runtime)
"""

GENERATOR = """from pathlib import Path

from benchkit import traffic


def build(mix, **kw):
    t = traffic.build({k: v for k, v in mix.items() if k != "generator"}, **kw)
    t.pool = t.pool[::-1].copy()
    (Path(__file__).parent / "built.txt").write_text(str(kw["seed"]))
    return t
"""


def test_a_recorded_observed_cell_with_a_generator_of_its_own(checkout, monkeypatch):
    from repro_torch.dataplane.runtime import DataplaneRuntime

    before = {p: p.read_bytes() for p in (checkout / "bench").rglob("*") if p.is_file()}
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((checkout / "bench/configs/h32-k16-q4.json").read_text())
    cfg["runtime"]["record"] = True
    cfg["runtime"]["policy"] = "least-depth"
    cfg["attach"] = ["observed_hook"]
    (checkout / "bench/configs/h32-k16-q4-observed.json").write_text(json.dumps(cfg))
    (checkout / "bench/configs/observed_hook.py").write_text(HOOK)
    mix = json.loads((checkout / "bench/traffic/steady-sat.json").read_text())
    mix["generator"] = "reversed_pool"
    (checkout / "bench/traffic/reversed-sat.json").write_text(json.dumps(mix))
    (checkout / "bench/traffic/reversed_pool.py").write_text(GENERATOR)
    doc["configs"].append(dict(doc["configs"][0], name="h32-k16-q4-observed",
                               file="bench/configs/h32-k16-q4-observed.json"))
    cell = "h32-k16-q4-observed.reversed-sat"
    doc["workloads"].append({"name": cell, "config": "h32-k16-q4-observed",
                             "traffic": "reversed-sat", "chips": 1, "why": "a copy"})
    for m in doc["end_to_end"] + doc["per_layer"]:
        if "h32-k16-q4.steady-sat" in m.get("workloads", ()):
            m["workloads"].append(cell)
    (checkout / "BENCHMARK.json").write_text(json.dumps(doc))

    made = []
    real = DataplaneRuntime.__init__

    def init(self, *a, **k):
        made.append((self, k))
        real(self, *a, **k)

    monkeypatch.setattr(DataplaneRuntime, "__init__", init)
    res = runner.run_cell(checkout, cell, 2**31 + 5, 0.5, False, device="cpu",
                          overrides=SMALL["h32-k16-q4.steady-sat"], log=lambda s: None)
    assert res["correct"], res["checks"]
    (rt, kw), = made
    assert kw["record"] is True and kw["audit"] is False
    assert type(rt.policy).__name__ == "LeastDepth"
    assert rt.control.on_record is not None            # the hook ran
    assert rt.sampler._pending or rt.sampler.seen      # its tap too
    assert sum(map(len, rt.completed_seq)) > 0          # the recorder ran
    assert (checkout / "bench/traffic/built.txt").read_text() == str(2**31 + 5)
    assert {p: p.read_bytes() for p in before} == before


@pytest.mark.parametrize("held", [False, True])
def test_every_cell_resolves(held, bench_root):
    root = bench_root if held else ROOT
    doc = json.loads((root / "BENCHMARK.json").read_text())
    spec = Spec(root)
    used = set()
    for w in doc["workloads"]:
        c = spec.cell(w["name"])
        assert c.end_to_end and c.per_layer
        used.add(w["config"])
    assert used == {c["name"] for c in doc["configs"]}


def test_a_configuration_resolves_to_its_runner(bench_root):
    spec = Spec(bench_root)
    for cell in ("h32-k16-q4.steady-sat", "h32-k2-q1.boundary-sat",
                 "h32-k16-q4-mega8.steady-sat"):
        assert spec.cell(cell).runner is None      # the data plane's run_cell
    serve = spec.cell("mamba2-130m-h4.chat-sat").runner
    assert Path(serve.__file__).resolve() == BENCH / "runners" / "serve.py"
    assert serve.run_cell is not runner.run_cell


def test_a_missing_runner_is_refused(checkout):
    cfg = json.loads((checkout / "bench/configs/h32-k2-q1.json").read_text())
    cfg["runner"] = "no_such_runner"
    (checkout / "bench/configs/h32-k2-q1.json").write_text(json.dumps(cfg))
    (checkout / "BENCHMARK.json").write_text((ROOT / "BENCHMARK.json").read_text())
    with pytest.raises(SpecError, match="no_such_runner"):
        Spec(checkout).cell("h32-k2-q1.boundary-sat")


def test_a_serving_cell_of_added_files(checkout, monkeypatch, one_thread):
    # a later serving configuration: its file, its reference and a mix,
    # copied under new names, and entries in BENCHMARK.json
    from benchkit import spec as spec_mod

    before = {p: p.read_bytes() for p in (checkout / "bench").rglob("*") if p.is_file()}
    cfg = json.loads((checkout / "bench/configs/mamba2-130m-h4.json").read_text())
    cfg["name"], cfg["reference"] = "mamba2-130m-h2", "mamba2_lm_copy"
    cfg["model"]["bank_slots"] = 2
    (checkout / "bench/configs/mamba2-130m-h2.json").write_text(json.dumps(cfg))
    shutil.copy(checkout / "bench/configs/mamba2_lm.py",
                checkout / "bench/configs/mamba2_lm_copy.py")
    shutil.copy(checkout / "bench/traffic/chat-sat.json",
                checkout / "bench/traffic/chat-copy.json")
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    doc["configs"].append({"name": "mamba2-130m-h2", "source": "a copy",
                           "file": "bench/configs/mamba2-130m-h2.json",
                           "reduced": [], "why": "a copy"})
    cell = "mamba2-130m-h2.chat-copy"
    doc["workloads"].append({"name": cell, "config": "mamba2-130m-h2",
                             "traffic": "chat-copy", "chips": 1, "why": "a copy"})
    for m in doc["end_to_end"] + doc["per_layer"]:
        if "mamba2-130m-h4.chat-sat" in m.get("workloads", ()):
            m["workloads"].append(cell)
    (checkout / "BENCHMARK.json").write_text(json.dumps(doc))

    loaded = []
    real = spec_mod._module
    monkeypatch.setattr(spec_mod, "_module",
                        lambda path, name: loaded.append(path) or real(path, name))
    c = Spec(checkout).cell(cell)
    assert [m.name for m in c.end_to_end] == ["serve_tok_s", "setup_s"]
    assert checkout / "bench/configs/mamba2_lm_copy.py" in loaded
    res = runner.run_cell(checkout, cell, 2**31 + 13, 2.0, False, device="cpu",
                          overrides=SERVE_SMALL["mamba2-130m-h4.chat-sat"],
                          log=lambda s: None)
    assert res["correct"], res["checks"]
    assert res["metrics"]["serve_tok_s"]["value"] > 0
    assert {p: p.read_bytes() for p in before} == before
