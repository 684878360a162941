"""The port's data-plane CLI (``repro_torch.launch.dataplane``) against the
reference's (``repro.launch.dataplane``): the same flags plus ``--device``,
equal ``--json`` reports in every parity case (times excluded), the
observe server stopped on every exit path, the reference's
``--epoch-log-json`` case, and the pure helpers of the four data-plane
figures and the suite runner held equal to the reference's.

The port's CLI draws its bank, its slot-cache models and its default swap
delivery from NumPy generators, the reference from ``jax.random``; the
parity cases hand the port the reference's draws (``reference_draws``)."""

import functools
import importlib.util
import json
import pathlib
import threading
import time
import urllib.request

import jax
import numpy as np
import pytest
import torch

from _torch_parity import CPU, one_torch_thread, untimed, untimed_doc  # noqa: F401
from repro.core import executor as jexecutor
from repro.dataplane import workloads as jworkloads
from repro.launch import dataplane as jcli
from repro_torch.core import bank as tbank
from repro_torch.launch import dataplane as tcli

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMALL = ["--queues", "2", "--slots", "2", "--scale", "1"]


def _port(params) -> dict:
    return tbank.from_jax_bank({k: np.asarray(v) for k, v in params.items()}, CPU)


@functools.lru_cache(maxsize=None)
def _jax_bank(seed, slots):
    return jexecutor.init_bank(jax.random.PRNGKey(seed), slots)


@functools.lru_cache(maxsize=None)
def _jax_params(seed):
    return jexecutor.init_params(jax.random.PRNGKey(seed))


@functools.lru_cache(maxsize=None)
def _jax_delivery(slot):
    return jworkloads.default_swap_delivery(slot)


@pytest.fixture
def reference_draws(monkeypatch):
    """The port's CLI serves the reference's bank, slot-cache models and
    swap delivery."""
    monkeypatch.setattr(tcli, "initial_bank",
                        lambda seed, slots, device: _port(_jax_bank(seed, slots)))
    monkeypatch.setattr(tcli, "extra_model",
                        lambda seed, device: _port(_jax_params(seed)))
    monkeypatch.setattr(tcli, "swap_delivery",
                        lambda slot: _port(_jax_delivery(slot)))


def _flags(parser) -> dict:
    return {a.option_strings[0]: a for a in parser._actions if a.option_strings
            and a.option_strings[0] != "-h"}


def test_flag_set_is_the_reference_plus_device():
    ref, port = _flags(jcli.build_parser()), _flags(tcli.build_parser())
    assert set(port) == set(ref) | {"--device"}
    for name, a in ref.items():
        b = port[name]
        assert (b.default, b.choices, b.nargs, b.metavar, b.type, b.dest,
                b.option_strings) == (a.default, a.choices, a.nargs, a.metavar,
                                      a.type, a.dest, a.option_strings), name
        assert type(b) is type(a), name
    assert port["--device"].default is None


def report(doc: dict) -> dict:
    """Everything a ``--json`` report decides, without its times."""
    snap = doc["snapshot"]
    cons = snap["conservation"]
    return dict(
        phases=[{k: r[k] for k in ("phase", "offered", "completed", "dropped",
                                   "wrong_verdict")} for r in doc["phases"]],
        totals=cons["totals"], ok=cons["ok"], wrong=cons["wrong_verdict"],
        per_host=[h["totals"] for h in cons.get("per_host", [])],
        stranded=cons.get("stranded"),
        queues=[(q["queue"], q["completed"], q["per_slot_total"])
                for q in snap["queues"]],
        log=untimed(doc["control_log"]), snap_log=untimed(snap["control_log"]),
        continuity=untimed_doc(doc["continuity"]),
        deployments=snap["deployments"], slot_cache=snap.get("slot_cache"),
        counters=[snap[k] for k in ("completed_total", "dropped_total",
                                    "slot_swaps", "reta_updates", "wrong_verdict")])


def run_both(tmp_path, argv) -> tuple[dict, dict]:
    """Both CLIs with ``argv`` and ``--json``; the port's on the CPU."""
    out = {}
    for name, cli, extra in (("jax", jcli, []), ("torch", tcli, ["--device", "cpu"])):
        path = tmp_path / f"{name}.json"
        cli.main(argv + ["--json", str(path)] + extra)
        out[name] = json.loads(path.read_text())
    return out["jax"], out["torch"]


PARITY_CASES = {
    "emergency-audit": ["--audit"],
    "megastep4": ["--megastep-ticks", "4", "--ring-capacity", "4096"],
    "2hosts-crash-mid-commit": ["--hosts", "2", "--scenario", "crash-mid-commit",
                                "--lease-ticks", "4", "--audit"],
    "least-depth-elephant-skew": ["--policy", "least-depth",
                                  "--scenario", "elephant-skew"],
    "slot-cache-prefetch": ["--slot-cache", "4", "--prefetch", "--audit"],
}


@pytest.mark.parametrize("case", list(PARITY_CASES))
def test_json_report_equals_the_reference(tmp_path, reference_draws, case):
    ref, port = run_both(tmp_path, SMALL + PARITY_CASES[case])
    assert set(port) == set(ref)
    assert set(port["snapshot"]) == set(ref["snapshot"])
    want, got = report(ref), report(port)
    for key in want:
        assert got[key] == want[key], key
    assert got["ok"] and got["wrong"] == 0 and got["continuity"]["ok"]
    if case == "2hosts-crash-mid-commit":
        assert any(e.get("commit_mode") == "degraded" for e in got["log"])
    if case == "slot-cache-prefetch":
        assert got["slot_cache"]["misses"] > 0


def test_default_draws_serve_other_weights_and_still_conserve(tmp_path):
    """Without the reference's draws the port serves its own NumPy-drawn
    bank: the counts the weights do not decide stay equal."""
    ref, port = run_both(tmp_path, SMALL + ["--audit"])
    want, got = report(ref), report(port)
    for key in ("phases", "totals", "queues", "ok", "wrong"):
        assert got[key] == want[key], key
    bank = tcli.initial_bank(0, 2, CPU)
    assert not torch.equal(bank["w1p"], _port(_jax_bank(0, 2))["w1p"])


def test_cli_epoch_log_json(tmp_path):
    """The reference's ``tests/test_obs.py`` case on the port."""
    out = tmp_path / "epochs.json"
    tcli.main(["--scenario", "emergency", "--queues", "2", "--slots", "2",
               "--ring-capacity", "2048", "--epoch-log-json", str(out),
               "--device", "cpu"])
    doc = json.loads(out.read_text())
    assert doc["epochs"], "no epochs in log"
    assert doc["continuity"]["ok"]
    for rec in doc["epochs"]:
        assert "span" in rec and "commands" in rec
    assert doc["stats"]["epochs_applied"] >= len(
        [r for r in doc["epochs"] if r["commit_mode"] == "atomic"])


def test_cli_epoch_log_json_equals_the_reference(tmp_path, reference_draws):
    docs = {}
    for name, cli, extra in (("jax", jcli, []), ("torch", tcli, ["--device", "cpu"])):
        out = tmp_path / f"{name}.json"
        cli.main(SMALL + ["--epoch-log-json", str(out)] + extra)
        docs[name] = json.loads(out.read_text())
    assert untimed_doc(docs["torch"]) == untimed_doc(docs["jax"])


def _server_threads() -> list:
    return [t for t in threading.enumerate() if t.name == "obs-server" and t.is_alive()]


def test_observe_serves_while_lingering_then_stops(tmp_path, monkeypatch):
    from repro_torch.obs import server as server_mod

    started = []
    real_start = server_mod.ObsServer.start

    def start(self):
        started.append(self)
        return real_start(self)

    monkeypatch.setattr(server_mod.ObsServer, "start", start)
    before = len(_server_threads())
    log = tmp_path / "epochs.json"
    run = threading.Thread(target=tcli.main, args=(SMALL + [
        "--observe", "0", "--observe-linger", "3", "--epoch-log-json", str(log),
        "--device", "cpu"],))
    run.start()
    deadline = time.monotonic() + 60
    while not log.exists() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert log.exists(), "the run never reached its end"
    port = started[0].port
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=10) as r:
        assert json.loads(r.read()) == {"ok": True, "port": port}
    run.join(timeout=60)
    assert not run.is_alive()
    assert len(_server_threads()) == before
    assert json.loads(log.read_text())["continuity"]["ok"]


@pytest.mark.parametrize("replay", [False, True])
def test_observe_server_stops_when_the_run_raises(tmp_path, monkeypatch, replay):
    """A run that fails after the server started leaves no server thread."""
    before = len(_server_threads())
    argv = SMALL + ["--observe", "0", "--device", "cpu"]
    if replay:
        path = tmp_path / "t.bswt"
        tcli.main(SMALL + ["--trace", "record", str(path), "--device", "cpu"])
        argv = ["--trace", "replay", str(path), "--observe", "0", "--device", "cpu"]

    def boom(*a, **kw):
        assert len(_server_threads()) == before + 1
        raise RuntimeError("injected")

    monkeypatch.setattr(tcli.workloads, "replay" if replay else "play", boom)
    with pytest.raises(RuntimeError, match="injected"):
        tcli.main(argv)
    assert len(_server_threads()) == before


@pytest.mark.parametrize("argv, message", [
    (["--hosts", "0"], "--hosts must be >= 1"),
    (["--trace", "play", "x"], "--trace MODE"),
    (["--prefetch"], "--prefetch needs --slot-cache"),
    (["--slot-cache", "0"], "--slot-cache must be >= 1"),
    (["--deploy-demo", "promote", "--slots", "1"], "--slots >= 2"),
])
def test_argument_checks_equal_the_reference(capsys, argv, message):
    for cli in (jcli, tcli):
        with pytest.raises(SystemExit) as e:
            cli.main(argv + (["--device", "cpu"] if cli is tcli else []))
        assert e.value.code == 2
        assert message in capsys.readouterr().err


def test_failed_audit_exits_1(monkeypatch):
    """A wrong verdict fails the run with status 1, as in the reference."""
    real = tcli._print_run_report

    def wrong(rt, reports, hosts, queues):
        snap = real(rt, reports, hosts, queues)
        snap["conservation"]["wrong_verdict"] = 1
        return snap

    monkeypatch.setattr(tcli, "_print_run_report", wrong)
    with pytest.raises(SystemExit) as e:
        tcli.main(SMALL + ["--device", "cpu"])
    assert e.value.code == 1


def test_shard_map_fanout_equals_vmap_on_two_cpu_devices(tmp_path, monkeypatch):
    """``--fanout shard_map`` over two CPU devices (the gcd rule on one
    card makes one group, the vmap path itself) serves the completion
    streams of ``--fanout vmap``: the recorded traces' digests are equal."""
    from repro_torch.launch import mesh as mesh_lib

    real = mesh_lib.make_queue_mesh
    monkeypatch.setattr(mesh_lib, "make_queue_mesh",
                        lambda q, devices=None: real(q, [CPU, CPU]))
    digests = {}
    for fanout in ("vmap", "shard_map"):
        path = tmp_path / f"{fanout}.bswt"
        tcli.main(["--queues", "4", "--slots", "2", "--fanout", fanout, "--audit",
                   "--trace", "record", str(path), "--device", "cpu"])
        digests[fanout] = tcli.workloads.load(str(path)).expect["digest"]
    assert digests["shard_map"] == digests["vmap"]


# -- the figures' and the runner's pure helpers --------------------------------

def _load(path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(path.stem + "_under_test", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n_models, steps, seed", [(16, 96, 0), (32, 96, 0),
                                                   (48, 96, 0), (5, 40, 3), (1, 10, 1)])
def test_fig15_demand_sequence_equals_the_reference(n_models, steps, seed):
    ref = _load(ROOT / "benchmarks" / "fig15_swap.py")
    port = _load(ROOT / "benchmarks_torch" / "fig15_swap.py")
    assert (port._demand_sequence(n_models, steps, seed)
            == ref._demand_sequence(n_models, steps, seed))


def test_figure_shapes_equal_the_reference():
    for name, keys in (("fig8_dataplane", ("NUM_SLOTS", "BATCH", "BLOCK_B",
                                           "MEGASTEP_TICKS")),
                       ("fig9_control", ("NUM_SLOTS", "NUM_QUEUES", "BATCH")),
                       ("fig11_workloads", ("NUM_SLOTS", "BATCH")),
                       ("fig15_swap", ("NUM_SLOTS", "NUM_QUEUES", "BATCH",
                                       "CACHE_SLOTS", "CACHE_MODELS", "CHURN_STEPS",
                                       "CHURN_BURST"))):
        ref = _load(ROOT / "benchmarks" / f"{name}.py")
        port = _load(ROOT / "benchmarks_torch" / f"{name}.py")
        for key in keys:
            assert getattr(port, key) == getattr(ref, key), (name, key)
    ref11 = _load(ROOT / "benchmarks" / "fig11_workloads.py")
    port11 = _load(ROOT / "benchmarks_torch" / "fig11_workloads.py")
    assert port11.MESH_REGIMES == ref11._MESH_REGIMES


COMPARE_CASES = {
    "equal": ({"a.kpps": 10.0, "b.us": 5.0}, {"a.kpps": 10.0, "b.us": 5.0}),
    "rate drop": ({"a.kpps": 7.0}, {"a.kpps": 10.0}),
    "rate within": ({"a.kpps": 7.6}, {"a.kpps": 10.0}),
    "cost growth": ({"b.us": 6.5}, {"b.us": 5.0}),
    "cost within": ({"b.us": 6.2}, {"b.us": 5.0}),
    "audit from zero": ({"x.audit.y": 1.0}, {"x.audit.y": 0.0}),
    "disjoint": ({"a.kpps": 1.0}, {"c.us": 1.0}),
}


@pytest.mark.parametrize("case", list(COMPARE_CASES))
def test_run_compare_flags_what_the_reference_flags(case):
    ref = _load(ROOT / "benchmarks" / "run.py")
    port = _load(ROOT / "benchmarks_torch" / "run.py")
    results, baseline = COMPARE_CASES[case]
    assert (bool(port.compare_results(results, baseline))
            == bool(ref.compare_results(results, baseline)))
    assert port.REGRESSION_THRESHOLD == ref.REGRESSION_THRESHOLD
    assert port.HIGHER_BETTER == ref._HIGHER_BETTER


def test_run_refuses_a_jax_baseline_and_unknown_figures(tmp_path, capsys):
    port = _load(ROOT / "benchmarks_torch" / "run.py")
    with pytest.raises(SystemExit, match="not written by"):
        port.main(["--device", "cpu", "--only", "fig8_dataplane",
                   "--compare", str(ROOT / "BENCH_2.json")])
    with pytest.raises(SystemExit) as e:
        port.main(["--device", "cpu", "--only", "fig99"])
    assert e.value.code == 2


def test_run_exits_2_on_a_regression(tmp_path, monkeypatch):
    """The suite's flow with a stub figure: --json writes the map, and a
    baseline it beats by more than 25% makes it exit 2."""
    import types

    port = _load(ROOT / "benchmarks_torch" / "run.py")
    stub = types.SimpleNamespace(run=lambda dev, emit: (
        emit("stub.kpps", 10.0), emit("stub.audit.x", 0), emit("stub.name", "n/a")))
    monkeypatch.setattr(port.importlib, "import_module", lambda name: stub)
    out = tmp_path / "now.json"
    assert port.main(["--device", "cpu", "--only", "fig15_swap",
                      "--json", str(out)]) == 0
    now = json.loads(out.read_text())
    assert now == {port.PORT_KEY: 1, "stub.kpps": 10.0, "stub.audit.x": 0}
    assert port.main(["--device", "cpu", "--only", "fig15_swap",
                      "--compare", str(out)]) == 0
    faster = tmp_path / "faster.json"
    faster.write_text(json.dumps({**now, "stub.kpps": 20.0}))
    assert port.main(["--device", "cpu", "--only", "fig15_swap",
                      "--compare", str(faster)]) == 2
