"""The port's data-plane CLI with traces and deployment, against the
reference's CLI: a trace recorded by either replays in the other with its
digest, and ``--deploy-demo promote|rollback`` reaches the reference's
decision through the same deploy events.  (Apart from ``test_torch_cli.py``
so the two spread over two test workers.)

A cold ``OnlineTrainer.fine_tune`` draws its latent from a
``torch.Generator`` in the port and from ``jax.random`` in the reference,
so after a rollout the served weights differ: the deploy cases compare the
decision, the deploy log's events, wrong verdicts and continuity, not the
verdict streams after the canary."""

import json

import pytest

from _torch_parity import one_torch_thread  # noqa: F401
from repro.checkpoint import store as jstore
from repro.launch import dataplane as jcli
from repro_torch.checkpoint import store
from repro_torch.launch import dataplane as tcli

SMALL = ["--queues", "2", "--slots", "2", "--scale", "1"]
CLIS = {"jax": (jcli, []), "torch": (tcli, ["--device", "cpu"])}

TRACE_CASES = {
    "emergency": SMALL + ["--audit"],
    "2hosts-chaos": ["--hosts", "2", "--queues", "2", "--slots", "2",
                     "--scenario", "chaos-host-failover", "--audit"],
    "slot-thrash": SMALL + ["--scenario", "slot-thrash"],
}


@pytest.mark.parametrize("case", list(TRACE_CASES))
@pytest.mark.parametrize("recorder, replayer", [("torch", "jax"), ("jax", "torch")])
def test_trace_recorded_by_one_cli_replays_in_the_other(tmp_path, capsys, case,
                                                       recorder, replayer):
    path = str(tmp_path / "run.bswt")
    cli, extra = CLIS[recorder]
    cli.main(TRACE_CASES[case] + ["--trace", "record", path] + extra)
    assert "recorded trace:" in capsys.readouterr().out
    cli, extra = CLIS[replayer]
    out = tmp_path / "replay.json"
    cli.main(["--trace", "replay", path, "--audit", "--json", str(out)] + extra)
    doc = json.loads(out.read_text())
    assert doc["replay"]["ok"] and doc["replay"]["digest_ok"] is True
    assert doc["replay"]["mismatches"] == []
    aud = doc["snapshot"]["conservation"]
    assert aud["ok"] and aud["wrong_verdict"] == 0
    assert "digest_ok=True" in capsys.readouterr().out


def test_trace_replays_in_megastep_mode(tmp_path):
    """A port trace replayed at window 4 keeps its digest."""
    path = str(tmp_path / "run.bswt")
    tcli.main(SMALL + ["--trace", "record", path, "--device", "cpu"])
    out = tmp_path / "replay.json"
    tcli.main(["--trace", "replay", path, "--megastep-ticks", "4", "--audit",
               "--json", str(out), "--device", "cpu"])
    assert json.loads(out.read_text())["replay"]["digest_ok"] is True


def test_cli_deploy_demo_promote(tmp_path):
    """The reference's ``tests/test_deploy.py`` case on the port."""
    out = tmp_path / "epochs.json"
    tcli.main(["--scenario", "emergency", "--queues", "2", "--slots", "2",
               "--ring-capacity", "4096", "--deploy-demo", "promote",
               "--deploy-warmup-ticks", "6", "--deploy-bake-ticks", "6",
               "--deploy-steps", "8",
               "--checkpoint-dir", str(tmp_path / "ckpt"),
               "--epoch-log-json", str(out), "--device", "cpu"])
    doc = json.loads(out.read_text())
    events = [d["event"] for d in doc["deployments"]]
    assert "promoted" in events and "retrain" in events
    assert doc["continuity"]["ok"]
    assert store.list_steps(str(tmp_path / "ckpt"))


DEMO = ["--scenario", "emergency", "--queues", "2", "--slots", "2",
        "--ring-capacity", "4096", "--deploy-warmup-ticks", "6",
        "--deploy-bake-ticks", "6", "--deploy-steps", "8"]


@pytest.mark.parametrize("decision", ["promote", "rollback"])
def test_deploy_demo_decision_equals_the_reference(tmp_path, decision):
    docs = {}
    for name, (cli, extra) in CLIS.items():
        out, ckpt = tmp_path / f"{name}.json", tmp_path / f"ckpt-{name}"
        cli.main(DEMO + ["--deploy-demo", decision, "--checkpoint-dir", str(ckpt),
                         "--json", str(out)] + extra)
        docs[name] = json.loads(out.read_text())
        steps = (store if name == "torch" else jstore).list_steps(str(ckpt))
        assert steps, name
    want = "promoted" if decision == "promote" else "rolled_back"
    events = {name: [(d["event"], d.get("slot")) for d in doc["snapshot"]["deployments"]]
              for name, doc in docs.items()}
    assert events["torch"] == events["jax"]
    terminal = [e for e, _ in events["torch"] if e in ("promoted", "rolled_back")]
    assert terminal == [want]
    for doc in docs.values():
        aud = doc["snapshot"]["conservation"]
        assert aud["ok"] and aud["wrong_verdict"] == 0 and doc["continuity"]["ok"]
    # the traffic and its phases do not depend on the weights
    for key in ("offered", "completed", "dropped"):
        assert ([r[key] for r in docs["torch"]["phases"]]
                == [r[key] for r in docs["jax"]["phases"]])
    kinds = {name: [c["cmd"] for e in doc["control_log"] for c in e["commands"]]
             for name, doc in docs.items()}
    assert kinds["torch"] == kinds["jax"]


def test_deploy_demo_fails_without_its_decision(tmp_path, monkeypatch, capsys):
    """A demo whose decision never comes exits 1, as in the reference."""
    from repro_torch import deploy

    monkeypatch.setattr(deploy.ScheduledRollout, "step", lambda self: None)
    with pytest.raises(SystemExit) as e:
        tcli.main(DEMO + ["--deploy-demo", "promote", "--checkpoint-dir",
                          str(tmp_path / "ckpt"), "--device", "cpu"])
    assert e.value.code == 1
    assert "deploy-demo FAILED" in capsys.readouterr().out
