"""The port's trainer and launcher (``repro_torch.train.loop``,
``repro_torch.launch.train``, ``examples/train_lm_torch.py``) on the CPU:
preemption (flag file and SIGTERM) and exact resume; a checkpoint of the
reference's trainer resumed by the port's and one of the port's resumed by
the reference's, each held against the uninterrupted run of the package
that wrote it (within 1e-5, as the reference's own resume test); the
launcher's flags against the reference's, its printed lines, its refusal
without a card; the example's falling loss."""

import argparse
import ast
import importlib.util
import os
import signal
import tempfile

import jax
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401
from repro.configs import registry as jreg
from repro.data import tokens as jtok
from repro.launch import train as jlaunch
from repro.train import loop as jloop
from repro.train import optimizer as jopt
from repro_torch.configs import registry as treg
from repro_torch.data import tokens as ttok
from repro_torch.launch import train as tlaunch
from repro_torch.train import loop as tloop
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts

ROOT = os.path.join(os.path.dirname(__file__), "..")
RESUME_ATOL = 1e-5
OVER = dict(n_layers=1, dtype="float32", remat="none")
OPT = dict(warmup_steps=0, total_steps=50, learning_rate=1e-3)
DATA = dict(seq_len=16, global_batch=4)


def _port_trainer(d, steps, **tc):
    cfg = treg.get_config("smollm-360m").reduced(**OVER)
    return tloop.Trainer(
        cfg, topt.OptimizerConfig(**OPT),
        tloop.TrainerConfig(total_steps=steps, checkpoint_every=100,
                            checkpoint_dir=str(d), **tc),
        ttok.SyntheticTokens(ttok.TokenPipelineConfig(vocab_size=cfg.vocab_size, **DATA)),
        device="cpu")


def _ref_trainer(d, steps):
    cfg = jreg.get_config("smollm-360m").reduced(**OVER)
    return jloop.Trainer(
        cfg, jopt.OptimizerConfig(**OPT),
        jloop.TrainerConfig(total_steps=steps, checkpoint_every=100,
                            checkpoint_dir=str(d)),
        jtok.SyntheticTokens(jtok.TokenPipelineConfig(vocab_size=cfg.vocab_size, **DATA)))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.float().numpy()}
    return {prefix: np.asarray(tree, np.float32)}


def _max_diff(a: dict, b: dict) -> float:
    assert sorted(a) == sorted(b)
    return max(float(np.abs(a[k] - b[k]).max()) for k in a)


def _port_params(t):
    return _leaves(tts.state_tree(t.state)["params"])


def _ref_params(t):
    return _leaves(jax.tree_util.tree_map(np.asarray, t.state["params"]))


def test_trainer_preemption_resume_exact(tmp_path):
    """The reference's ``test_trainer_preemption_resume_exact`` on the port,
    the resumed run bit-equal here (one process, one thread)."""
    full = _port_trainer(tmp_path / "full", 8)
    assert full.run() == {"status": "done", "steps_run": 8}
    t1 = _port_trainer(tmp_path / "cut", 4)
    t1.run()
    t2 = _port_trainer(tmp_path / "cut", 8)
    assert t2.try_restore()
    assert int(t2.state["step"]) == 4 and t2.data.cursor == 4
    assert int(t2.state["opt"]["step"]) == 4
    assert t2.run() == {"status": "done", "steps_run": 4}
    assert _max_diff(_port_params(full), _port_params(t2)) < RESUME_ATOL
    assert _max_diff(_leaves(tts.state_tree(full.state)),
                     _leaves(tts.state_tree(t2.state))) == 0.0


def test_flag_file_preempts_and_saves(tmp_path):
    flag = tmp_path / "preempt"
    t = _port_trainer(tmp_path / "ckpt", 8, preempt_flag_file=str(flag))
    t.step_fn = _stop_after(t.step_fn, 3, lambda: flag.write_text("now"))
    assert t.run() == {"status": "preempted", "steps_run": 3}
    t2 = _port_trainer(tmp_path / "ckpt", 8)
    assert t2.try_restore() and int(t2.state["step"]) == 3 and t2.data.cursor == 3


def test_sigterm_preempts_and_saves(tmp_path):
    t = _port_trainer(tmp_path / "ckpt", 8)
    t.step_fn = _stop_after(t.step_fn, 2, lambda: signal.raise_signal(signal.SIGTERM))
    old = signal.getsignal(signal.SIGTERM)
    try:
        out = t.run()
    finally:
        signal.signal(signal.SIGTERM, old)
    assert out == {"status": "preempted", "steps_run": 2}
    t2 = _port_trainer(tmp_path / "ckpt", 8)
    assert t2.try_restore() and int(t2.state["step"]) == 2


def _stop_after(step_fn, n, stop):
    calls = []

    def step(state, batch):
        out = step_fn(state, batch)
        calls.append(1)
        if len(calls) == n:
            stop()
        return out
    return step


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    ref_full = _ref_trainer(tmp_path / "ref_full", 8)
    ref_full.run()
    _ref_trainer(tmp_path / "cut", 4).run()
    port = _port_trainer(tmp_path / "cut", 8)
    assert port.try_restore()
    assert int(port.state["step"]) == 4 and port.data.cursor == 4
    port.run()
    assert _max_diff(_port_params(port), _ref_params(ref_full)) < RESUME_ATOL


def test_port_checkpoint_resumes_in_the_reference(tmp_path):
    port_full = _port_trainer(tmp_path / "port_full", 8)
    port_full.run()
    _port_trainer(tmp_path / "cut", 4).run()
    ref = _ref_trainer(tmp_path / "cut", 8)
    assert ref.try_restore()
    assert int(ref.state["step"]) == 4 and ref.data.cursor == 4
    ref.run()
    assert _max_diff(_ref_params(ref), _port_params(port_full)) < RESUME_ATOL
    # the whole state keeps the reference's tree: opt m, v, master and steps
    assert sorted(_leaves(jax.tree_util.tree_map(np.asarray, ref.state))) == \
        sorted(_leaves(tts.state_tree(port_full.state)))


def test_n_hosts_without_a_group():
    assert not torch.distributed.is_initialized()
    assert tloop.n_hosts() == 1


# ---------------------------------------------------------------------------
# the launcher and the example
# ---------------------------------------------------------------------------

class _Parsed(Exception):
    pass


def _reference_parser() -> argparse.ArgumentParser:
    """The parser the reference's ``main`` builds (it builds it inline)."""
    seen = {}
    real = argparse.ArgumentParser.parse_args

    def grab(self, *a, **kw):
        seen["parser"] = self
        raise _Parsed
    argparse.ArgumentParser.parse_args = grab
    try:
        with pytest.raises(_Parsed):
            jlaunch.main()
    finally:
        argparse.ArgumentParser.parse_args = real
    return seen["parser"]


def _flags(parser) -> dict:
    return {a.dest: (a.option_strings, a.default, a.type, a.choices)
            for a in parser._actions if a.option_strings and a.dest != "help"}


def test_launcher_flags_are_the_reference_s_plus_device():
    want, got = _flags(_reference_parser()), _flags(tlaunch.build_parser())
    assert got.pop("device") == (["--device"], None, None, None)
    # the default checkpoint directory lies under the temporary directory
    # (the reference's names /tmp itself)
    assert got.pop("checkpoint_dir")[1] == os.path.join(tempfile.gettempdir(),
                                                       "repro_train")
    assert os.path.basename(want.pop("checkpoint_dir")[1]) == "repro_train"
    assert got == want


def _launch(main, argv, capsys):
    main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    return ast.literal_eval(lines[0]), [ast.literal_eval(x) for x in lines[1:]]


@pytest.mark.parametrize("extra", [[], ["--compress-gradients", "--microbatches", "2"]])
def test_launcher_prints_the_reference_s_lines(tmp_path, capsys, extra, monkeypatch):
    argv = ["--steps", "3", "--batch", "4", "--seq", "16", *extra]
    monkeypatch.setattr("sys.argv", ["train", *argv, "--checkpoint-dir",
                                     str(tmp_path / "ref")])
    want = _launch(lambda _: jlaunch.main(), None, capsys)
    got = _launch(tlaunch.main, [*argv, "--checkpoint-dir", str(tmp_path / "port"),
                                 "--device", "cpu"], capsys)
    assert got[0] == want[0] == {"status": "done", "steps_run": 3}
    assert [sorted(m) for m in got[1]] == [sorted(m) for m in want[1]]
    assert [m["step"] for m in got[1]] == [m["step"] for m in want[1]] == [1]
    assert all(np.isfinite(v) for m in got[1] for v in m.values())
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "ref"))


def test_launcher_resumes(tmp_path, capsys):
    argv = ["--steps", "4", "--batch", "2", "--seq", "8", "--checkpoint-every", "2",
            "--checkpoint-dir", str(tmp_path), "--device", "cpu"]
    tlaunch.main(argv[:1] + ["2"] + argv[2:])
    capsys.readouterr()
    tlaunch.main(argv + ["--resume"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "resumed at step 2"
    assert ast.literal_eval(out[1]) == {"status": "done", "steps_run": 2}


def test_launcher_asks_for_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tlaunch.main(["--steps", "1"])


def test_example_loss_falls(capsys):
    spec = importlib.util.spec_from_file_location(
        "train_lm_torch", os.path.join(ROOT, "examples", "train_lm_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.main(["--device", "cpu", "--steps", "50"]) == 0
    out = capsys.readouterr().out
    assert "'status': 'done', 'steps_run': 50" in out and "loss: " in out
