"""The serving runner on the CPU at a tiny size, the card's look skipped:
sound runs come out correct and their float8 control does not, and a run
whose timed path is broken underneath comes out not correct, for each
fault a serving cell can have."""

import pytest

from benchkit import runner
from benchkit.runner import _merge
from conftest import ROOT, SERVE_SMALL

CELL = "mamba2-130m-h4.chat-sat"
pytestmark = pytest.mark.usefixtures("one_thread")


def run(over=None, *, seed=2**31 + 41, seconds=3.0, control=False):
    return runner.run_cell(ROOT, CELL, seed, seconds, False, device="cpu",
                           overrides=_merge(SERVE_SMALL[CELL], over),
                           control=control, log=lambda s: None)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_sound_run_is_correct_and_its_control_is_not(dtype):
    res = run({"config": {"model": {"dtype": dtype}}}, control=True)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 4 and res["failed"] == 0
    assert set(res["metrics"]) == {"serve_tok_s", "setup_s"}
    assert res["metrics"]["serve_tok_s"]["value"] > 0
    assert list(res)[-1] == "checks"
    assert list(res["checks"]) == ["wrong_tokens", "logit_gap_max", "unfinished_requests"]
    assert res["control"]["correct"] is False, res["control"]["checks"]
    assert res["control"]["checks"]["wrong_tokens"]["value"] > 0


def test_a_step_that_leaves_the_state_unchanged(monkeypatch):
    from repro_torch.nn import ssd

    real = ssd.ssd_decode_step
    monkeypatch.setattr(ssd, "ssd_decode_step",
                        lambda state, *a: (state, real(state, *a)[1]))
    res = run()
    assert not res["correct"]
    assert res["checks"]["wrong_tokens"]["value"] > 0


def test_half_the_batch_left_out(monkeypatch):
    # the second half of the rows is not computed: it gets the first half's
    from repro_torch.models import api

    real = api.decode_step

    def half(params, tokens, cache, lengths, cfg, slot_ids=None):
        logits, cache = real(params, tokens, cache, lengths, cfg, slot_ids)
        b = logits.shape[0] // 2
        logits[b:] = logits[:b]
        return logits, cache

    monkeypatch.setattr(api, "decode_step", half)
    res = run()
    assert not res["correct"]
    assert res["checks"]["wrong_tokens"]["value"] > 0


def test_a_token_altered_where_it_is_produced(monkeypatch):
    from repro_torch.serve.engine import ServeEngine

    real = ServeEngine._decode

    def altered(self):
        nxt = real(self)
        nxt[0] = (nxt[0] + 1) % self.cfg.vocab_size
        return nxt

    monkeypatch.setattr(ServeEngine, "_decode", altered)
    res = run()
    assert not res["correct"]
    assert res["checks"]["wrong_tokens"]["value"] > 0


def test_a_request_that_never_finishes(monkeypatch):
    from repro_torch.serve.engine import ServeEngine

    real = ServeEngine._retire

    def lose_first(self):
        n = len(self.finished)
        real(self)
        self.finished[n:] = [f for f in self.finished[n:] if f.rid != 0]

    monkeypatch.setattr(ServeEngine, "_retire", lose_first)
    res = run()
    assert not res["correct"]
    assert res["checks"]["unfinished_requests"]["value"] == 1
    assert res["failed"] >= 1


def test_step_tokens():
    from benchkit.spec import _module
    from conftest import BENCH

    serve = _module(BENCH / "runners" / "serve.py", "bench_runner_serve_steps")
    # rid 0: admitted at 2, 5 tokens: two at 2, one at 3, 4, 5; rid 1 took a
    # step more than its tokens allow: all of them count where it finished
    out = serve.step_tokens(7, {0: 2, 1: 0}, {0: 5, 1: 6}, {0: 5, 1: 6})
    assert out.tolist() == [0, 0, 2, 1, 1, 1, 6]
