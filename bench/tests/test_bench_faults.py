"""The whole run on the CPU at a tiny size, the card's look skipped: sound
runs come out correct, and a run whose timed path is broken underneath comes
out not correct, for each fault the cells can have."""

import json

import pytest

from benchkit import runner
from conftest import BENCH, SMALL

CELLS = sorted(SMALL)
# cells served tick by tick (``packet_step``); the megastep cells serve a
# window of ticks in one launch (``megastep._run_window``)
TICK_CELLS = [c for c in CELLS if json.loads(
    (BENCH / "configs" / f"{c.split('.')[0]}.json").read_text())["runtime"]
    ["megastep_ticks"] == 1]
WINDOW_CELLS = [c for c in CELLS if c not in TICK_CELLS]


def run(root, cell, seed=2**31 + 99, seconds=0.6):
    return runner.run_cell(root, cell, seed, seconds, False, device="cpu",
                           overrides=SMALL[cell], log=lambda s: None)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, bench_root):
    res = run(bench_root, cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell", TICK_CELLS)
def test_an_answer_altered_where_it_is_produced(cell, bench_root, monkeypatch):
    from repro_torch.core import pipeline

    real = pipeline.packet_step

    def altered(*a, **k):
        res = real(*a, **k)
        res.actions[0] = (res.actions[0] + 1) % 3
        return res

    monkeypatch.setattr(pipeline, "packet_step", altered)
    res = run(bench_root, cell)
    assert not res["correct"]
    assert res["checks"]["wrong_answers"]["value"] > 0


@pytest.mark.parametrize("cell", WINDOW_CELLS)
def test_an_answer_altered_where_a_window_produces_it(cell, bench_root, monkeypatch):
    from repro_torch.dataplane import megastep

    real = megastep._run_window

    def altered(*a, **k):
        rings, out = real(*a, **k)
        n = a[2]["bt"].shape[0] * k["width"]          # the actions slab, last
        out[-n:] = (out[-n:] + 1) % 3
        return rings, out

    monkeypatch.setattr(megastep, "_run_window", altered)
    res = run(bench_root, cell)
    assert not res["correct"]
    assert res["checks"]["wrong_answers"]["value"] > 0


def test_a_swap_that_never_takes_effect(bench_root, monkeypatch):
    from repro_torch.dataplane.runtime import DataplaneRuntime

    monkeypatch.setattr(DataplaneRuntime, "_finish_epoch", lambda self, rec: None)
    res = run(bench_root, "h32-k16-q4.emergency-paced", seconds=1.0)
    assert not res["correct"]
    assert res["checks"]["wrong_answers"]["value"] > 0


def test_packets_lost_inside_a_tick(bench_root, monkeypatch):
    from repro_torch.dataplane.runtime import DataplaneRuntime

    real = DataplaneRuntime._retire

    def lose_half(self, rec):
        hook = self.on_retire
        self.on_retire = (None if hook is None else
                          lambda q, rows, *r: hook(q, rows[: len(rows) // 2],
                                                   *(x[: len(rows) // 2] for x in r[:3]),
                                                   *r[3:]))
        try:
            real(self, rec)
        finally:
            self.on_retire = hook

    monkeypatch.setattr(DataplaneRuntime, "_retire", lose_half)
    res = run(bench_root, "h32-k16-q4.steady-sat")
    assert not res["correct"]
    assert res["checks"]["conservation_errors"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_goes_through_the_same_comparison(cell, bench_root, monkeypatch):
    # a control whose every verdict is flipped has to come out not correct,
    # with the program's own run beside it still correct
    from benchkit import spec

    real = spec._module

    def module(path, name):
        mod = real(path, name)
        if name.startswith("bench_reference_"):
            scores = mod.scores

            def flipped(rows, slot_w, *, control=False):
                y, margin = scores(rows, slot_w, control=control)
                return (-y if control else y), margin

            mod.scores = flipped
        return mod

    monkeypatch.setattr(spec, "_module", module)
    res = runner.run_cell(bench_root, cell, 2**31 + 3, 0.6, False, device="cpu",
                          overrides=SMALL[cell], control=True, log=lambda s: None)
    assert res["correct"], res["checks"]
    assert res["control"]["correct"] is False
    assert res["control"]["checks"]["wrong_answers"]["value"] > 0
    assert list(res)[-1] == "checks"
