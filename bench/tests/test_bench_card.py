"""On the card (``-m cuda``; skips without one): a cell at its own size is
correct, and its control, the reference in TF32 put in the program's place,
is not."""

import pytest

from benchkit import runner


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["h32-k16-q4.steady-sat", "h32-k2-q1.boundary-sat",
                                  "h32-k16-q4.emergency-paced",
                                  "h32-k2-q1.trickle-paced"])
def test_cell_correct_and_control_not(card, bench_root, cell):
    res = runner.run_cell(bench_root, cell, 2**31 + 17, 3.0, False, control=True,
                          log=lambda s: None)
    assert res["correct"], res["checks"]
    assert res["control"]["correct"] is False, res["control"]["checks"]
    assert res["control"]["checks"]["wrong_answers"]["value"] > 0
