"""On the card (``-m cuda``; skips without one): a cell at its own size is
correct, and its control, the reference in the precision next below the
configuration's put in the program's place (TF32 for the data plane's
float32, float8 e4m3 for a served model's bfloat16), is not."""

import pytest

from benchkit import runner


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["h32-k16-q4.steady-sat", "h32-k2-q1.boundary-sat",
                                  "h32-k16-q4.emergency-paced",
                                  "h32-k2-q1.trickle-paced",
                                  "h32-k16-q4-mega8.steady-sat",
                                  "mamba2-130m-h4.chat-sat"])
def test_cell_correct_and_control_not(card, bench_root, cell):
    res = runner.run_cell(bench_root, cell, 2**31 + 17, 3.0, False, control=True,
                          log=lambda s: None)
    assert res["correct"], res["checks"]
    assert res["control"]["correct"] is False, res["control"]["checks"]
    wrong = "wrong_tokens" if "wrong_tokens" in res["checks"] else "wrong_answers"
    assert res["control"]["checks"][wrong]["value"] > 0
