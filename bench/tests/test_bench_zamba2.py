"""The Zamba2-7B-Instruct cell through the serving runner on the CPU at a
tiny size (the card's look skipped): a sound run comes out correct and its
float8 control does not; a run whose SSM state is lost at the splice, or
whose KV write lands one position late, comes out not correct; and the
whole-step count at the published widths is the model's 22.24 GFLOP a
token."""

import dataclasses

import pytest

from benchkit import hybrid_work, runner

CELL = "zamba2-7b-instruct.chat64-sat"
pytestmark = pytest.mark.usefixtures("one_thread")

# The published shape cut to a tiny size: two B/C groups, two shared blocks
# at three sites with uneven gaps and a trailing layer, four rows, short
# requests.  The limit is the tiny model's own: its bfloat16 runs read
# widest gaps of 0.06 to 0.59 and its float8 control 4.4 to 8.7 (seven
# seeds each; logits of RMS about 8), so 2.0 lies between them.  The faults
# are judged in float32 against a float32 limit of 0.01 (sound float32 runs
# read 0: each served token is the reference's own best): at this size the
# SSM state's share of a logit lies near the bfloat16 limit, since the
# sites' KV carries the context too.
SMALL = {
    "config": {"model": {"n_layers": 8, "d_model": 64, "n_heads": 4, "n_kv_heads": 4,
                         "head_dim": 32, "d_ff": 96, "ssm_state": 16, "ssm_head_dim": 16,
                         "ssm_chunk": 16, "hybrid_layer_ids": [1, 3, 6],
                         "shared_adapter_rank": 8, "vocab_size": 250,
                         "vocab_pad_multiple": 32},
               "engine": {"max_batch": 4, "max_seq": 256, "prefill_buckets": [16, 32, 64]},
               "max_prompt_tokens": 64, "max_new_tokens": 40, "check": {"tol": 2.0}},
    "mix": {"in_flight": 4, "requests": 64,
            "prompt": {"lognormal": {"mean": 30, "sigma": 0.7}},
            "output": {"lognormal": {"mean": 18, "sigma": 0.5}}}}


F32 = {"config": {"model": {"dtype": "float32"}, "check": {"tol": 0.01}}}


def run(over=None, *, seed=2**31 + 43, control=False):
    from conftest import ROOT

    return runner.run_cell(ROOT, CELL, seed, 3.0, False, device="cpu",
                           overrides=runner._merge(SMALL, over), control=control,
                           log=lambda s: None)


@pytest.mark.parametrize("over", [None, F32], ids=["bfloat16", "float32"])
def test_sound_run_is_correct_and_its_control_is_not(over):
    res = run(over, control=True)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 4 and res["failed"] == 0
    assert set(res["metrics"]) == {"serve_tok_s", "setup_s"}
    assert res["metrics"]["serve_tok_s"]["value"] > 0
    assert res["control"]["correct"] is False, res["control"]["checks"]
    assert res["control"]["checks"]["wrong_tokens"]["value"] > 0


def test_ssm_state_lost_at_the_splice(monkeypatch):
    # each admitted row's SSM state zeroed after its prefill's splice
    import torch
    from repro_torch.serve.engine import ServeEngine

    real = ServeEngine._splice_cache

    def lose(self, row, row_cache):
        real(self, row, row_cache)
        with torch.inference_mode():
            self.cache["ssm"][:, row] = 0

    monkeypatch.setattr(ServeEngine, "_splice_cache", lose)
    res = run(F32)
    assert not res["correct"]
    assert res["checks"]["wrong_tokens"]["value"] > 0


def test_kv_written_one_position_late(monkeypatch):
    # the decode's KV lands past the row's length: the attention reads a
    # stale position as valid and misses its own token
    from repro_torch.nn import modules

    real = modules._write_rows
    monkeypatch.setattr(modules, "_write_rows",
                        lambda cache, new, slot: real(cache, new, slot + 1))
    res = run(F32)
    assert not res["correct"]
    assert res["checks"]["wrong_tokens"]["value"] > 0


def test_flops_per_token_at_the_published_widths():
    import sys
    from conftest import ROOT

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.registry import get_config

    m = dataclasses.asdict(get_config("zamba2-7b-instruct"))
    f = hybrid_work.flops_per_token(m)
    assert abs(f - 22.24e9) <= 0.01e9
    # the terms: 81 Mamba layers 12.88 G, 13 sites 9.12 G, the head 0.23 G
    assert hybrid_work.flops_per_token(dict(m, hybrid_layer_ids=[], vocab_size=0)) == \
        pytest.approx(12.885e9, abs=1e6)
    assert hybrid_work.flops_per_token(dict(m, family="ssm")) is None
