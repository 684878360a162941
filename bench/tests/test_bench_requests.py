"""The request generator: deterministic in the seed, the same lengths in
every block of ``in_flight`` requests whatever the seed, ids and slots in
range, and the configuration's cut kept."""

import json

import numpy as np
import pytest

from conftest import BENCH
from benchkit.spec import _module

gen = _module(BENCH / "traffic" / "requests.py", "bench_traffic_requests_test")
MIX = json.loads((BENCH / "traffic" / "chat-sat.json").read_text())
CFG = json.loads((BENCH / "configs" / "mamba2-130m-h4.json").read_text())


def build(seed):
    return gen.build(MIX, num_slots=4, vocab_size=50277, seed=seed, seconds=20.0,
                     max_prompt=CFG["max_prompt_tokens"], max_new=CFG["max_new_tokens"])


def test_deterministic_in_seed_and_same_work_for_every_seed():
    a, b, c = build(2**31 + 1), build(2**31 + 1), build(2**31 + 2)
    assert all(np.array_equal(x, y) for x, y in zip(a.prompts, b.prompts))
    assert np.array_equal(a.max_new, b.max_new) and np.array_equal(a.slots, b.slots)
    assert not np.array_equal(a.max_new, c.max_new)
    k = MIX["in_flight"]
    for r in (a, c):
        p = np.asarray([len(x) for x in r.prompts])
        for lo in range(0, len(r), k):
            assert sorted(p[lo:lo + k]) == sorted(p[:k])
            assert sorted(r.max_new[lo:lo + k]) == sorted(a.max_new[:k])


@pytest.mark.parametrize("seed", [0, 2**31 + 5])
def test_ranges(seed):
    r = build(seed)
    p = np.asarray([len(x) for x in r.prompts])
    assert len(r) == MIX["requests"] and r.in_flight == 256
    assert p.min() >= 1 and p.max() == 512 and 90 <= np.median(p) <= 105
    assert r.max_new.min() >= 32 and r.max_new.max() == 1024
    assert 255 <= np.median(r.max_new) <= 275
    toks = np.concatenate(r.prompts)
    assert toks.min() >= 0 and toks.max() < 50277
    assert set(r.slots.tolist()) == {0, 1, 2, 3}


def test_the_published_means_before_the_cut():
    # uncut, the midpoint quantiles' mean approaches the log-normal's mean
    for side, want in (("prompt", 161.31), ("output", 337.99)):
        n = gen.quantile_lengths(MIX[side], 4096, 10**6)
        assert abs(n.mean() / want - 1) < 0.02
