"""The served model's FLOPs per token and a decode tick's least bytes
against values worked by hand for mamba2-130m (d 768, 24 layers, d_inner
1536, 24 heads of 64, state 128, conv 4, vocabulary 50,280)."""

import pytest

from benchkit import lm_work

M = {"family": "ssm", "d_model": 768, "n_layers": 24, "ssm_expand": 2,
     "ssm_head_dim": 64, "ssm_state": 128, "ssm_conv_width": 4,
     "vocab_size": 50280}


def test_flops_per_token():
    in_proj = 2 * 768 * 3352              # z, x (1536 each), B, C (128 each), dt (24)
    scan = 5 * 24 * 64 * 128
    out_proj = 2 * 1536 * 768
    head = 2 * 768 * 50280
    assert lm_work.flops_per_token(M) == 24 * (in_proj + scan + out_proj) + head
    assert lm_work.flops_per_token(M) == pytest.approx(2.81014272e8)


def test_decode_bytes():
    layer = 2 * (768 + 768 * 3352 + 4 * 1792 + 1792 + 1536 + 1536 * 768) + 4 * 72
    weights = 24 * layer + 2 * 768
    rows, slots = 64, 4
    state = 2 * rows * 24 * 24 * 64 * 128 * 4
    conv = 2 * rows * 24 * 3 * 1792 * 2
    want = (weights + slots * 768 * 50280 * 2 + rows * 768 * 2 + state + conv
            + rows * 50280 * 4)
    assert lm_work.decode_bytes(M, rows, slots) == want
    assert 2.7e9 < want < 3.0e9          # ~0.87 ms at 3.35e12 B/s


def test_other_families_are_not_counted():
    assert lm_work.flops_per_token(dict(M, family="hybrid")) is None
    assert lm_work.decode_bytes(dict(M, family="dense"), 8, 1) is None
