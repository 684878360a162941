"""Port parity, kernel layer: the plain version of the fused forwarding
kernel (both modes, ``meta_words`` 0 and 16) and ``xnor_matmul`` against
the JAX Pallas kernels run in interpret mode, at a small config
(d = 2048 bits, H = 16, block_b = 8).  On CPU tensors the port's kernel
wrappers run their plain versions, so these go through the wrappers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (  # noqa: F401
    assert_equal, assert_scores, banks, packets, to_t, words, one_torch_thread)
from repro.core import bank as jbank
from repro.core import executor as jexecutor
from repro.kernels import bnn_xnor as jxnor
from repro.kernels import fused_forward as jff
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import bank as tbank
from repro_torch.kernels import bnn_xnor as txnor
from repro_torch.kernels import fused_forward as tff
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

SMALL = jexecutor.BNNConfig(d_bits=2048, hidden=16, n_out=1)
W = SMALL.words
BB = 8


def _bank_args(bank):
    return bank["w1p"], bank["b1"], bank["w2"], bank["b2"]


@pytest.mark.parametrize("meta_words", [0, 16])
def test_fused_gather_matches_pallas(meta_words):
    num_slots, b = 4, 48
    rng = np.random.default_rng(10 + meta_words)
    jb, tb = banks(num_slots, SMALL, seed=1)
    x = packets(rng, b, num_slots, W)
    if meta_words == 0:
        x = x[:, 16:]
    slots = rng.integers(0, num_slots, b).astype(np.int32)
    jg = jbank.group_by_slot_padded(jnp.asarray(slots), num_slots, BB)
    g = tbank.group_by_slot_padded(torch.from_numpy(slots), num_slots, BB)
    with_actions = meta_words > 0
    want = jff.fused_forward(jnp.asarray(x), *_bank_args(jb), jg.block_slots,
                             jg.row_ids, block_b=BB, meta_words=meta_words,
                             with_actions=with_actions, interpret=True)
    got = tff.fused_forward(to_t(x), *_bank_args(tb), g.block_slots, g.row_ids,
                            block_b=BB, meta_words=meta_words,
                            with_actions=with_actions)
    if with_actions:
        assert_equal(got[1], want[1])
        got, want = got[0], want[0]
    # padding rows repeat row 0; the real rows are what the pipeline keeps
    rows = g.result_rows.long()
    assert_scores(got[rows], np.asarray(want)[rows.numpy()])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("meta_words", [0, 16])
def test_fused_contiguous_matches_pallas(meta_words):
    num_slots, b = 4, 32
    rng = np.random.default_rng(20 + meta_words)
    jb, tb = banks(num_slots, SMALL, seed=2)
    x = packets(rng, b, num_slots, W)[:, 16 - meta_words:]
    block_slots = rng.integers(0, num_slots, b // BB).astype(np.int32)
    want = jff.fused_forward(jnp.asarray(x), *_bank_args(jb),
                             jnp.asarray(block_slots), None, block_b=BB,
                             meta_words=meta_words, interpret=True)
    got = tff.fused_forward(to_t(x), *_bank_args(tb),
                            torch.from_numpy(block_slots), None, block_b=BB,
                            meta_words=meta_words)
    assert_scores(got, want)


def test_fused_qmajor_matches_pallas_and_flat_call():
    num_slots, q, b = 2, 2, 16
    rng = np.random.default_rng(30)
    jb, tb = banks(num_slots, SMALL, seed=3)
    x = np.stack([packets(rng, b, num_slots, W) for _ in range(q)])
    slots = (x[..., 0].reshape(-1) % num_slots).astype(np.int32)
    jg = jbank.group_by_slot_padded(jnp.asarray(slots), num_slots, BB)
    g = tbank.group_by_slot_padded(torch.from_numpy(slots), num_slots, BB)
    want = jff.fused_forward_qmajor(
        jnp.asarray(x), *_bank_args(jb), jg.block_slots, jg.row_ids,
        block_b=BB, meta_words=16, with_actions=True, interpret=True)
    got = tff.fused_forward_qmajor(
        to_t(x), *_bank_args(tb), g.block_slots, g.row_ids,
        block_b=BB, meta_words=16, with_actions=True)
    rows = g.result_rows.long()
    assert_scores(got[0][rows], np.asarray(want[0])[rows.numpy()])
    assert_equal(got[1], want[1])
    scores, actions = tops.packet_forward_fused(
        tb, to_t(x), g.block_slots, g.row_ids, meta_words=16, block_b=BB)
    assert torch.equal(scores, got[0]) and torch.equal(actions, got[1][:, 0])


@pytest.mark.parametrize("b,h", [(1, 16), (16, 32), (64, 8)])
def test_xnor_matmul_matches_pallas(b, h):
    rng = np.random.default_rng(b + h)
    x, w = words(rng, (b, W)), words(rng, (h, W))
    want = jxnor.xnor_matmul(jnp.asarray(x), jnp.asarray(w), interpret=True)
    for backend in ("cuda", "ref", "mxu", "auto"):
        assert_equal(tops.xnor_matmul(to_t(x), to_t(w), backend=backend), want)
    assert_equal(txnor.xnor_matmul(to_t(x), to_t(w)), want)


def test_bnn_forward_matches_reference():
    rng = np.random.default_rng(40)
    jb, tb = banks(1, SMALL, seed=4)
    x = words(rng, (24, W))
    params_t = tbank.select_slot(tb, 0)
    params_j = {k: v[0] for k, v in jb.items()}
    want = jops.bnn_forward(params_j, jnp.asarray(x), backend="pallas")
    assert_scores(tops.bnn_forward(params_t, to_t(x)), want)
    assert_scores(tref.bnn_forward_ref(*_bank_args(params_t), to_t(x)), want)


def test_banked_matmul_ref_matches_reference():
    rng = np.random.default_rng(50)
    x = rng.standard_normal((12, 16)).astype(np.float32)
    w = rng.standard_normal((3, 16, 8)).astype(np.float32)
    b = rng.standard_normal((3, 8)).astype(np.float32)
    slots = rng.integers(0, 3, 12)
    for bias in (b, None):
        got = tref.banked_matmul_ref(torch.from_numpy(x), torch.from_numpy(w),
                                     None if bias is None else torch.from_numpy(bias),
                                     torch.from_numpy(slots))
        want = jref.banked_matmul_ref(jnp.asarray(x), jnp.asarray(w),
                                      None if bias is None else jnp.asarray(bias),
                                      jnp.asarray(slots))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_fused_rejects_bad_shapes():
    _, tb = banks(2, SMALL)
    x = to_t(words(np.random.default_rng(1), (16, W)))
    args = _bank_args(tb)
    with pytest.raises(ValueError, match="row_ids"):
        tff.fused_forward(x, *args, torch.zeros(2, dtype=torch.int32),
                          torch.zeros(5, dtype=torch.int32), block_b=8)
    with pytest.raises(ValueError, match="with_actions"):
        tff.fused_forward(x, *args, torch.zeros(2, dtype=torch.int32),
                          block_b=8, with_actions=True)
    with pytest.raises(ValueError, match="contiguous"):
        tff.fused_forward(x, *args, torch.zeros(3, dtype=torch.int32), block_b=8)
    with pytest.raises(ValueError, match="payload words"):
        tff.fused_forward(x[:, 1:], *args, torch.zeros(2, dtype=torch.int32),
                          block_b=8)
    with pytest.raises(ValueError, match="bank shape"):
        tff.fused_forward(x, args[0], args[1][:, :3], *args[2:],
                          torch.zeros(2, dtype=torch.int32), block_b=8)
    with pytest.raises(ValueError, match="backend"):
        tops.xnor_matmul(x, x, backend="pallas")
