"""The port's banked kernels (plain versions on the CPU) and the kernel-level
double bank against the JAX reference: ``banked_matmul`` and
``banked_xnor_layer1`` against the Pallas kernels run with
``interpret=True``, ``stack_double_bank``/``flip_slots`` and
``double_buffered_forward`` against the reference's, and the wrappers'
argument checks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (  # noqa: F401
    CPU, assert_equal, assert_scores, banks, packets, to_t, words,
    one_torch_thread)
from repro.core import executor as jexecutor
from repro.kernels import banked_matmul as jbm
from repro.kernels import fused_forward as jff
from repro_torch.core import bank as tbank
from repro_torch.core import packet as tpkt
from repro_torch.kernels import banked_matmul as tbm
from repro_torch.kernels import fused_forward as tff
from repro_torch.kernels import ops as tops

SMALL = jexecutor.BNNConfig(d_bits=2048, hidden=16)
TORCH_DTYPE = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _float_inputs(rng, dtype, b, d, hid, k, bb):
    x = rng.normal(size=(b, d)).astype(np.float32)
    w = rng.normal(size=(k, d, hid)).astype(np.float32)
    bias = rng.normal(size=(k, hid)).astype(np.float32)
    block_slots = rng.integers(0, k, b // bb).astype(np.int32)
    jax_in = [jnp.asarray(a, dtype) for a in (x, w, bias)]
    torch_in = [torch.from_numpy(a).to(TORCH_DTYPE[dtype]) for a in (x, w, bias)]
    return jax_in, torch_in, block_slots


def _tol(dtype):
    # the reference test's tolerances: f32 sums in another order, bf16
    # rounds the f32 sum once
    return dict(rtol=2e-2, atol=1e-2) if dtype == jnp.bfloat16 else dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("b,d,hid,k,bb", [
    (8, 16, 8, 3, 4), (16, 32, 16, 2, 8), (32, 64, 8, 5, 8),
])
def test_banked_matmul_matches_pallas(rng, dtype, b, d, hid, k, bb):
    (jx, jw, jb), (tx, tw, tb), block_slots = _float_inputs(rng, dtype, b, d, hid, k, bb)
    want = jbm.banked_matmul(jx, jw, jb, jnp.asarray(block_slots), block_b=bb,
                             interpret=True)
    got = tbm.banked_matmul(tx, tw, tb, torch.from_numpy(block_slots), block_b=bb)
    assert got.dtype == tx.dtype and tuple(got.shape) == (b, hid)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **_tol(dtype))
    assert tbm.banked_matmul.launches == {}  # CPU tensors: the plain version


@pytest.mark.parametrize("backend", ["auto", "ref", "cuda"])
def test_ops_banked_matmul_backends(rng, backend):
    (jx, jw, jb), (tx, tw, tb), block_slots = _float_inputs(
        rng, jnp.float32, 32, 64, 8, 5, 8)
    want = jbm.banked_matmul(jx, jw, jb, jnp.asarray(block_slots), block_b=8,
                             interpret=True)
    got = tops.banked_matmul(tx, tw, tb, torch.from_numpy(block_slots),
                             block_b=8, backend=backend)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,h,w,k,bb,chunk", [
    (16, 8, 32, 2, 8, 16), (32, 32, 256, 16, 16, 64),
])
def test_banked_xnor_layer1_matches_pallas(rng, b, h, w, k, bb, chunk):
    x = words(rng, (b, w))
    bank_w1 = words(rng, (k, h, w))
    bank_b1 = rng.normal(size=(k, h)).astype(np.float32)
    block_slots = rng.integers(0, k, b // bb).astype(np.int32)
    want = jbm.banked_xnor_layer1(x, bank_w1, jnp.asarray(bank_b1),
                                  jnp.asarray(block_slots), block_b=bb,
                                  chunk=chunk, interpret=True)
    got = tbm.banked_xnor_layer1(to_t(x), to_t(bank_w1), torch.from_numpy(bank_b1),
                                 torch.from_numpy(block_slots), block_b=bb, chunk=chunk)
    # one int-to-float conversion and one rounded add in both: bit-equal
    assert_equal(got, want)


def test_banked_wrappers_check_arguments(rng):
    x, w, b = torch.zeros(16, 8), torch.zeros(2, 8, 4), torch.zeros(2, 4)
    slots = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="bank shape"):
        tbm.banked_matmul(x, w, torch.zeros(3, 4), slots, block_b=4)
    with pytest.raises(ValueError, match="divide"):
        tbm.banked_matmul(x, w, b, slots, block_b=5)
    with pytest.raises(ValueError, match="block_slots"):
        tbm.banked_matmul(x, w, b, slots[:3], block_b=4)
    xp, w1 = to_t(words(rng, (16, 8))), to_t(words(rng, (2, 4, 8)))
    with pytest.raises(ValueError, match="bank shape"):
        tbm.banked_xnor_layer1(xp, w1, torch.zeros(2, 5), slots, block_b=4)
    with pytest.raises(ValueError, match="blocking"):
        tbm.banked_xnor_layer1(xp, w1, torch.zeros(2, 4), slots, block_b=4, chunk=3)
    with pytest.raises(ValueError, match="block_slots"):
        tbm.banked_xnor_layer1(xp, w1, torch.zeros(2, 4), slots[:2], block_b=4)


# ---------------------------------------------------------------------------
# kernel-level (2K, ...) double bank
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("active_kind", ["int", "tensor"])
def test_stack_double_bank_flip_selects_halves(active_kind):
    rng = np.random.default_rng(3)
    k, d, h, bsz, bb = 3, 16, 8, 64, 16
    wf, wb = (rng.normal(size=(k, d, h)).astype(np.float32) for _ in range(2))
    bf, bb_ = (rng.normal(size=(k, h)).astype(np.float32) for _ in range(2))
    x = rng.normal(size=(bsz, d)).astype(np.float32)
    slots = np.asarray([0, 2, 1, 0], np.int32)
    jw, jb = jbm.stack_double_bank(wf, wb), jbm.stack_double_bank(bf, bb_)
    tw = tbm.stack_double_bank(torch.from_numpy(wf), torch.from_numpy(wb))
    tb = tbm.stack_double_bank(torch.from_numpy(bf), torch.from_numpy(bb_))
    assert_equal(tw, jw)
    assert_equal(tb, jb)
    for active, (w, b) in enumerate(((wf, bf), (wb, bb_))):
        act = active if active_kind == "int" else torch.tensor(active, dtype=torch.int32)
        flipped = tbm.flip_slots(torch.from_numpy(slots), act, k)
        assert flipped.dtype == torch.int32
        assert_equal(flipped, jbm.flip_slots(slots, active, k))
        want = jbm.banked_matmul(x, jw, jb, jbm.flip_slots(slots, active, k),
                                 block_b=bb, interpret=True)
        got = tbm.banked_matmul(torch.from_numpy(x), tw, tb, flipped, block_b=bb)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
        single = tbm.banked_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                   torch.from_numpy(b), torch.from_numpy(slots),
                                   block_b=bb)
        assert torch.equal(got, single)


def test_stack_double_bank_of_dicts():
    _, front = banks(2, SMALL, seed=1)
    _, back = banks(2, SMALL, seed=2)
    both = tbm.stack_double_bank(front, back)
    assert set(both) == set(front)
    for name in front:
        assert torch.equal(both[name][:2], front[name])
        assert torch.equal(both[name][2:], back[name])
    with pytest.raises(ValueError):
        tbm.stack_double_bank(front, {"w1p": back["w1p"]})


@pytest.mark.parametrize("active", [0, 1])
def test_double_buffered_forward_contiguous(active):
    jfront, tfront = banks(4, SMALL, seed=0)
    jback, tback = banks(4, SMALL, seed=9)
    rng = np.random.default_rng(5)
    x = words(rng, (64, SMALL.words))
    slots = np.asarray([1, 3], np.int32)
    want = jff.double_buffered_forward(x, jfront, jback, active, slots,
                                       block_b=32, interpret=True)
    got = tff.double_buffered_forward(
        to_t(x), tfront, tback, torch.tensor(active), torch.from_numpy(slots),
        block_b=32)
    assert_scores(got, want)
    src = (tfront, tback)[active]
    single = tff.fused_forward(to_t(x), src["w1p"], src["b1"], src["w2"],
                               src["b2"], torch.from_numpy(slots), block_b=32)
    assert torch.equal(got, single)


@pytest.mark.parametrize("active", [0, 1])
def test_double_buffered_forward_gather_actions(active):
    """Gather mode over raw packets with metadata and actions: the path a
    double-banked fused step takes."""
    k, bb = 4, 16
    jfront, tfront = banks(k, SMALL, seed=3)
    jback, tback = banks(k, SMALL, seed=4)
    rng = np.random.default_rng(11)
    p = packets(rng, 40, k, SMALL.words)
    g = tbank.group_by_slot_padded(
        tpkt.slot_of(to_t(p), k).to(torch.int64), k, bb)
    want_s, want_a = jff.double_buffered_forward(
        p, jfront, jback, active, np.asarray(g.block_slots), np.asarray(g.row_ids),
        block_b=bb, meta_words=tpkt.META_WORDS, with_actions=True, interpret=True)
    got_s, got_a = tff.double_buffered_forward(
        to_t(p), tfront, tback, active, g.block_slots, g.row_ids, block_b=bb,
        meta_words=tpkt.META_WORDS, with_actions=True)
    assert_equal(got_a, want_a)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-5, rtol=1e-6)
