"""The port's ``DoubleBufferedBank`` (zero-copy SwapSlot commit) against the
reference's semantics: stage/commit, dirty-slot resync, the one-staged-epoch
policy, mark/restore, pin copy-on-write, and the runtime's flip against its
re-stage path; plus ``apply_banked`` against the reference's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (  # noqa: F401
    CPU, banks, numpy_bank, one_torch_thread)
from repro.core import bank as jbank
from repro.core import executor as jexecutor
from repro_torch.control import SwapSlot
from repro_torch.core import bank as tbank
from repro_torch.dataplane import DataplaneRuntime

SMALL = jexecutor.BNNConfig(d_bits=2048, hidden=16)


@pytest.fixture(scope="module")
def bank4():
    """(reference bank, port bank) with the same contents."""
    return banks(4, SMALL, seed=0)


@pytest.fixture(scope="module")
def params_pool():
    """Replacement slots as the reference's numpy arrays (``w1p`` uint32)."""
    return [{k: np.asarray(v) for k, v in jexecutor.init_params(
        jax.random.PRNGKey(100 + i), SMALL).items()} for i in range(6)]


def _as_port(params):
    return tbank.from_jax_bank(params, CPU)


def assert_bank(got: dict, want) -> None:
    """A port bank equals a reference bank (or numpy dict) bit for bit."""
    got = numpy_bank(got)
    want = numpy_bank(want) if isinstance(next(iter(want.values())), torch.Tensor) \
        else {k: np.asarray(v) for k, v in want.items()}
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_stage_commit_matches_update_slot(bank4, params_pool):
    jb, tb = bank4
    dbb = tbank.DoubleBufferedBank(tb)
    assert dbb.stage(2, _as_port(params_pool[0]), token="t", epoch=1)
    assert dbb.has_staged and dbb.is_staged("t")
    new = dbb.commit()
    assert not dbb.has_staged and dbb.committed("t") and dbb.flips == 1
    assert_bank(new, jbank.update_slot(jb, 2, params_pool[0]))
    assert_bank(new, tbank.update_slot(tb, 2, params_pool[0]))
    assert_bank(tb, jb)  # the caller's bank is never written


@pytest.mark.parametrize("as_numpy", [False, True])
def test_sequential_swaps_resync_dirty_slots(bank4, params_pool, as_numpy):
    """The second flip's demoted buffer is dirty at the first swap's slot;
    stage() resyncs it so only the staged slot differs.  Params may arrive
    as numpy (uint32 words) or as tensors."""
    jb, tb = bank4
    pa, pb = params_pool[0], params_pool[1]
    if not as_numpy:
        pa, pb = _as_port(pa), _as_port(pb)
    dbb = tbank.DoubleBufferedBank(tb)
    dbb.stage(1, pa, token="a", epoch=1)
    dbb.commit()
    dbb.stage(3, pb, token="b", epoch=2)
    new = dbb.commit()
    assert dbb.syncs == 1
    want = jbank.update_slot(jbank.update_slot(jb, 1, params_pool[0]), 3,
                             params_pool[1])
    assert_bank(new, want)


def test_one_staged_epoch_policy(bank4, params_pool):
    jb, tb = bank4
    dbb = tbank.DoubleBufferedBank(tb)
    assert dbb.stage(0, _as_port(params_pool[0]), token="a", epoch=1)
    # a different epoch scope is refused without force
    assert not dbb.stage(1, _as_port(params_pool[1]), token="b", epoch=2)
    # apply-time wins: force discards the earlier staged entry
    assert dbb.stage(1, _as_port(params_pool[1]), token="b", epoch=2, force=True)
    new = dbb.commit()
    assert_bank(new, jbank.update_slot(jb, 1, params_pool[1]))
    assert dbb.committed("b") and not dbb.committed("a")
    assert dbb.discards == 1


def test_prefetch_promotion_adopts_staged_entry(bank4, params_pool):
    _, tb = bank4
    dbb = tbank.DoubleBufferedBank(tb)
    p = _as_port(params_pool[2])
    assert dbb.stage(3, p, token="prefetch", epoch="prefetch")
    assert dbb.stage(3, p, token="cmd", epoch=7)     # same object: rebind
    assert dbb.stages == 1 and dbb.is_staged("cmd")
    assert not dbb.is_staged("prefetch")


def test_mark_restore_rolls_back_a_flip(bank4, params_pool):
    jb, tb = bank4
    dbb = tbank.DoubleBufferedBank(tb)
    m = dbb.mark()
    dbb.stage(2, _as_port(params_pool[0]), token="x", epoch=1)
    dbb.commit()
    dbb.restore(m)
    dbb.discard_staged()
    assert_bank(dbb.active, jb)
    # the buffer dirtied by the rollback is resynced on the next stage
    dbb.stage(0, _as_port(params_pool[1]), token="y", epoch=2)
    assert_bank(dbb.commit(), jbank.update_slot(jb, 0, params_pool[1]))


def test_pin_forces_copy_on_write(bank4, params_pool):
    """A pinned buffer that becomes the staging shadow after a flip is
    un-aliased, not written: its holder may still read it."""
    jb, tb = bank4
    dbb = tbank.DoubleBufferedBank(tb)
    handle = dbb.pin_active()
    snapshot = numpy_bank(handle.tree)
    dbb.stage(1, _as_port(params_pool[0]), token="a", epoch=1)
    dbb.commit()                       # pinned buffer is now the shadow
    dbb.stage(2, _as_port(params_pool[1]), token="b", epoch=2)
    dbb.commit()
    assert_bank(handle.tree, snapshot)
    assert dbb.unalias_copies >= 1
    dbb.unpin(handle)


def test_reseed_marks_shadow_dirty(bank4, params_pool):
    jb, tb = bank4
    dbb = tbank.DoubleBufferedBank(tb)
    other = tbank.update_slot(tb, 0, params_pool[3])
    dbb.reseed(other)
    dbb.stage(1, _as_port(params_pool[4]), token="r", epoch=1)
    assert dbb.syncs == 3              # every slot but the staged one
    want = jbank.update_slot(jbank.update_slot(jb, 0, params_pool[3]), 1,
                             params_pool[4])
    assert_bank(dbb.commit(), want)


def test_stage_rejects_mismatched_params(bank4, params_pool):
    _, tb = bank4
    dbb = tbank.DoubleBufferedBank(tb)
    bad = dict(_as_port(params_pool[0]), b1=torch.zeros(3))
    with pytest.raises(ValueError, match="b1"):
        dbb.stage(0, bad, token="z", epoch=1)
    with pytest.raises(ValueError, match="structure"):
        dbb.stage(0, {"w1p": bad["w1p"]}, token="z", epoch=1)
    assert not dbb.has_staged and dbb.stages == 0


@pytest.mark.parametrize("as_numpy", [False, True])
def test_runtime_flip_equals_restage(bank4, params_pool, as_numpy):
    jb, tb = bank4
    params = params_pool[0] if as_numpy else _as_port(params_pool[0])
    got = {}
    for db in (True, False):
        rt = DataplaneRuntime(tb, num_queues=2, strategy="take", batch=32,
                              double_buffer=db, device="cpu")
        rt.control.submit(SwapSlot(1, params))
        rt.flush_control()
        got[db] = rt.bank
        assert rt.telemetry.slot_swaps == 1
    assert_bank(got[True], got[False])
    assert_bank(got[True], jbank.update_slot(jb, 1, params_pool[0]))
    assert_bank(tb, jb)


# ---------------------------------------------------------------------------
# generic banked apply
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy", ["take", "onehot"])
def test_apply_banked_matches_reference(rng, strategy):
    k, d, h, b = 3, 8, 5, 12
    w = rng.normal(size=(k, h, d)).astype(np.float32)
    bias = rng.normal(size=(k, h)).astype(np.float32)
    x = rng.normal(size=(b, d)).astype(np.float32)
    slots = rng.integers(0, k, b)
    want = jbank.apply_banked(
        {"w": jnp.asarray(w), "b": jnp.asarray(bias)},
        lambda p, xi: p["w"] @ xi + p["b"], jnp.asarray(x), jnp.asarray(slots),
        strategy=strategy)
    got = tbank.apply_banked(
        {"w": torch.from_numpy(w), "b": torch.from_numpy(bias)},
        lambda p, xi: p["w"] @ xi + p["b"], torch.from_numpy(x),
        torch.from_numpy(slots), strategy=strategy)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        tbank.apply_banked({"w": torch.from_numpy(w)}, lambda p, xi: xi,
                           torch.from_numpy(x), torch.from_numpy(slots),
                           strategy="grouped")
