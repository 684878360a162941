"""Port parity, bank layer: slot grouping (every field of
``group_by_slot_padded``), the staged scatter/gather, the host scheduler
grouping and the bank helpers against ``repro.core.bank``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (  # noqa: F401
    CPU, assert_equal, banks, numpy_bank, one_torch_thread)
from repro.core import bank as jbank
from repro.core import executor as jexecutor
from repro_torch.core import bank as tbank

SMALL = jexecutor.BNNConfig(d_bits=2048, hidden=16, n_out=1)


@pytest.mark.parametrize("num_slots", [1, 4, 16])
@pytest.mark.parametrize("b", [5, 48, 61])
def test_group_by_slot_padded_matches_reference(num_slots, b):
    """All fields equal, for ragged B and for B below block_b."""
    bb = 8
    rng = np.random.default_rng(num_slots * 100 + b)
    slots = rng.integers(0, num_slots, b).astype(np.int32)
    g = tbank.group_by_slot_padded(torch.from_numpy(slots), num_slots, bb)
    want = jbank.group_by_slot_padded(jnp.asarray(slots), num_slots, bb)
    assert g.b_pad == want.b_pad
    for field in ("order", "dest", "block_slots", "row_ids", "result_rows"):
        assert_equal(getattr(g, field), getattr(want, field))
    assert g.row_ids.dtype == g.block_slots.dtype == torch.int32


def test_group_by_slot_matches_reference():
    rng = np.random.default_rng(4)
    slots = rng.integers(0, 3, 32).astype(np.int32)
    g = tbank.group_by_slot(torch.from_numpy(slots), 8)
    want = jbank.group_by_slot(jnp.asarray(slots), 8)
    for field in ("order", "inverse", "block_slots", "valid"):
        assert_equal(getattr(g, field), getattr(want, field))
    with pytest.raises(ValueError):
        tbank.group_by_slot(torch.from_numpy(slots[:30]), 8)


def test_scatter_gather_padded_match_reference():
    rng = np.random.default_rng(5)
    b, k, bb = 21, 4, 8
    slots = rng.integers(0, k, b).astype(np.int32)
    x = rng.standard_normal((b, 3)).astype(np.float32)
    g = tbank.group_by_slot_padded(torch.from_numpy(slots), k, bb)
    jg = jbank.group_by_slot_padded(jnp.asarray(slots), k, bb)
    x_pad = tbank.scatter_padded(torch.from_numpy(x), g)
    assert_equal(x_pad, jbank.scatter_padded(jnp.asarray(x), jg))
    assert_equal(tbank.gather_padded(x_pad, g), x)


def test_pad_group_by_slot_matches_reference():
    slots = np.array([2, 0, 2, 2, 1, 0, 2])
    for got, want in zip(tbank.pad_group_by_slot(slots, 4),
                         jbank.pad_group_by_slot(slots, 4)):
        np.testing.assert_array_equal(got, want)


def test_from_jax_bank_and_bank_helpers():
    jb, tb = banks(3, SMALL, seed=2)
    assert tb["w1p"].dtype == torch.int32 and tb["b1"].dtype == torch.float32
    np.testing.assert_array_equal(numpy_bank(tb)["w1p"], np.asarray(jb["w1p"]))
    assert tbank.bank_size(tb) == jbank.bank_size(jb) == 3
    assert tbank.bank_bytes(tb) == jbank.bank_bytes(jb)
    one = tbank.select_slot(tb, 1)
    for name, leaf in jbank.select_slot(jb, 1).items():
        np.testing.assert_array_equal(numpy_bank(one)[name], np.asarray(leaf))
    restacked = tbank.stack_bank([tbank.select_slot(tb, i) for i in range(3)])
    for name in tb:
        assert torch.equal(restacked[name], tb[name])
    new = tbank.update_slot(tb, 0, tbank.select_slot(tb, 2))
    want = jbank.update_slot(jb, 0, jbank.select_slot(jb, 2))
    for name, leaf in numpy_bank(new).items():
        np.testing.assert_array_equal(leaf, np.asarray(want[name]))
    assert not torch.equal(tb["w1p"][0], new["w1p"][0])  # input left unchanged
    with pytest.raises(ValueError):
        tbank.stack_bank([])
    assert tbank.from_jax_bank({"w1p": np.asarray(jb["w1p"])}, CPU)["w1p"].device == CPU
