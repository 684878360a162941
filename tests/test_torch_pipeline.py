"""Port parity, the slice as a whole: ``packet_step`` for every strategy
and for ``fixed_slot`` against ``repro.core.pipeline.packet_step`` at the
paper's full H32 width (d = 8192, H = 32) with B = 48, a JAX bank carried
across with ``from_jax_bank``.  Slots, verdicts and actions must be equal;
scores agree within the stated tolerance."""

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import (  # noqa: F401
    assert_equal, assert_scores, banks, numpy_bank, packets, to_t, words,
    one_torch_thread)
from repro.core import executor as jexecutor
from repro.core import pipeline as jpipe
from repro_torch.core import bank as tbank
from repro_torch.core import executor as texecutor
from repro_torch.core import pipeline as tpipe

K, B, BB = 4, 48, 8

# The reference's backend for each strategy: the Pallas kernels (interpret
# mode on the CPU) wherever a strategy reaches one.
JAX_BACKEND = {"take": "auto", "onehot": "auto", "grouped": "pallas",
               "grouped_staged": "pallas", "fused": "pallas"}


@pytest.fixture(scope="module")
def setup():
    jb, tb = banks(K, seed=5)
    p = packets(np.random.default_rng(5), B, K)
    p[3, 0] = 0xFFFFFFFF  # wraps to -1: slot 0
    p[7, 0] = 100         # clamps to K-1
    return jb, tb, p


def _check(res, want):
    assert_equal(res.slots, want.slots)
    assert_equal(res.verdicts, want.verdicts)
    assert_equal(res.actions, want.actions)
    assert_scores(res.scores, want.scores)


@pytest.mark.parametrize("backend", ["cuda", "auto"])
@pytest.mark.parametrize("strategy", list(JAX_BACKEND))
def test_packet_step_matches_reference(setup, strategy, backend):
    """``cuda`` on CPU tensors goes through the grouping and the kernel
    wrappers' plain versions; ``auto`` resolves to ``ref``."""
    jb, tb, p = setup
    want = jpipe.packet_step(jb, jnp.asarray(p), num_slots=K, strategy=strategy,
                             backend=JAX_BACKEND[strategy], block_b=BB)
    got = tpipe.packet_step(tb, to_t(p), num_slots=K, strategy=strategy,
                            backend=backend, block_b=BB)
    _check(got, want)
    assert set(got.actions.tolist()) == {0, 1, 2}


@pytest.mark.parametrize("strategy", ["take", "fused"])
def test_packet_step_fixed_slot_matches_reference(setup, strategy):
    jb, tb, p = setup
    want = jpipe.packet_step(jb, jnp.asarray(p), num_slots=K, strategy=strategy,
                             backend=JAX_BACKEND[strategy], fixed_slot=2,
                             block_b=BB)
    got = tpipe.packet_step(tb, to_t(p), num_slots=K, strategy=strategy,
                            backend="cuda", fixed_slot=2, block_b=BB)
    _check(got, want)
    assert set(got.slots.tolist()) == {2}


def test_slot_select_and_inference_only_match_reference(setup):
    jb, tb, p = setup
    assert_equal(tpipe.slot_select_only(to_t(p), K),
                 jpipe.slot_select_only(jnp.asarray(p), K))
    x = words(np.random.default_rng(6), (B, 256))
    params_j = {k: v[1] for k, v in jb.items()}
    want = jpipe.inference_only(params_j, jnp.asarray(x))
    assert_scores(tpipe.inference_only(tbank.select_slot(tb, 1), to_t(x))[:, 0],
                  np.asarray(want)[:, 0])


def test_pack_real_weights_matches_reference():
    rng = np.random.default_rng(7)
    w1 = rng.standard_normal((8, 256)).astype(np.float32)
    b1, w2, b2 = rng.standard_normal(8), rng.standard_normal((1, 8)), rng.standard_normal(1)
    got = numpy_bank(texecutor.pack_real_weights(w1, b1, w2, b2, device="cpu"))
    want = jexecutor.pack_real_weights(w1, b1, w2, b2)
    for name, leaf in want.items():
        np.testing.assert_array_equal(got[name], np.asarray(leaf))
