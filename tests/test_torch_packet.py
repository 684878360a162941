"""Port parity, packet layer: layout constants, parsing, Pi, bit packing
and popcount against the JAX reference (``repro.core.packet``,
``repro.kernels.ref``) on the same NumPy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (  # noqa: F401
    assert_equal, to_t, words, one_torch_thread)
from repro.core import packet as jpkt
from repro.data import packets as jdata
from repro.kernels import fused_forward as jff
from repro.kernels import ref as jref
from repro_torch.core import packet as tpkt
from repro_torch.data import packets as tdata
from repro_torch.kernels import fused_forward as tff
from repro_torch.kernels import ref as tref

LAYOUT = ("REG_BYTES", "N_REGS", "PACKET_BYTES", "PAYLOAD_BYTES",
          "PAYLOAD_BITS", "PACKET_WORDS", "META_WORDS", "PAYLOAD_WORDS",
          "SLOT_WORD", "VERSION_WORD", "CONTROL_WORD_LO", "CONTROL_WORD_HI",
          "FORMAT_VERSION", "ACTION_FORWARD", "ACTION_DROP", "ACTION_FLAG",
          "CTRL_MONITOR_ONLY")


def test_layout_constants_match_reference():
    for name in LAYOUT:
        assert getattr(tpkt, name) == int(getattr(jpkt, name)), name
    for name in ("CTRL_WORD", "CTRL_MONITOR_ONLY", "ACTION_FORWARD",
                 "ACTION_DROP", "ACTION_FLAG"):
        assert getattr(tff, name) == getattr(jff, name), name


def test_make_packets_and_payload_words_match_reference():
    rng = np.random.default_rng(1)
    payload = words(rng, (6, tpkt.PAYLOAD_WORDS))
    slots = rng.integers(0, 4, 6)
    for control in (0, 1):
        np.testing.assert_array_equal(
            tpkt.make_packets(slots, payload, control=control),
            jpkt.make_packets(slots, payload, control=control))
    raw = rng.integers(0, 256, (3, tpkt.PAYLOAD_BYTES), dtype=np.uint8)
    np.testing.assert_array_equal(tpkt.payload_bytes_to_words(raw),
                                  jpkt.payload_bytes_to_words(raw))
    with pytest.raises(ValueError):
        tpkt.make_packets(slots, payload[:, :10])


@pytest.mark.parametrize("num_slots", [1, 4, 16])
def test_slot_of_matches_reference_including_wrapped_ids(num_slots):
    """0xFFFFFFFF reads as int32 -1 and clamps to slot 0, as in JAX; 100
    clamps to K-1."""
    rng = np.random.default_rng(num_slots)
    slot_words = np.array([0, 1, 3, 15, 100, 0xFFFFFFFF, 0x80000000, 7],
                          np.uint32)
    p = jpkt.make_packets(slot_words, words(rng, (8, tpkt.PAYLOAD_WORDS)))
    got = tpkt.slot_of(to_t(p), num_slots)
    assert_equal(got, jpkt.slot_of(jnp.asarray(p), num_slots))
    assert got[5] == 0 and got[4] == num_slots - 1
    assert_equal(tpkt.raw_slot_of(to_t(p)), jpkt.raw_slot_of(jnp.asarray(p)))


def test_parse_helpers_and_decide_action_match_reference():
    rng = np.random.default_rng(2)
    p = jpkt.make_packets(rng.integers(0, 4, 32),
                          words(rng, (32, tpkt.PAYLOAD_WORDS)))
    p[::3, tpkt.VERSION_WORD] = 7
    p[:, tpkt.CONTROL_WORD_LO] = words(rng, 32)  # arbitrary control bits
    scores = rng.standard_normal(32).astype(np.float32)
    tp, jp = to_t(p), jnp.asarray(p)
    assert_equal(tpkt.version_ok(tp), jpkt.version_ok(jp))
    assert_equal(tpkt.control_of(tp), np.asarray(jpkt.control_of(jp)).view(np.int32))
    assert_equal(tpkt.payload_of(tp), np.asarray(jpkt.payload_of(jp)).view(np.int32))
    got = tpkt.decide_action(tp, torch.from_numpy(scores))
    want = jpkt.decide_action(jp, jnp.asarray(scores))
    assert_equal(got, want)
    assert set(np.asarray(want)) == {0, 1, 2}
    assert_equal(tff.actions_ref(torch.from_numpy(scores[:, None]),
                                 tp[:, tpkt.CONTROL_WORD_LO]),
                 jff.actions_ref(jnp.asarray(scores[:, None]),
                                 jp[:, jpkt.CONTROL_WORD_LO]))


def test_popcount32_matches_numpy_and_reference():
    rng = np.random.default_rng(3)
    v = np.concatenate([words(rng, 4096),
                        np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF],
                                 np.uint32)])
    got = tref.popcount32(to_t(v))
    assert_equal(got, np.bitwise_count(v).astype(np.int64))
    assert_equal(got, np.asarray(jref.popcount32(jnp.asarray(v))).astype(np.int64))


@pytest.mark.parametrize("d", [32, 256, 2048])
def test_pack_unpack_match_reference(d):
    rng = np.random.default_rng(d)
    pm1 = np.where(rng.random((5, d)) < 0.5, 1.0, -1.0).astype(np.float32)
    packed = tref.pack_bits(torch.from_numpy(pm1))
    want = np.asarray(jref.pack_bits(jnp.asarray(pm1)))
    assert_equal(packed, want.view(np.int32))
    assert_equal(tref.unpack_bits(packed, d), jref.unpack_bits(jnp.asarray(want), d))
    with pytest.raises(ValueError):
        tref.pack_bits(torch.ones(3, d + 1))


def test_expand_block_slots_matches_reference():
    bs = np.array([3, 0, 2], np.int32)
    for total in (12, 10):
        assert_equal(tref.expand_block_slots(torch.from_numpy(bs), 4, total),
                     jref.expand_block_slots(jnp.asarray(bs), 4, total))


def test_synthetic_corpus_matches_reference():
    for group in ("20-1", "35-1"):
        cfg_t = tdata.PacketDatasetConfig(n_samples=64, seed=3, group=group)
        cfg_j = jdata.PacketDatasetConfig(n_samples=64, seed=3, group=group)
        xt, yt = tdata.generate(cfg_t)
        xj, yj = jdata.generate(cfg_j)
        np.testing.assert_array_equal(xt, xj)
        np.testing.assert_array_equal(yt, yj)
    np.testing.assert_array_equal(tdata.to_payload_words(xt),
                                  jdata.to_payload_words(xj))
