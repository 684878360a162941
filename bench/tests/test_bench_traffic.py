"""The generator: deterministic in the seed, exact queue shares in the
closed-loop mixes, and a schedule that does not depend on the seed."""

import json

import numpy as np
import pytest

from benchkit import layout as L, traffic
from conftest import BENCH


def mix(name):
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("name,slots,queues", [
    ("steady-sat", 16, 4), ("boundary-sat", 2, 1),
    ("emergency-paced", 16, 4), ("trickle-paced", 2, 1)])
def test_deterministic_in_seed(name, slots, queues):
    a = traffic.build(mix(name), num_slots=slots, num_queues=queues,
                      seed=2**31 + 7, seconds=1.0)
    b = traffic.build(mix(name), num_slots=slots, num_queues=queues,
                      seed=2**31 + 7, seconds=1.0)
    c = traffic.build(mix(name), num_slots=slots, num_queues=queues,
                      seed=2**31 + 8, seconds=1.0)
    assert np.array_equal(a.pool, b.pool)
    assert not np.array_equal(a.pool, c.pool)
    if not a.closed:
        # the schedule, the epochs and the amount of work are the seed's
        # to keep: only the packets differ
        assert np.array_equal(a.due, c.due)
        assert np.array_equal(a.starts, c.starts)
        assert a.epochs == c.epochs


def test_steady_sat_gives_each_queue_exactly_its_share():
    t = traffic.build(mix("steady-sat"), num_slots=16, num_queues=4,
                      seed=123456789012, seconds=1.0)
    assert t.pool.shape == (16 * 8192, L.PACKET_WORDS)
    for e in range(t.pool_bursts):
        rows = t.emission(e)
        q = L.default_queue_of(rows[:, L.FLOW_WORD_LO:L.FLOW_WORD_LO + 4], 4)
        assert np.bincount(q, minlength=4).tolist() == [2048] * 4
        assert np.array_equal(rows[:, L.SEQ_WORD],
                              np.arange(e * 8192, (e + 1) * 8192))
    flows = {tuple(r) for r in t.pool[:, L.FLOW_WORD_LO:L.FLOW_WORD_LO + 4]}
    assert len(flows) == 64
    assert set(np.unique(t.pool[:, L.SLOT_WORD])) == set(range(16))
    assert not t.pool[:, L.CONTROL_WORD].any()


def test_boundary_stream_alternates_in_runs_of_4096():
    t = traffic.build(mix("boundary-sat"), num_slots=2, num_queues=1,
                      seed=5, seconds=1.0)
    slots = t.pool[:, L.SLOT_WORD].astype(np.int64)
    assert np.array_equal(slots, (np.arange(slots.size) // 4096) % 2)
    share = (t.pool[:, L.CONTROL_WORD] & L.CTRL_MONITOR_ONLY).mean()
    assert 0.09 < share < 0.11


def test_emergency_storyline_rates_and_epochs():
    m = mix("emergency-paced")
    t = traffic.build(m, num_slots=16, num_queues=4, seed=9, seconds=2.0)
    r = m["base_rate_pps"]
    phase = np.searchsorted(t.phase_starts, t.starts, side="right") - 1
    per_phase = np.bincount(phase, minlength=4) * t.burst / 2.0
    # two cycles of 1 s: each phase's packets match its rate for 0.25 s
    assert np.allclose(per_phase / 0.25, [r, 4 * r, 2 * r, r], rtol=0.02)
    kinds = [c["cmd"] for _, cs, _ in t.epochs for c in cs]
    assert kinds.count("fail_queues") == 2
    assert kinds.count("swap_slot") == 2 + 40       # storyline + 20 a second
    swaps = [c["slot"] for _, cs, tag in t.epochs for c in cs if tag == "swap"]
    assert swaps[:17] == list(range(16)) + [0]
    # the flash crowd's eight flows load the queues 3, 2, 2, 1
    rows = t.pool[t.phase_starts[1]:t.phase_starts[2]]
    flows = np.unique(rows[:, L.FLOW_WORD_LO:L.FLOW_WORD_LO + 4], axis=0)
    assert sorted(np.bincount(L.default_queue_of(flows, 4), minlength=4)) == [1, 2, 2, 3]


def test_frozen_hash_matches_the_classic_toeplitz_vector():
    # the Microsoft RSS verification suite: 66.9.149.187:2794 ->
    # 161.142.100.80:1766 hashes to 0x51ccc178 over the IPv4 4-tuple
    src, dst = bytes([66, 9, 149, 187]), bytes([161, 142, 100, 80])
    data = src + dst + (2794).to_bytes(2, "big") + (1766).to_bytes(2, "big")
    bits = np.unpackbits(np.frombuffer(data, np.uint8)).astype(bool)
    windows = L._key_windows(L.DEFAULT_KEY, 96)
    h = np.bitwise_xor.reduce(np.where(bits, windows, np.uint32(0)))
    assert int(h) == 0x51CCC178


def test_elephant_flows_carry_their_share_on_their_queue():
    m = {"loop": "closed", "burst": 4096, "pool_bursts": 4, "phases": [
        {"name": "elephant", "flows": 32, "slots": {"kind": "uniform"},
         "elephants": {"flows": 4, "queue": 2, "share": 0.85}}]}
    t = traffic.build(m, num_slots=16, num_queues=4, seed=2**33 + 1, seconds=1.0)
    u = traffic.build(m, num_slots=16, num_queues=4, seed=2**33 + 1, seconds=1.0)
    assert np.array_equal(t.pool, u.pool)
    words = t.pool[:, L.FLOW_WORD_LO:L.FLOW_WORD_LO + 4]
    flows, counts = np.unique(words, axis=0, return_counts=True)
    heavy = flows[np.argsort(counts)[-4:]]
    assert (L.default_queue_of(heavy, 4) == 2).all()
    share = np.sort(counts)[-4:].sum() / t.pool.shape[0]
    assert 0.83 < share < 0.87
