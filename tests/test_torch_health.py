"""The port's per-host lease monitor against the JAX reference's: the lease
cases of the reference's fault tests (lifecycle with exponential re-probe
backoff, a miss beating a heartbeat in the same tick, config validation),
random heartbeat/miss/probe streams at fixed seeds, and the
``on_transition`` hook.  Plain Python on both sides: the transition streams
and snapshots must be equal, entry for entry."""

import numpy as np
import pytest

from _torch_parity import one_torch_thread  # noqa: F401
from repro.control import health as jhealth
from repro_torch import control
from repro_torch.control import health


def _both(**kw):
    return health.HealthMonitor(**kw), jhealth.HealthMonitor(**kw)


def _same(ours, theirs):
    assert [t.as_dict() for t in ours.transitions] == \
        [t.as_dict() for t in theirs.transitions]
    assert ours.snapshot() == theirs.snapshot()
    assert ours.dead_hosts() == theirs.dead_hosts()
    assert ours.live_hosts() == theirs.live_hosts()
    assert ours.ever_missed == theirs.ever_missed


def test_exports_match_reference():
    assert control.HealthMonitor is health.HealthMonitor
    assert control.HostState is health.HostState
    assert control.Transition is health.Transition
    assert [s.value for s in health.HostState] == [s.value for s in jhealth.HostState]


def test_lease_lifecycle_matches_reference():
    """The reference's lifecycle case, driven through both monitors."""
    monitors = _both(num_hosts=2, lease_ticks=4, suspect_after=2)
    for hm in monitors:
        alive = False
        for t in range(4):
            hm.heartbeat(0, t)
            hm.miss(1, t)
            hm.miss(1, t)                       # deduped per (host, tick)
            hm.observe(t, probe=lambda h: alive)
        assert hm.total_misses == 4
        assert [(tr.to, tr.tick) for tr in hm.transitions] == \
            [("suspect", 1), ("dead", 3)]
        assert hm.dead_hosts() == (1,) and hm.live_hosts() == (0,)
        probed = []
        for t in range(4, 12):
            hm.heartbeat(0, t)
            before = hm.total_probes
            hm.observe(t, probe=lambda h, t=t: probed.append(t) or alive)
            assert hm.total_probes - before in (0, 1)
        assert probed == [5, 9]                 # backoff: +2, then +4
        alive = True
        for t in range(12, 20):
            hm.heartbeat(0, t)
            hm.observe(t, probe=lambda h: alive)
            if hm.state(1).value == "recovering":
                hm.heartbeat(1, t)
        assert hm.state(1).value == "healthy"
        assert [tr.to for tr in hm.transitions] == \
            ["suspect", "dead", "recovering", "healthy"]
    _same(*monitors)


def test_miss_beats_heartbeat_same_tick_like_reference():
    monitors = _both(num_hosts=1, lease_ticks=2, suspect_after=1)
    for hm in monitors:
        for t in range(2):
            hm.miss(0, t)
            hm.heartbeat(0, t)                  # ignored: miss recorded
            hm.observe(t)
        assert hm.is_dead(0)
    _same(*monitors)


@pytest.mark.parametrize("kw,match", [
    (dict(num_hosts=2, lease_ticks=2, suspect_after=3), "must not exceed"),
    (dict(num_hosts=0), "num_hosts"),
    (dict(num_hosts=2, lease_ticks=0), ">= 1"),
])
def test_config_validation_matches_reference(kw, match):
    for mod in (health, jhealth):
        with pytest.raises(ValueError, match=match):
            mod.HealthMonitor(**kw)


def test_suspect_clears_after_clean_heartbeats_and_mark_suspect():
    monitors = _both(num_hosts=3, lease_ticks=6, suspect_after=2)
    for hm in monitors:
        hm.mark_suspect(2, 0, "commit ack dropped")
        hm.mark_suspect(2, 0, "again")          # only from HEALTHY
        for t in range(3):
            hm.miss(1, t)
            for h in (0, 2):
                hm.heartbeat(h, t)
            hm.observe(t)
        for t in range(3, 6):
            for h in range(3):
                hm.heartbeat(h, t)
            hm.observe(t)
        assert [tr.reason for tr in hm.transitions][0] == "commit ack dropped"
        assert all(hm.state(h).value == "healthy" for h in range(3))
    _same(*monitors)


@pytest.mark.parametrize("seed", range(6))
def test_random_streams_match_reference(seed):
    """A random heartbeat / miss / suspicion / probe stream over 4 hosts:
    the same transitions, probes and snapshot in both monitors."""
    rng = np.random.default_rng(seed)
    lease = int(rng.integers(2, 7))
    kw = dict(num_hosts=4, lease_ticks=lease,
              suspect_after=int(rng.integers(1, lease + 1)),
              clean_to_clear=int(rng.integers(1, 4)),
              probe_interval=int(rng.integers(1, 4)), probe_max=16)
    ours, theirs = _both(**kw)
    seen = []
    ours.on_transition = seen.append
    for t in range(60):
        up = rng.random(4) < 0.6
        ops = [(h, "miss" if rng.random() < 0.35 else "heartbeat")
               for h in range(4)]
        suspect = int(rng.integers(0, 20))
        for hm in (ours, theirs):
            for h, op in ops:
                getattr(hm, op)(h, t)
            if suspect < 4:
                hm.mark_suspect(suspect, t, "probe")
            got = hm.observe(t, probe=lambda h: bool(up[h]))
            assert all(tr.tick == t for tr in got)
    assert seen == ours.transitions
    assert ours.total_probes == theirs.total_probes
    _same(ours, theirs)
