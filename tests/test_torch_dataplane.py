"""The port's single-host data plane against the JAX reference: RSS hashing
and RETA tables, the host packet ring, scenario rendering, and the whole
``DataplaneRuntime`` (RSS dispatch -> rings -> fused workers -> epoch
control plane) played through the same scenario by both packages."""

import warnings

import jax
import numpy as np
import pytest
import torch

from _torch_parity import CPU, one_torch_thread  # noqa: F401
from repro.core import executor as jexecutor
from repro.dataplane import DataplaneRuntime as JRuntime
from repro.dataplane import PacketRing as JRing
from repro.dataplane import rss as jrss
from repro.dataplane.workloads import phases as jphases
from repro.dataplane.workloads.generators import emergency_phases as jemergency
from repro_torch.control import FailQueues, ProgramReta, SwapSlot
from repro_torch.core import bank as tbank
from repro_torch.core import executor as texecutor
from repro_torch.dataplane import DataplaneRuntime, PacketRing, rss
from repro_torch.dataplane.workloads import phases as tphases
from repro_torch.dataplane.workloads.generators import emergency_phases

# Full 256-word payloads (the packets' fixed layout), narrow hidden layer.
CFG = jexecutor.BNNConfig(hidden=16)
TIME_FIELDS = ("apply_latency_us", "apply_us")
TIME_SNAPSHOT = ("busy_s", "pps_busy", "latency_mean_us", "latency_p50_us",
                 "latency_p99_us", "latency_max_us")


# ---------------------------------------------------------------------------
# RSS dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_toeplitz_and_queue_of_match_reference(seed):
    rng = np.random.default_rng(seed)
    fw = rng.integers(0, 2**32, (257, rss.FLOW_WORDS), dtype=np.uint32)
    np.testing.assert_array_equal(rss.toeplitz_hash(fw), jrss.toeplitz_hash(fw))
    key = bytes(rng.integers(0, 256, 40, dtype=np.uint8))
    np.testing.assert_array_equal(rss.toeplitz_hash(fw, key),
                                  jrss.toeplitz_hash(fw, key))
    assert rss.toeplitz_hash(fw[:0]).shape == (0,)
    rows = rng.integers(0, 2**32, (64, 272), dtype=np.uint32)
    for q in (1, 3, 4, 8):
        np.testing.assert_array_equal(rss.queue_of(rows, q), jrss.queue_of(rows, q))
    reta96 = np.arange(96, dtype=np.int32) % 4
    np.testing.assert_array_equal(rss.queue_of(rows, 4, reta=reta96),
                                  jrss.queue_of(rows, 4, reta=reta96))


def test_reta_tables_match_reference():
    for q in (1, 2, 4, 7):
        np.testing.assert_array_equal(rss.indirection_table(q),
                                      jrss.indirection_table(q))
    base = rss.indirection_table(8)
    for failed in [(0,), (1, 5), (0, 2, 4, 6), (7,)]:
        np.testing.assert_array_equal(
            rss.failover_table(base, failed, num_queues=8),
            jrss.failover_table(base, failed, num_queues=8))
        np.testing.assert_array_equal(rss.restore_table(8, 128, set(failed)),
                                      jrss.restore_table(8, 128, set(failed)))
    with pytest.raises(ValueError):
        rss.failover_table(rss.indirection_table(1), (0,))
    with pytest.raises(ValueError):
        rss.indirection_table(200)


# ---------------------------------------------------------------------------
# host rings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_ring_matches_reference(seed):
    """The same push/pop sequence through both rings: identical rows,
    timestamps, counters and conservation at every step."""
    rng = np.random.default_rng(seed)
    cap = int(rng.integers(1, 40))
    ours, theirs = PacketRing(cap, packet_words=3), JRing(cap, packet_words=3)
    seq = 0
    for step in range(30):
        if rng.random() < 0.6:
            n = int(rng.integers(0, 25))
            rows = np.arange(seq, seq + n, dtype=np.uint32)[:, None] * np.ones(3, np.uint32)
            seq += n
            assert ours.push(rows, float(step)) == theirs.push(rows, float(step))
        else:
            n = int(rng.integers(0, cap + 5))
            (a, ta), (b, tb) = ours.pop(n), theirs.pop(n)
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(ta, tb)
            ours.mark_completed(a.shape[0])
            theirs.mark_completed(b.shape[0])
        assert ours.conservation() == theirs.conservation()
        assert len(ours) == len(theirs) and ours.free == theirs.free
    assert ours.ok()


def test_ring_rejects_zero_capacity():
    with pytest.raises(ValueError):
        PacketRing(0)


# ---------------------------------------------------------------------------
# scenarios
# ---------------------------------------------------------------------------

def small_phases(phase_mod, num_slots=2):
    """A fast 3-phase scenario exercising backpressure, failover and churn."""
    uniform = tuple(1.0 / num_slots for _ in range(num_slots))
    P = phase_mod.Phase
    return [
        P("steady", ticks=2, burst=64, flows=16, slot_mix=uniform),
        P("crowd", ticks=2, burst=192, flows=4, slot_mix=uniform),
        P("churn", ticks=2, burst=64, flows=16, slot_mix=uniform,
          failed_queues=(0,), swap_slot=1),
    ]


@pytest.mark.parametrize("which", ["small", "emergency", "elephant"])
def test_render_matches_reference(which):
    if which == "small":
        ours, theirs = small_phases(tphases), small_phases(jphases)
    elif which == "emergency":
        ours, theirs = emergency_phases(4), jemergency(4)
    else:
        kw = dict(ticks=2, burst=96, flows=12, slot_mix=(0.5, 0.5),
                  elephant_flows=2, elephant_queue=1, elephant_frac=0.8)
        ours, theirs = [tphases.Phase("e", **kw)], [jphases.Phase("e", **kw)]
    k = len(ours[0].slot_mix)
    a = tphases.render(ours, num_slots=k, seed=5, num_queues=4)
    b = jphases.render(theirs, num_slots=k, seed=5, num_queues=4)
    assert a.total_packets == b.total_packets
    for pa, pb in zip(a.bursts, b.bursts):
        for x, y in zip(pa, pb):
            np.testing.assert_array_equal(x, y)
    for po, pt in zip(ours, theirs):
        assert ([c.describe() for c in tphases.phase_command_specs(po, num_queues=4)]
                == [c.describe() for c in jphases.phase_command_specs(pt, num_queues=4)])


# ---------------------------------------------------------------------------
# runtime parity
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jbank2():
    return jexecutor.init_bank(jax.random.PRNGKey(0), 2, CFG)


def _jax_delivery(slot):
    return jexecutor.init_params(jax.random.PRNGKey(10_000 + slot), CFG)


def _port_delivery(slot):
    return tbank.from_jax_bank(
        {k: np.asarray(v) for k, v in _jax_delivery(slot).items()}, CPU)


def _play(runtime_cls, phase_mod, bank, delivery, **kw):
    trace = jphases.render(small_phases(jphases), num_slots=2, seed=7)
    rt = runtime_cls(bank, num_queues=4, batch=32, ring_capacity=64,
                     record=True, audit=True, **kw)
    reports = phase_mod.play(rt, trace, swap_delivery=delivery)
    return rt, reports


def _untimed_snapshot(rt):
    snap = rt.telemetry.snapshot(elapsed_s=1.0)
    snap.pop("aggregate_pps")
    for q in snap["queues"]:
        for f in TIME_SNAPSHOT:
            q.pop(f)
    return snap


@pytest.mark.parametrize("strategy,fanout,double_buffer", [
    ("take", "loop", True), ("take", "vmap", True),
    ("fused", "loop", True), ("fused", "vmap", True),
    ("fused", "loop", False),
])
def test_runtime_matches_reference(jbank2, strategy, fanout, double_buffer):
    kw = dict(strategy=strategy, fanout=fanout)
    theirs, jrep = _play(JRuntime, jphases, jbank2, _jax_delivery, **kw)
    tb = tbank.from_jax_bank({k: np.asarray(v) for k, v in jbank2.items()}, CPU)
    ours, trep = _play(DataplaneRuntime, tphases, tb, _port_delivery,
                       double_buffer=double_buffer, device="cpu", **kw)
    assert ours.completed_seq == theirs.completed_seq
    assert ours.completed_verdicts == theirs.completed_verdicts
    assert ours.completed_slots == theirs.completed_slots
    assert ours.dropped_seq == theirs.dropped_seq and ours.dropped_seq
    aud = ours.audit_conservation()
    assert aud == theirs.audit_conservation()
    assert aud["ok"] and aud["wrong_verdict"] == 0
    strip = lambda log: [{k: v for k, v in e.items() if k not in TIME_FIELDS}  # noqa: E731
                         for e in log]
    assert strip(ours.control.command_log()) == strip(theirs.control.command_log())
    assert ours.control.continuity_audit() == theirs.control.continuity_audit()
    assert _untimed_snapshot(ours) == _untimed_snapshot(theirs)
    for a, b in zip(trep, jrep):
        for f in ("phase", "offered", "completed", "dropped", "wrong_verdict"):
            assert a[f] == b[f]
    # the swapped slot holds the delivered weights
    for name, leaf in ours.bank.items():
        assert torch.equal(leaf[1], _port_delivery(1)[name])


def _cfg_delivery(slot):
    return texecutor.init_params(np.random.default_rng(10_000 + slot), CFG,
                                 device="cpu")


def test_pipelined_ticks_match_synchronous():
    rng = np.random.default_rng(0)
    bank = texecutor.init_bank(rng, 2, CFG, device="cpu")
    trace = tphases.render(small_phases(tphases), num_slots=2, seed=3)
    runs = []
    for depth in (1, 3):
        rt = DataplaneRuntime(bank, num_queues=4, batch=32, ring_capacity=64,
                              record=True, audit=True, pipeline_depth=depth,
                              device="cpu")
        tphases.play(rt, trace, swap_delivery=_cfg_delivery)
        assert rt.audit_conservation()["ok"]
        runs.append((rt.completed_seq, rt.completed_verdicts, rt.completed_slots))
    assert runs[0] == runs[1]


def test_default_swap_delivery_is_staged_onto_the_bank():
    rng = np.random.default_rng(1)
    bank = texecutor.init_bank(rng, 2, device="cpu")
    rt = DataplaneRuntime(bank, num_queues=2, batch=16, device="cpu")
    rt.control.submit(*tphases.phase_commands(
        tphases.Phase("s", ticks=1, burst=1, flows=1, slot_mix=(1, 0), swap_slot=1),
        num_queues=2))
    rt.flush_control()
    want = tphases.default_swap_delivery(1)
    assert all(torch.equal(rt.bank[n][1], want[n]) for n in want)
    assert rt.control.log[-1].commands[1].params is None  # payload not pinned


def test_delta_stream_sums_to_snapshot():
    rng = np.random.default_rng(2)
    bank = texecutor.init_bank(rng, 2, CFG, device="cpu")
    rt = DataplaneRuntime(bank, num_queues=4, batch=32, ring_capacity=64,
                          device="cpu")
    events = []
    rt.telemetry.attach_sink(events.append)
    tphases.play(rt, tphases.render(small_phases(tphases), num_slots=2, seed=1),
                 swap_delivery=_cfg_delivery)
    snap = rt.telemetry.snapshot()
    for q in range(4):
        got = sum(d["completed"] for e in events for d in e["queues"] if d["queue"] == q)
        assert got == snap["queues"][q]["completed"]
    assert sum(e["events"].get("dropped_total", 0) for e in events) == snap["dropped_total"]


def test_epoch_rollback_and_shims():
    rng = np.random.default_rng(3)
    bank = texecutor.init_bank(rng, 2, CFG, device="cpu")
    rt = DataplaneRuntime(bank, num_queues=4, device="cpu")
    rt.control.submit(FailQueues((0,)), FailQueues((1, 2, 3)))
    with pytest.raises(ValueError):
        rt.flush_control()
    assert rt.failed_queues == set() and rt.telemetry.reta_updates == 0
    assert rt.control.log[-1].commit_mode == "rollback"
    rt.control.submit(SwapSlot(1, texecutor.init_params(rng, CFG, device="cpu")),
                      ProgramReta(tuple([7] * rss.RETA_SIZE)))
    with pytest.raises(ValueError):
        rt.flush_control()
    assert rt.telemetry.slot_swaps == 0 and not rt._bankbuf.has_staged
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        rt.fail_queues((2,))
        rt.reset_reta()
    assert [x.category for x in w] == [DeprecationWarning] * 2
    assert rt.failed_queues == set()
    assert rt.snapshot()["control"]["commit_modes"] == {
        "atomic": 2, "degraded": 0, "rollback": 2}


@pytest.mark.parametrize("kw,match", [
    (dict(fanout="shard_map"), "item 9"),
])
def test_unported_options_raise(kw, match):
    bank = texecutor.init_bank(np.random.default_rng(0), 2, CFG, device="cpu")
    with pytest.raises(NotImplementedError, match=match):
        DataplaneRuntime(bank, num_queues=2, device="cpu", **kw)


def test_runtime_never_moves_the_bank():
    bank = texecutor.init_bank(np.random.default_rng(0), 2, CFG, device="cpu")
    meta = {k: torch.empty_like(v, device="meta") for k, v in bank.items()}
    with pytest.raises(ValueError, match="device"):
        DataplaneRuntime(meta, num_queues=2, device="cpu")
    rt = DataplaneRuntime(bank, num_queues=2, device="cpu")
    with pytest.raises(ValueError, match="device"):
        rt.adopt_bank(meta)


def test_runtime_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    bank = texecutor.init_bank(np.random.default_rng(0), 2, CFG, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        DataplaneRuntime(bank, num_queues=2)


@pytest.mark.parametrize("policy", ["static", "least-depth", "drop-rate"])
def test_routing_policy_matches_reference(jbank2, policy):
    """An elephant-skewed phase under a closed-loop routing policy: the same
    rebalance epochs, RETA and completion streams as the reference."""
    from repro.control import make_policy as jmake_policy
    from repro_torch.control import make_policy
    kw = dict(ticks=4, burst=160, flows=12, slot_mix=(0.5, 0.5),
              elephant_flows=2, elephant_queue=1, elephant_frac=0.8)
    trace = jphases.render([jphases.Phase("skew", **kw)], num_slots=2, seed=3,
                           num_queues=4)
    tb = tbank.from_jax_bank({k: np.asarray(v) for k, v in jbank2.items()}, CPU)
    runs = []
    for rt_cls, phase_mod, bank, mk, extra in (
            (JRuntime, jphases, jbank2, jmake_policy, {}),
            (DataplaneRuntime, tphases, tb, make_policy, dict(device="cpu"))):
        rt = rt_cls(bank, num_queues=4, batch=32, ring_capacity=48, record=True,
                    strategy="fused", policy=mk(policy), **extra)
        phase_mod.play(rt, trace)
        log = [{k: v for k, v in e.items() if k not in TIME_FIELDS}
               for e in rt.control.command_log()]
        runs.append((rt.completed_seq, rt.completed_verdicts, rt.dropped_seq,
                     rt.reta.tolist(), rt.bucket_load.tolist(), log))
    assert runs[0] == runs[1]
    if policy != "static":
        assert any(c["cmd"] == "program_reta" for e in runs[1][5] for c in e["commands"])
