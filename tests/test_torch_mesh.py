"""The port's multi-host mesh data plane against the JAX reference: the mesh
RETA tables bit for bit, ``MeshDataplane(hosts=1)`` bit-identical to
``DataplaneRuntime``, every case of the reference's mesh tests played
through both packages' meshes (the reference at ``take``, the port at
``fused`` on the kernel's plain version and at ``take``), the queue layout
rule, the ``shard_map`` fan-out against ``vmap``, and a host crash and
rejoin in megastep mode against the sequential ticks."""

import types

import jax
import numpy as np
import pytest
import torch

from _torch_parity import CPU, mesh_state, one_torch_thread  # noqa: F401
from repro import control as jcontrol
from repro import dataplane as jdp
from repro.core import executor as jexecutor
from repro.dataplane import rss as jrss
from repro.dataplane import telemetry as jtelemetry
from repro_torch import control as tcontrol
from repro_torch import dataplane as tdp
from repro_torch.core import bank as tbank
from repro_torch.core import packet as tpkt
from repro_torch.dataplane import faults, rss, telemetry, workloads
from repro_torch.launch import mesh as mesh_lib

CFG = jexecutor.BNNConfig(hidden=16)
PORT_STRATEGIES = ("fused", "take")


def _jax_delivery(slot):
    return jexecutor.init_params(jax.random.PRNGKey(10_000 + slot), CFG)


def _port_delivery(slot):
    return tbank.from_jax_bank(
        {k: np.asarray(v) for k, v in _jax_delivery(slot).items()}, CPU)


@pytest.fixture(scope="module")
def pkgs():
    """The two packages side by side: the same bank, the same swap payloads."""
    jb = jexecutor.init_bank(jax.random.PRNGKey(0), 2, CFG)
    tb = tbank.from_jax_bank({k: np.asarray(v) for k, v in jb.items()}, CPU)
    jax_ns = types.SimpleNamespace(dp=jdp, ctl=jcontrol, bank=jb,
                                   delivery=_jax_delivery, kw={})
    port_ns = types.SimpleNamespace(dp=tdp, ctl=tcontrol, bank=tb,
                                    delivery=_port_delivery, kw=dict(device="cpu"))
    return jax_ns, port_ns


_JAX_RUNS: dict = {}


def both(pkgs, case, strategy, *args):
    """Run ``case(ns, strategy, *args)`` on the reference (at ``take``, once
    per case) and on the port (at ``strategy``); returns both results."""
    jax_ns, port_ns = pkgs
    key = (case.__name__,) + args
    if key not in _JAX_RUNS:
        _JAX_RUNS[key] = case(jax_ns, "take", *args)
    return _JAX_RUNS[key], case(port_ns, strategy, *args)


def small_phases(P, num_slots=2, total_queues=4):
    """The reference tests' storyline: backpressure, whole-host failover,
    churn."""
    uniform = tuple(1.0 / num_slots for _ in range(num_slots))
    half = tuple(range(total_queues // 2))
    return [
        P.dp.Phase("steady", ticks=2, burst=64, flows=16, slot_mix=uniform),
        P.dp.Phase("crowd", ticks=2, burst=192, flows=4, slot_mix=uniform),
        P.dp.Phase("churn", ticks=2, burst=64, flows=16, slot_mix=uniform,
                   failed_queues=half, swap_slot=1),
    ]


def make_mesh(P, strategy, *, hosts=2, num_queues=2, **kw):
    kw.setdefault("batch", 32)
    kw.setdefault("ring_capacity", 4096)
    return P.dp.MeshDataplane(P.bank, hosts=hosts, num_queues=num_queues,
                              strategy=strategy, **kw, **P.kw)


# ---------------------------------------------------------------------------
# global-queue-id RETA, bit for bit
# ---------------------------------------------------------------------------

def test_global_queue_id_roundtrip_matches_reference():
    host, queue = np.array([0, 1, 2]), np.array([3, 0, 1])
    gids = rss.global_queue_id(host, queue, 4)
    assert gids.tolist() == [3, 4, 9]
    np.testing.assert_array_equal(gids, jrss.global_queue_id(host, queue, 4))
    for a, b in zip(rss.split_host_queue(gids, 4), jrss.split_host_queue(gids, 4)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("hosts,queues", [(1, 4), (2, 4), (3, 2), (4, 4)])
def test_mesh_tables_match_reference(hosts, queues):
    ours = rss.mesh_indirection_table(hosts, queues)
    theirs = jrss.mesh_indirection_table(hosts, queues)
    assert ours.dtype == theirs.dtype and ours.tobytes() == theirs.tobytes()
    if hosts == 1:
        np.testing.assert_array_equal(ours, rss.indirection_table(queues))
    rng = np.random.default_rng(hosts * 10 + queues)
    rows = rng.integers(0, 2**32, (128, 272), dtype=np.uint32)
    for a, b in zip(rss.mesh_queue_of(rows, hosts, queues),
                    jrss.mesh_queue_of(rows, hosts, queues)):
        np.testing.assert_array_equal(a, b)
    h, q = rss.mesh_queue_of(rows, hosts, queues)
    assert set(h.tolist()) == set(range(hosts)) and q.max() < queues
    h1, q1 = rss.mesh_queue_of(rows, 1, queues)
    assert (h1 == 0).all() and (q1 == rss.queue_of(rows, queues)).all()
    with pytest.raises(ValueError):
        rss.mesh_indirection_table(0, queues)


@pytest.mark.parametrize("seed", range(8))
def test_cross_host_failover_preserves_survivor_affinity(seed):
    """Cross-host failover never remaps a flow whose (host, queue) both
    survive, dead pairs are fully drained, and the table equals the
    reference's bit for bit (the reference's property, at fixed seeds)."""
    rng = np.random.default_rng(seed)
    hosts, queues = int(rng.integers(1, 5)), int(rng.integers(1, 5))
    total = hosts * queues
    if total < 2:
        hosts, queues, total = 2, 1, 2
    reta = rng.integers(0, total, rss.RETA_SIZE).astype(np.int32)
    n_failed = int(rng.integers(1, 7))
    failed = tuple(sorted(rng.choice(total, size=min(n_failed, total - 1),
                                     replace=False).tolist()))
    fo = rss.mesh_failover_table(reta, failed, num_hosts=hosts, num_queues=queues)
    np.testing.assert_array_equal(
        fo, jrss.mesh_failover_table(reta, failed, num_hosts=hosts, num_queues=queues))
    dead = np.isin(reta, failed)
    assert (fo[~dead] == reta[~dead]).all()
    assert not np.isin(fo, failed).any()
    fw = rng.integers(0, 2**32, (64, rss.FLOW_WORDS), dtype=np.uint32)
    b = rss.bucket_index(rss.toeplitz_hash(fw), len(reta))
    survives = ~dead[b]
    h0, q0 = rss.split_host_queue(reta[b], queues)
    h1, q1 = rss.split_host_queue(fo[b], queues)
    assert (h1[survives] == h0[survives]).all()
    assert (q1[survives] == q0[survives]).all()


# ---------------------------------------------------------------------------
# hosts=1 is the degenerate mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy", PORT_STRATEGIES)
def test_hosts1_bit_identical_to_runtime(pkgs, strategy):
    _, P = pkgs
    trace = P.dp.render(small_phases(P), num_slots=2, seed=3)
    kw = dict(strategy=strategy, batch=32, ring_capacity=64, record=True,
              device="cpu")
    rt = P.dp.DataplaneRuntime(P.bank, num_queues=4, **kw)
    P.dp.play(rt, trace, swap_delivery=P.delivery)
    m1 = P.dp.MeshDataplane(P.bank, hosts=1, num_queues=4, **kw)
    P.dp.play(m1, trace, swap_delivery=P.delivery)
    assert m1.completed_seq == rt.completed_seq
    assert m1.completed_verdicts == rt.completed_verdicts
    assert m1.completed_slots == rt.completed_slots
    assert m1.dropped_seq == rt.dropped_seq
    assert (m1.reta == rt.reta).all()
    assert (m1.bucket_load == rt.bucket_load).all()
    assert m1.shards[0].bucket_load.sum() == 0  # counted at mesh level only
    a, b = rt.audit_conservation(), m1.audit_conservation()
    assert a["totals"] == b["totals"] and b["ok"]
    sa, sb = rt.snapshot(), m1.snapshot()
    assert sa["completed_total"] == sb["completed_total"]
    assert sa["slot_swaps"] == sb["slot_swaps"] == 1
    assert sa["reta_updates"] == sb["reta_updates"]
    assert workloads.digest(m1) == workloads.digest(rt)


# ---------------------------------------------------------------------------
# every reference mesh case, through both packages
# ---------------------------------------------------------------------------

def _conservation(P, strategy, hosts, queues):
    total = hosts * queues
    trace = P.dp.render(small_phases(P, total_queues=total), num_slots=2, seed=11)
    mesh = make_mesh(P, strategy, hosts=hosts, num_queues=queues,
                     ring_capacity=64, record=True)
    P.dp.play(mesh, trace, swap_delivery=P.delivery)
    return mesh, trace.total_packets


@pytest.mark.parametrize("strategy", PORT_STRATEGIES)
@pytest.mark.parametrize("hosts,queues", [(2, 2), (3, 2)])
def test_mesh_conservation_and_per_host_fifo(pkgs, strategy, hosts, queues):
    (theirs, n), (ours, n2) = both(pkgs, _conservation, strategy, hosts, queues)
    assert n == n2
    aud = ours.audit_conservation()
    assert aud["ok"], aud
    t = aud["totals"]
    assert t["offered"] == t["admitted"] + t["dropped"]
    assert t["offered"] == t["completed"] + t["dropped"] == n
    assert t["dropped"] > 0
    assert all(h["ok"] for h in aud["per_host"])
    for shard in ours.shards:
        for seqs in shard.completed_seq:
            assert (np.diff(np.asarray(seqs)) > 0).all()
    done = [s for qs in ours.completed_seq for s in qs]
    allseq = done + ours.dropped_seq
    assert len(allseq) == len(set(allseq)) == n
    assert mesh_state(ours) == mesh_state(theirs)


def test_dispatch_rejects_out_of_range_precomputed_queues(pkgs, rng):
    _, P = pkgs
    rt = P.dp.DataplaneRuntime(P.bank, num_queues=2, batch=8, ring_capacity=64,
                               device="cpu")
    rows = tpkt.make_packets(
        np.zeros(4, np.int64),
        rng.integers(0, 2**32, (4, tpkt.PAYLOAD_WORDS), dtype=np.uint32))
    with pytest.raises(ValueError, match="out of range"):
        rt.dispatch(rows, queues=np.array([0, 1, 2, 3]))
    with pytest.raises(ValueError, match="out of range"):
        rt.dispatch(rows, queues=np.array([0, -1, 1, 0]))
    rt.dispatch(rows, queues=np.array([0, 1, 1, 0]))
    assert rt.rings[0].counters.offered == 2
    assert rt.rings[1].counters.offered == 2
    assert rt.bucket_load.sum() == 0


def _failover(P, strategy):
    trace = P.dp.render(small_phases(P), num_slots=2, seed=1)
    mesh = make_mesh(P, strategy, record=True)
    mesh.control.submit(P.ctl.FailQueues(tuple(range(mesh.num_queues_per_host))))
    mesh.flush_control()
    for burst in trace.bursts[0]:
        mesh.dispatch(burst)
    offered = [[r.counters.offered for r in s.rings] for s in mesh.shards]
    mesh.drain()
    return mesh, offered


@pytest.mark.parametrize("strategy", PORT_STRATEGIES)
def test_mesh_failover_drains_dead_host(pkgs, strategy):
    (theirs, toff), (ours, offered) = both(pkgs, _failover, strategy)
    hostpart, _ = rss.split_host_queue(ours.reta, ours.num_queues_per_host)
    assert not (hostpart == 0).any()
    assert offered[0] == [0, 0] and sum(offered[1]) > 0
    assert offered == toff
    assert ours.audit_conservation()["ok"]
    assert mesh_state(ours) == mesh_state(theirs)


def _barrier(P, strategy):
    trace = P.dp.render(small_phases(P), num_slots=2, seed=6)
    bursts = [b for ph in trace.bursts for b in ph]
    mesh = make_mesh(P, strategy, hosts=3, num_queues=2, pipeline_depth=2,
                     record=True)
    for i, burst in enumerate(bursts):
        mesh.dispatch(burst)
        mesh.tick()
        if i == 1:
            mesh.control.submit(P.ctl.SwapSlot(1, P.delivery(41)),
                                P.ctl.ProgramReta(tuple(np.roll(mesh.reta, 1))))
        if i == 3:
            mesh.control.submit(P.ctl.FailQueues((0,)))
    mesh.drain()
    return mesh


@pytest.mark.parametrize("strategy", PORT_STRATEGIES)
def test_epoch_barrier_applies_at_same_tick_on_all_hosts(pkgs, strategy):
    theirs, ours = both(pkgs, _barrier, strategy)
    assert len(ours.control.log) >= 2
    for rec in ours.control.log:
        assert rec.applied and rec.commit_mode == "atomic"
        assert len(rec.host_ticks) == 3 and len(set(rec.host_ticks)) == 1
        assert rec.host_ticks[0] == rec.applied_tick
    assert [b["host_ticks"] for b in ours.barrier_log] == \
        [[r.applied_tick] * 3 for r in ours.control.log]
    assert all(rec["host_ticks"] == [rec["applied_tick"]] * 3
               for rec in ours.control.command_log())
    assert mesh_state(ours) == mesh_state(theirs)


def _veto(P, strategy):
    mesh = make_mesh(P, strategy)
    banks_before = [s.bank for s in mesh.shards]
    orig = mesh.shards[1]._validate_command

    def veto(cmd):
        if isinstance(cmd, P.ctl.SwapSlot):
            raise ValueError("host 1 refuses delivery")
        orig(cmd)

    mesh.shards[1]._validate_command = veto
    mesh.control.submit(P.ctl.SwapSlot(1, P.delivery(41)))
    with pytest.raises(ValueError, match="host 1 refuses"):
        mesh.flush_control()
    assert all(s.bank is b for s, b in zip(mesh.shards, banks_before))
    return mesh


@pytest.mark.parametrize("strategy", PORT_STRATEGIES)
def test_epoch_rejected_by_one_host_stages_nothing(pkgs, strategy):
    theirs, ours = both(pkgs, _veto, strategy)
    assert all(s.telemetry.slot_swaps == 0 for s in ours.shards)
    rec = ours.control.log[-1]
    assert rec.error and not rec.applied
    assert not ours.barrier_log
    assert mesh_state(ours) == mesh_state(theirs)


def _commit_failure(P, strategy):
    mesh = make_mesh(P, strategy)
    banks_before = [s.bank for s in mesh.shards]
    mesh.control.submit(P.ctl.SwapSlot(1, P.delivery(41)),
                        P.ctl.FailQueues(tuple(range(mesh.num_queues))))
    with pytest.raises(ValueError):
        mesh.flush_control()
    assert all(s.bank is b for s, b in zip(mesh.shards, banks_before))
    return mesh


@pytest.mark.parametrize("strategy", PORT_STRATEGIES)
def test_epoch_commit_failure_rolls_back_every_host(pkgs, strategy):
    theirs, ours = both(pkgs, _commit_failure, strategy)
    assert all(s.telemetry.slot_swaps == 0 for s in ours.shards)
    assert (ours.reta == rss.mesh_indirection_table(2, 2)).all()
    assert ours.failed_queues == set()
    assert ours.telemetry.slot_swaps == 0 and ours.telemetry.reta_updates == 0
    rec = ours.control.log[-1]
    assert rec.error and not rec.applied
    # the bank really is the pre-epoch one: serving still matches
    assert mesh_state(ours) == mesh_state(theirs)


def _later_reject(P, strategy):
    mesh = make_mesh(P, strategy)
    good = mesh.control.submit(P.ctl.SwapSlot(1, P.delivery(41)))
    mesh.control.submit(P.ctl.FailQueues(tuple(range(mesh.num_queues))))
    with pytest.raises(ValueError):
        mesh.flush_control()
    return mesh, good


@pytest.mark.parametrize("strategy", PORT_STRATEGIES)
def test_applied_epoch_keeps_barrier_stamp_when_later_epoch_rejects(pkgs, strategy):
    (theirs, _), (ours, good) = both(pkgs, _later_reject, strategy)
    recs = {r.epoch: r for r in ours.control.log}
    assert recs[good].applied and recs[good].host_ticks == (0, 0)
    assert [b["epoch"] for b in ours.barrier_log] == [good]
    assert ours.telemetry.slot_swaps == 1
    bad = recs[max(recs)]
    assert bad.error and not bad.applied and bad.host_ticks is None
    assert mesh_state(ours) == mesh_state(theirs)


def _cascade(P, strategy):
    phases = P.dp.cascading_failover_phases(2, hosts=2, queues_per_host=2)
    trace = P.dp.render(phases, num_slots=2, seed=0, num_queues=4)
    mesh = make_mesh(P, strategy, ring_capacity=256, audit=True,
                     pipeline_depth=2, record=True)
    P.dp.play(mesh, trace, swap_delivery=P.delivery)
    return mesh, trace.total_packets


@pytest.mark.parametrize("strategy", PORT_STRATEGIES)
def test_mesh_continuity_audit_across_cascading_failover(pkgs, strategy):
    (theirs, _), (ours, n) = both(pkgs, _cascade, strategy)
    cont = ours.control.continuity_audit()
    kinds = {c for e in cont["epochs"] for c in e["commands"]}
    assert kinds >= {"restore_queues", "fail_queues", "swap_slot"}, kinds
    assert cont["ok"], cont
    assert ours.telemetry.wrong_verdict == 0
    aud = ours.audit_conservation()
    assert aud["ok"] and aud["totals"]["offered"] == n
    assert mesh_state(ours) == mesh_state(theirs)


def _policy(P, strategy, policy_name):
    phases = P.dp.scenarios.elephant_skew_phases(2, 4, ticks=6)
    trace = P.dp.render(phases, num_slots=2, seed=0, num_queues=4)
    mesh = make_mesh(P, strategy, batch=64, ring_capacity=256, record=True,
                     policy=P.ctl.make_policy(policy_name))
    P.dp.play(mesh, trace, swap_delivery=P.delivery)
    return mesh


@pytest.mark.parametrize("strategy", PORT_STRATEGIES)
def test_mesh_policy_rebalances_with_global_ids(pkgs, strategy):
    drops = {}
    for name in ("static", "least-depth"):
        theirs, ours = both(pkgs, _policy, strategy, name)
        aud = ours.audit_conservation()
        assert aud["ok"]
        drops[name] = max(q["dropped"] for q in aud["per_queue"])
        if name == "least-depth":
            rebalances = [r for r in ours.control.log
                          if any(isinstance(c, tcontrol.ProgramReta)
                                 for c in r.commands)]
            assert rebalances
            assert all(len(set(r.host_ticks)) == 1 for r in rebalances)
        assert mesh_state(ours) == mesh_state(theirs)
    assert drops["static"] > 0
    assert drops["least-depth"] < drops["static"]


def _policy_failed(P, strategy):
    phases = P.dp.scenarios.elephant_skew_phases(2, 4, ticks=4)
    trace = P.dp.render(phases, num_slots=2, seed=1, num_queues=4)
    mesh = make_mesh(P, strategy, batch=64, ring_capacity=256, record=True,
                     policy=P.ctl.LeastDepth())
    mesh.control.submit(P.ctl.FailQueues((3,)))
    for phase_bursts in trace.bursts:
        for burst in phase_bursts:
            mesh.dispatch(burst)
            mesh.tick()
    mesh.drain()
    return mesh


@pytest.mark.parametrize("strategy", PORT_STRATEGIES)
def test_mesh_policy_never_routes_onto_failed_pairs(pkgs, strategy):
    theirs, ours = both(pkgs, _policy_failed, strategy)
    assert 3 not in set(ours.reta.tolist())
    assert ours.audit_conservation()["ok"]
    assert mesh_state(ours) == mesh_state(theirs)


# wall-clock fields, and the configuration echo that differs by strategy
TIMED = ("busy_s", "pps_busy", "elapsed_s", "pps_wall", "aggregate_pps",
         "latency_mean_us", "latency_p50_us", "latency_p99_us",
         "latency_max_us", "apply_latency_us_max", "strategy", "fanout")
# the port's own queue counters (ring wait, padded rows): the reference has none
PORT_ONLY = ("wait_s", "padded")


def _counts(obj):
    """A snapshot without its wall-clock fields and the port's own
    counters, NaN as None."""
    if isinstance(obj, dict):
        return {k: _counts(v) for k, v in obj.items()
                if k not in TIMED + PORT_ONLY}
    if isinstance(obj, list):
        return [_counts(v) for v in obj]
    if isinstance(obj, float) and obj != obj:
        return None
    return obj


def test_mesh_snapshot_matches_reference(pkgs):
    """The snapshot's counts (telemetry merged over hosts, broadcast
    commands counted once, conservation, health, control stats) equal the
    reference's."""
    (theirs, _), (ours, _) = both(pkgs, _cascade, "fused")
    a, b = ours.snapshot(), theirs.snapshot()
    assert _counts(a) == _counts(b)
    assert a["hosts"] == 2 and a["queues_per_host"] == 2
    assert (a["strategy"], a["fanout"]) == ("fused", "loop")
    assert (b["strategy"], b["fanout"]) == ("take", "vmap")


# ---------------------------------------------------------------------------
# telemetry merge and the cascading-failover phases
# ---------------------------------------------------------------------------

def test_telemetry_merge_matches_reference():
    outs = []
    for mod in (telemetry, jtelemetry):
        t0, t1 = mod.Telemetry(2, 2), mod.Telemetry(2, 2)
        t0.record_tick(0, np.array([0, 1]), np.array([True, False]),
                       np.array([0, 1]), latency_us=np.array([10.0, 20.0]),
                       tick_s=0.5)
        t1.record_tick(1, np.array([1, 1, 0]), np.array([True, True, False]),
                       np.array([2, 0, 0]), latency_us=np.array([5.0, 6.0, 7.0]),
                       tick_s=0.25)
        t0.slot_swaps, t1.wrong_verdict = 2, 3
        merged = mod.merge([t0, t1])
        assert [q.queue for q in merged.queues] == [0, 1, 2, 3]
        merged.queues[0].per_slot_total[0] = 99
        assert t0.queues[0].per_slot_total[0] != 99
        with pytest.raises(ValueError):
            mod.merge([])
        with pytest.raises(ValueError):
            mod.merge([t0, mod.Telemetry(1, 3)])
        outs.append(_counts(merged.snapshot(elapsed_s=1.0)))
    assert outs[0] == outs[1]


def test_cascading_failover_phase_shapes():
    phases = tdp.cascading_failover_phases(2, hosts=2, queues_per_host=4)
    assert [p.name for p in phases] == ["steady", "host_down", "cascade",
                                        "recovery"]
    assert phases[1].failed_queues == (0, 1, 2, 3)
    assert set(phases[2].failed_queues) >= {0, 1, 2, 3, 4, 5}
    assert phases[3].failed_queues == () and phases[3].swap_slot is not None
    with pytest.raises(ValueError, match="zero live"):
        tdp.cascading_failover_phases(2, hosts=1, queues_per_host=2)


# ---------------------------------------------------------------------------
# queue layout and the shard_map fan-out
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("queues,ndev,want,axis", [
    (4, 1, 1, "data"), (4, 2, 2, "data"), (4, 4, 4, "data"), (6, 4, 2, "queues"),
    (3, 2, 1, "queues"), (8, 3, 1, "queues"), (12, 8, 4, "queues")])
def test_queue_mesh_layout_rule(queues, ndev, want, axis):
    """The reference's rule: every device when the count divides the queues,
    else the gcd."""
    devs = [torch.device("cpu", i) for i in range(ndev)]
    got, ax = mesh_lib.make_queue_mesh(queues, devs)
    assert got == devs[:want] and ax == axis
    assert tdp.queue_mesh(queues, devs) == (got, ax)
    with pytest.raises(ValueError):
        mesh_lib.make_queue_mesh(0, devs)


def _fanout_run(P, fanout, **kw):
    trace = P.dp.render(small_phases(P), num_slots=2, seed=4)
    rt = P.dp.DataplaneRuntime(P.bank, num_queues=4, batch=32, ring_capacity=64,
                               record=True, audit=True, fanout=fanout,
                               device="cpu", **kw)
    P.dp.play(rt, trace, swap_delivery=P.delivery)
    return rt


@pytest.mark.parametrize("strategy", PORT_STRATEGIES)
@pytest.mark.parametrize("devices", [["cpu"], ["cpu", "cpu"], ["cpu:0", "cpu:1"]],
                         ids=["cpu", "cpu-cpu", "cpu0-cpu1"])
def test_shard_map_equals_vmap(pkgs, strategy, devices, monkeypatch):
    _, P = pkgs
    want = _fanout_run(P, "vmap", strategy=strategy)
    split = []
    orig = tdp.DataplaneRuntime._stacked_step

    def spy(self, bank, x3):
        split.append((x3.shape[0], x3.device))
        return orig(self, bank, x3)

    monkeypatch.setattr(tdp.DataplaneRuntime, "_stacked_step", spy)
    got = _fanout_run(P, "shard_map", strategy=strategy,
                      mesh_devices=[torch.device(d) for d in devices])
    assert got.fanout == "shard_map"
    assert [(d, hi - lo) for d, lo, hi in got._groups] == \
        [(torch.device(d), 4 // len(devices)) for d in devices]
    assert {n for n, _ in split} == {4 // len(devices)}
    assert workloads.digest(got) == workloads.digest(want)
    assert got.completed_verdicts == want.completed_verdicts
    assert got.audit_conservation() == want.audit_conservation()
    assert got.telemetry.wrong_verdict == 0


def test_shard_map_on_one_device_is_the_vmap_path(pkgs, monkeypatch):
    """One device: the vmap call itself, with no bank copy and no split."""
    _, P = pkgs
    monkeypatch.setattr(tdp.DataplaneRuntime, "_device_bank",
                        lambda self, dev: pytest.fail("bank copied"))
    rt = _fanout_run(P, "shard_map", mesh_devices=["cpu"])
    assert len(rt._groups) == 1 and rt.telemetry.wrong_verdict == 0


def test_shard_map_copies_the_bank_once_per_version(pkgs):
    _, P = pkgs
    rt = P.dp.DataplaneRuntime(P.bank, num_queues=2, batch=8, device="cpu",
                               fanout="shard_map",
                               mesh_devices=["cpu:0", "cpu:1"])
    dev = torch.device("cpu", 1)
    first = rt._device_bank(dev)
    assert rt._device_bank(dev) is first
    assert all(torch.equal(first[k], rt.bank[k]) for k in first)
    rt.control.submit(tcontrol.SwapSlot(1, P.delivery(41)))
    rt.flush_control()
    second = rt._device_bank(dev)
    assert second is not first
    assert all(torch.equal(second[k], rt.bank[k]) for k in second)
    assert not torch.equal(second["w1p"], first["w1p"])
    assert rt._device_bank(rt.device) is rt.bank


# ---------------------------------------------------------------------------
# megastep on a mesh: a crash and rejoin at window 8 against window 1
# ---------------------------------------------------------------------------

def _mega_mesh(P, window, plan):
    """Host 1 stalls past its lease; while it is dead an operator fails
    queue 0 (so the RETA projection it must resync to changes); it then
    rejoins and serves through swap epochs."""
    trace = P.dp.render([P.dp.Phase("drive", ticks=22, burst=64, flows=16,
                                    slot_mix=(0.5, 0.5))],
                        num_slots=2, seed=5, num_queues=4)
    mesh = P.dp.MeshDataplane(
        P.bank, hosts=2, num_queues=2, strategy="fused", batch=32,
        ring_capacity=256, record=True, audit=True, lease_ticks=4,
        megastep_ticks=window, fault_injector=faults.FaultInjector(plan),
        device="cpu")
    resynced = []
    real_resync = mesh._resync_shard

    def resync(host):
        real_resync(host)
        shard = mesh.shards[host]
        if shard._mega is not None:
            resynced.append((shard.reta.copy(), shard._mega.dev_reta.numpy().copy()))

    mesh._resync_shard = resync
    before = None
    for t, b in enumerate(trace.bursts[0]):
        if t == 9:
            before = mesh.shards[1].reta.copy()
            mesh.control.submit(P.ctl.FailQueues((0,)))
        if t % 4 == 3:
            mesh.control.submit(P.ctl.SwapSlot((t // 4) % 2, P.delivery(t % 3)))
        mesh.dispatch(b)
        mesh.tick()
    mesh.drain()
    return mesh, before, resynced


def test_megastep_crash_and_rejoin_matches_sequential(pkgs):
    _, P = pkgs
    plan = faults.demo_plan("stall", hosts=2, lease_ticks=4, at_tick=4)
    runs = {w: _mega_mesh(P, w, plan) for w in (1, 8)}
    (seq, _, _), (mega, before, resynced) = runs[1], runs[8]
    assert all(s._mega is None for s in seq.shards)
    assert all(s._mega is not None for s in mega.shards)
    tos = [t.to for t in mega.health.transitions]
    assert tos[:3] == ["suspect", "dead", "recovering"]
    assert mega.health.state(1).value == "healthy"
    assert mega.failover_epochs
    # the resync installed a new projection directly (no epoch delta), and
    # the window's close brought the device RETA mirror along at once
    assert len(resynced) == 1
    reta, mirror = resynced[0]
    assert not np.array_equal(before, reta)
    np.testing.assert_array_equal(mirror[:len(reta)], reta)
    assert workloads.digest(mega) == workloads.digest(seq)
    assert mesh_state(mega) == mesh_state(seq)
    aud = mega.audit_conservation()
    assert aud["ok"] and aud["wrong_verdict"] == 0
    assert aud["stranded"]["packets"] == 0
    for s in mega.shards:  # the resync's direct RETA install reached the mirror
        np.testing.assert_array_equal(s._mega.dev_reta.numpy()[:len(s.reta)], s.reta)


@pytest.mark.parametrize("mode", [dict(megastep_ticks=8), dict(pipeline_depth=3)],
                         ids=["window8", "depth3"])
def test_mesh_counts_stranded_rows_of_a_crashed_host(pkgs, mode):
    """A host that crashes with work popped but not retired (an open
    megastep window, or ticks in flight) keeps those rows counted as in
    flight, and as stranded once it is declared dead."""
    _, P = pkgs
    plan = faults.FaultPlan(faults=(faults.CrashHost(1, 3),), name="crash")
    wl = workloads.make_workload("emergency", num_slots=2, num_queues=2, hosts=2)
    rendered = tdp.render(list(wl.phases), num_slots=2, seed=5, num_queues=4)
    mesh = tdp.MeshDataplane(P.bank, hosts=2, num_queues=2, batch=32,
                             ring_capacity=256, lease_ticks=4,
                             fault_injector=faults.FaultInjector(plan),
                             device="cpu", **mode)
    bursts = [b for ph in rendered.bursts for b in ph]
    for b in bursts[:3]:
        mesh.dispatch(b)
        mesh.tick()
    held = sum(mesh.shards[1].in_flight_rows())
    assert held > 0
    for b in bursts[3:12]:
        mesh.dispatch(b)
        mesh.tick()
    aud = mesh.audit_conservation()
    assert aud["ok"] and aud["stranded"]["hosts"] == [1]
    assert aud["stranded"]["packets"] >= held
    assert aud["per_host"][1]["totals"]["in_flight"] == held
    mesh.drain()  # converges with the dead host's rows still parked
    assert mesh.audit_conservation()["per_host"][1]["totals"]["in_flight"] == held


def _rejoin(P, strategy):
    """Host 1 stalls past its lease, is failed over, re-probed and resynced,
    then serves through swap epochs of both slots."""
    plan = P.dp.faults.FaultPlan(faults=(P.dp.faults.StallHost(1, 2, 6),),
                                 name="stall-rejoin")
    trace = P.dp.render([P.dp.Phase("drive", ticks=28, burst=64, flows=16,
                                    slot_mix=(0.5, 0.5))],
                        num_slots=2, seed=8, num_queues=4)
    mesh = make_mesh(P, strategy, lease_ticks=4, record=True, audit=True,
                     fault_injector=P.dp.faults.FaultInjector(plan))
    for t, b in enumerate(trace.bursts[0]):
        if t % 2 == 1:
            mesh.control.submit(P.ctl.SwapSlot((t // 2) % 2, P.delivery(t % 5)))
        mesh.dispatch(b)
        mesh.tick()
    mesh.drain()
    return mesh


@pytest.mark.parametrize("strategy", PORT_STRATEGIES)
def test_rejoined_shard_owns_its_bank(pkgs, strategy):
    """The resync copies the bank into the rejoining shard's own buffers
    (``adopt_bank``), never an alias of a live shard's: the swaps after the
    rejoin then serve exactly as the reference's do."""
    theirs, ours = both(pkgs, _rejoin, strategy)
    assert [t.to for t in ours.health.transitions][:3] == \
        ["suspect", "dead", "recovering"]
    swaps_after = [r for r in ours.control.log if r.applied and any(
        isinstance(c, tcontrol.SwapSlot) for c in r.commands)
        and r.applied_tick > ours.health.transitions[2].tick]
    assert len(swaps_after) >= 4
    a, b = ours.shards[0], ours.shards[1]
    for buf_a in a._bankbuf._bufs:
        for buf_b in b._bankbuf._bufs:
            for name in buf_a.tree:
                assert buf_a.tree[name].data_ptr() != buf_b.tree[name].data_ptr()
    assert all(torch.equal(a.bank[k], b.bank[k]) for k in a.bank)
    assert ours.telemetry.wrong_verdict == 0
    assert mesh_state(ours) == mesh_state(theirs)


def test_mesh_validates_its_arguments(pkgs):
    _, P = pkgs
    with pytest.raises(ValueError, match="host"):
        tdp.MeshDataplane(P.bank, hosts=0, num_queues=2, device="cpu")
    with pytest.raises(ValueError, match="quorum"):
        tdp.MeshDataplane(P.bank, hosts=2, num_queues=2, quorum=3, device="cpu")
    mesh = tdp.MeshDataplane(P.bank, hosts=3, num_queues=2, device="cpu")
    assert mesh.quorum == 2 and mesh.num_queues == 6
    assert all(s.device == CPU for s in mesh.shards)
    # every shard owns its own two bank copies
    ptrs = {s.bank["w1p"].data_ptr() for s in mesh.shards}
    assert len(ptrs) == 3 and P.bank["w1p"].data_ptr() not in ptrs
    assert issubclass(tdp.QuorumLost, tcontrol.NonFatalControlError)
