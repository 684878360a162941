"""The port's fault injection and bounded epoch log against the JAX
reference: fault plans and their JSON form, the single-host injection
points (stall, stage and apply errors), the epoch spill read both ways,
a faulted single-host trace replayed bit-exactly in both packages, and the
mesh's fault-tolerant barriers (stall, lease expiry, crash and strand,
shard errors, a dropped ack, lost quorum, random plans, a faulted mesh
trace) played through both packages' meshes."""

import jax
import numpy as np
import pytest

from _torch_parity import CPU, mesh_state, one_torch_thread  # noqa: F401
from repro.control import SwapSlot as JSwapSlot
from repro.control import load_epoch_spill as jload_epoch_spill
from repro.core import executor as jexecutor
from repro.dataplane import DataplaneRuntime as JRuntime
from repro.dataplane import MeshDataplane as JMesh
from repro.dataplane import faults as jfaults
from repro.dataplane import workloads as jworkloads
from repro.dataplane.workloads import phases as jphases
from repro_torch.control import NonFatalControlError, SwapSlot, load_epoch_spill
from repro_torch.core import bank as tbank
from repro_torch.dataplane import DataplaneRuntime, MeshDataplane, faults, workloads
from repro_torch.dataplane.workloads import phases as tphases

CFG = jexecutor.BNNConfig(hidden=16)
TIME_FIELDS = ("apply_latency_us", "apply_us")


@pytest.fixture(scope="module")
def banks():
    jb = jexecutor.init_bank(jax.random.PRNGKey(0), 2, CFG)
    return jb, tbank.from_jax_bank({k: np.asarray(v) for k, v in jb.items()}, CPU)


def _jax_delivery(slot):
    return jexecutor.init_params(jax.random.PRNGKey(10_000 + slot), CFG)


def _port_delivery(slot):
    return tbank.from_jax_bank(
        {k: np.asarray(v) for k, v in _jax_delivery(slot).items()}, CPU)


def _untimed(log):
    return [{k: v for k, v in e.items() if k not in TIME_FIELDS} for e in log]


# ---------------------------------------------------------------------------
# fault plans
# ---------------------------------------------------------------------------

def test_fault_plan_json_roundtrip_both_ways(tmp_path):
    kinds = dict(faults=(faults.StallHost(1, 4, 3), faults.CrashHost(2, 9),
                         faults.ShardError(0, 5, "stage"), faults.DropAck(1, 7, 2),
                         faults.DelayRetire(1, 3, 6)),
                 name="kitchen-sink", seed=7)
    plan = faults.FaultPlan(**kinds)
    path = str(tmp_path / "plan.json")
    faults.save_plan(plan, path)
    assert faults.load_plan(path) == plan
    assert jfaults.load_plan(path).to_dict() == plan.to_dict()
    jpath = str(tmp_path / "jplan.json")
    jfaults.save_plan(jfaults.FaultPlan.from_dict(plan.to_dict()), jpath)
    assert faults.load_plan(jpath) == plan
    assert open(jpath).read() == open(path).read()
    with pytest.raises(ValueError, match="version"):
        faults.FaultPlan.from_dict(dict(plan.to_dict(), version=2))
    with pytest.raises(ValueError, match="unknown fault kind"):
        faults.FaultPlan.from_dict({"faults": [{"kind": "meteor", "host": 0}]})
    with pytest.raises(ValueError):
        faults.ShardError(0, 1, "retire")


@pytest.mark.parametrize("hosts", [1, 2, 4])
def test_demo_plan_covers_every_class_like_reference(hosts):
    for kind in faults.FAULT_CLASSES:
        plan = faults.demo_plan(kind, hosts=hosts, lease_ticks=4)
        assert plan.faults, kind
        assert plan.to_dict() == jfaults.demo_plan(kind, hosts=hosts, lease_ticks=4).to_dict()
        if hosts > 1:
            assert all(f.host != 0 for f in plan.faults), kind
    with pytest.raises(ValueError, match="unknown fault class"):
        faults.demo_plan("meteor", hosts=2)


@pytest.mark.parametrize("hosts", [1, 2, 3])
def test_random_plan_is_deterministic_and_matches_reference(hosts):
    for seed in range(12):
        plan = faults.random_plan(seed, hosts=hosts, horizon=16)
        assert plan == faults.random_plan(seed, hosts=hosts, horizon=16)
        assert plan.to_dict() == jfaults.random_plan(seed, hosts=hosts, horizon=16).to_dict()


def test_injected_fault_is_nonfatal():
    assert issubclass(faults.InjectedFault, NonFatalControlError)
    inj = faults.FaultInjector(faults.FaultPlan((faults.ShardError(0, 2, "apply"),)))
    inj.check("apply", 0, 1)  # window not open yet
    with pytest.raises(faults.InjectedFault):
        inj.check("apply", 0, 2)
    inj.check("apply", 0, 3)  # consumed once
    assert [e["point"] for e in inj.events] == ["apply"]


# ---------------------------------------------------------------------------
# single-host injection points, against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,plan_faults", [
    ("stall+stage-error", lambda f: (f.StallHost(0, 3, 2), f.ShardError(0, 7, "stage"))),
    ("apply-error", lambda f: (f.ShardError(0, 4, "apply"),)),
])
def test_single_host_faults_match_reference(banks, name, plan_faults):
    """A stall and an injected shard error on one host (the reference's own
    case): the same rolled-back epoch, streams, counters and fault events."""
    jb, tb = banks
    runs = []
    for rt_cls, fmod, phase_mod, bank, delivery, extra in (
            (JRuntime, jfaults, jphases, jb, _jax_delivery, {}),
            (DataplaneRuntime, faults, tphases, tb, _port_delivery, dict(device="cpu"))):
        plan = fmod.FaultPlan(faults=plan_faults(fmod), name=name)
        injector = fmod.FaultInjector(plan)
        rt = rt_cls(bank, num_queues=2, batch=32, ring_capacity=4096, strategy="take",
                    record=True, audit=True, fault_injector=injector, **extra)
        trace = jphases.render([jphases.Phase("drive", ticks=12, burst=64, flows=16,
                                              slot_mix=(0.5, 0.5))],
                               num_slots=2, seed=5, num_queues=2)
        for t, b in enumerate(trace.bursts[0]):
            if t % 3 == 1:
                rt.control.submit(phase_mod.SwapSlot(t % 2, delivery(t % 2)))
            rt.dispatch(b)
            rt.tick()
        rt.drain()
        rolled = [r for r in rt.control.log if r.commit_mode == "rollback"]
        assert len(rolled) == 1 and "injected" in rolled[0].error
        assert rt.control.continuity_audit()["ok"]
        assert rt.audit_conservation()["ok"]
        runs.append((rt.completed_seq, rt.completed_verdicts, rt.completed_slots,
                     rt.dropped_seq, rt.audit_conservation(),
                     _untimed(rt.control.command_log()),
                     rt.control.continuity_audit(), injector.events,
                     rt.telemetry.slot_swaps, rt.telemetry.runtime_ticks))
    assert runs[0] == runs[1]


# ---------------------------------------------------------------------------
# bounded epoch log
# ---------------------------------------------------------------------------

def _thrash(rt_cls, wl_mod, bank, delivery, **kw):
    """slot-thrash at the reference tests' size (an epoch every storm tick)."""
    wl = wl_mod.make_workload("slot-thrash", num_slots=2, num_queues=2)
    rendered = wl_mod.render(list(wl.phases), num_slots=2, seed=2, num_queues=2)
    rt = rt_cls(bank, num_queues=2, batch=64, ring_capacity=256, record=True,
                audit=True, **kw)
    wl_mod.play(rt, rendered, swap_delivery=delivery)
    return rt


@pytest.mark.parametrize("capacity", [1, 3])
def test_epoch_spill_reads_both_ways(banks, tmp_path, capacity):
    jb, tb = banks
    jpath, tpath = str(tmp_path / "jax.bswel"), str(tmp_path / "port.bswel")
    theirs = _thrash(JRuntime, jworkloads, jb, _jax_delivery,
                     log_capacity=capacity, log_spill=jpath)
    ours = _thrash(DataplaneRuntime, workloads, tb, _port_delivery,
                   log_capacity=capacity, log_spill=tpath, device="cpu")
    n = ours.control.stats()["epochs_spilled"]
    assert n == theirs.control.stats()["epochs_spilled"] >= 8
    assert len(ours.control.log) == capacity
    spilled = load_epoch_spill(tpath)
    assert [d["epoch"] for d in spilled] == list(range(1, n + 1))
    assert all(d["wrong_verdict_in_window"] == 0 for d in spilled)
    # each package reads the other's file, and both hold the same records
    assert _untimed(jload_epoch_spill(tpath)) == _untimed(spilled)
    assert _untimed(load_epoch_spill(jpath)) == _untimed(spilled)
    cont = ours.control.continuity_audit()
    assert cont["ok"] and cont["spilled_epochs"] == n
    assert cont == theirs.control.continuity_audit()
    assert _untimed(ours.control.command_log()) == _untimed(theirs.control.command_log())
    assert ours.completed_seq == theirs.completed_seq


def test_in_memory_spill_matches_reference(banks):
    jb, tb = banks
    theirs = _thrash(JRuntime, jworkloads, jb, _jax_delivery, log_capacity=2)
    ours = _thrash(DataplaneRuntime, workloads, tb, _port_delivery, log_capacity=2,
                   device="cpu")
    got = ours.control.spilled_records()
    assert got and _untimed(got) == _untimed(theirs.control.spilled_records())
    assert ours.control.continuity_audit()["spilled_wrong_verdict"] == 0


def test_log_capacity_validates(banks, tmp_path):
    _, tb = banks
    with pytest.raises(ValueError, match="log_capacity"):
        DataplaneRuntime(tb, num_queues=2, log_capacity=0, device="cpu")
    bad = tmp_path / "bad.bswel"
    bad.write_bytes(b"NOTALOG!")
    with pytest.raises(ValueError, match="not an epoch spill"):
        load_epoch_spill(str(bad))


# ---------------------------------------------------------------------------
# a faulted single-host trace, both ways
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("regime", ["crash-mid-commit", "barrier-straggler"])
def test_faulted_trace_replays_bit_exactly_both_ways(banks, tmp_path, regime):
    """The regime at hosts=1 (an injected stall): recorded by either package,
    replayed by both, with the same digest and rolled-back epochs."""
    jb, tb = banks
    wl = workloads.make_workload(regime, num_slots=2, num_queues=2, hosts=1)
    jwl = jworkloads.make_workload(regime, num_slots=2, num_queues=2, hosts=1)
    assert wl.fault_plan.to_dict() == jwl.fault_plan.to_dict()

    jrt = JRuntime(jb, num_queues=2, batch=32, ring_capacity=4096, record=True,
                   audit=True, fault_injector=jfaults.FaultInjector(jwl.fault_plan))
    jrec = jworkloads.record(jrt, path=str(tmp_path / "jax.bswt"))
    jworkloads.play(jrec, jworkloads.render(list(jwl.phases), num_slots=2, seed=9,
                                            num_queues=2), swap_delivery=_jax_delivery)
    jrec.finish(name=regime, seed=9)

    trt = DataplaneRuntime(tb, num_queues=2, batch=32, ring_capacity=4096, record=True,
                           audit=True, fault_injector=faults.FaultInjector(wl.fault_plan),
                           device="cpu")
    trec = workloads.record(trt, path=str(tmp_path / "port.bswt"))
    workloads.play(trec, workloads.render(list(wl.phases), num_slots=2, seed=9,
                                          num_queues=2), swap_delivery=_port_delivery)
    st = trec.finish(name=regime, seed=9)
    assert st.meta["fault_plan"] == wl.fault_plan.to_dict()
    assert trt.completed_seq == jrt.completed_seq
    assert trt.completed_verdicts == jrt.completed_verdicts

    digests = set()
    for path in ("jax.bswt", "port.bswt"):
        path = str(tmp_path / path)
        loaded = workloads.load(path)
        rt = workloads.make_runtime(loaded, audit=True, device="cpu")
        rep = workloads.replay(loaded, rt)
        assert rep["ok"] and rep["digest_ok"], rep["mismatches"]
        jloaded = jworkloads.load(path)
        jrt2 = jworkloads.make_runtime(jloaded, audit=True)
        jrep = jworkloads.replay(jloaded, jrt2)
        assert jrep["ok"] and jrep["digest_ok"], jrep["mismatches"]
        assert rep["digest"] == jrep["digest"]
        digests.add(rep["digest"]["sha256"])
        assert (rt.control.continuity_audit()["commit_modes"]
                == jrt2.control.continuity_audit()["commit_modes"])
        assert rt.control.continuity_audit()["ok"]
    assert len(digests) == 1


# ---------------------------------------------------------------------------
# the mesh's fault-tolerant barriers, against the reference
# ---------------------------------------------------------------------------

LEASE = 4


def _mesh_pair(banks, plan_fn, *, hosts=2, strategy="take", **kw):
    """The same faulted mesh in both packages: the reference at ``take``,
    the port at ``strategy`` (its fused kernel's plain version or take)."""
    jb, tb = banks
    kw.setdefault("batch", 32)
    kw.setdefault("ring_capacity", 4096)
    kw.setdefault("lease_ticks", LEASE)
    out = []
    for cls, fmod, bank, swap, delivery, extra, strat in (
            (JMesh, jfaults, jb, JSwapSlot, _jax_delivery, {}, "take"),
            (MeshDataplane, faults, tb, SwapSlot, _port_delivery,
             dict(device="cpu"), strategy)):
        plan = plan_fn(fmod)
        inj = fmod.FaultInjector(plan) if plan is not None else None
        mesh = cls(bank, hosts=hosts, num_queues=2, strategy=strat,
                   fault_injector=inj, **kw, **extra)
        out.append((mesh, swap, delivery))
    return out


def _drive(mesh, swap, delivery, *, ticks=14, swap_every=3, seed=3):
    """The reference tests' drive: dispatch + tick with a SwapSlot epoch
    every ``swap_every`` ticks, then drain."""
    total = mesh.hosts * mesh.num_queues_per_host
    trace = jphases.render([jphases.Phase("drive", ticks=ticks, burst=64, flows=16,
                                          slot_mix=(0.5, 0.5))],
                           num_slots=2, seed=seed, num_queues=total)
    for t, b in enumerate(trace.bursts[0]):
        if swap_every and t % swap_every == 1:
            slot = (t // swap_every) % 2
            mesh.control.submit(swap(slot, delivery(slot)))
        mesh.dispatch(b)
        mesh.tick()
    mesh.drain()


def _run_pair(banks, plan_fn, *, ticks, swap_every=3, **kw):
    pair = _mesh_pair(banks, plan_fn, **kw)
    for mesh, swap, delivery in pair:
        _drive(mesh, swap, delivery, ticks=ticks, swap_every=swap_every)
    (theirs, _, _), (ours, _, _) = pair
    assert mesh_state(ours) == mesh_state(theirs)
    return ours


@pytest.mark.parametrize("strategy", ["fused", "take"])
def test_mesh_stall_within_lease_defers_then_commits_atomic(banks, strategy):
    mesh = _run_pair(banks, lambda f: f.FaultPlan(faults=(f.StallHost(1, 4, 2),),
                                                  name="blip"),
                     ticks=12, strategy=strategy, suspect_after=3, lease_ticks=6)
    cont = mesh.control.continuity_audit()
    assert cont["ok"], cont
    assert cont["commit_modes"]["degraded"] == cont["commit_modes"]["rollback"] == 0
    assert mesh.failover_epochs == [] and mesh.health.dead_hosts() == ()
    stalled = [r for r in mesh.control.log if r.applied and r.applied_tick >= 4]
    assert stalled and all(r.commit_mode == "atomic" for r in stalled)


@pytest.mark.parametrize("strategy", ["fused", "take"])
def test_mesh_lease_expiry_degrades_then_recovers(banks, strategy):
    mesh = _run_pair(banks, lambda f: f.demo_plan("stall", hosts=2, lease_ticks=LEASE,
                                                  at_tick=4),
                     ticks=20, strategy=strategy)
    cont = mesh.control.continuity_audit()
    assert cont["ok"], cont
    assert cont["commit_modes"]["degraded"] > 0
    assert mesh.failover_epochs and mesh.restore_epochs
    assert [t.to for t in mesh.health.transitions][:2] == ["suspect", "dead"]
    assert mesh.health.state(1).value == "healthy"
    aud = mesh.audit_conservation()
    assert aud["ok"] and aud["stranded"]["packets"] == 0


@pytest.mark.parametrize("strategy", ["fused", "take"])
def test_mesh_crash_strands_packets_and_drain_converges(banks, strategy):
    mesh = _run_pair(banks, lambda f: f.demo_plan("crash", hosts=2, lease_ticks=LEASE,
                                                  at_tick=5),
                     ticks=16, strategy=strategy)
    aud = mesh.audit_conservation()
    assert aud["ok"], aud
    assert aud["stranded"]["hosts"] == [1] and aud["stranded"]["packets"] > 0
    t = aud["totals"]
    assert t["offered"] == (t["completed"] + t["dropped"] + t["occupancy"]
                            + t["in_flight"])
    assert mesh.control.continuity_audit()["commit_modes"]["degraded"] > 0
    assert mesh.failover_epochs and not mesh.restore_epochs
    assert mesh.health.is_dead(1)


@pytest.mark.parametrize("point", ["stage", "apply"])
def test_mesh_shard_error_rolls_back_atomically(banks, point):
    mesh = _run_pair(banks, lambda f: f.FaultPlan(faults=(f.ShardError(1, 4, point),),
                                                  name=f"err-{point}"),
                     ticks=10, strategy="fused")
    rolled = [r for r in mesh.control.log if r.commit_mode == "rollback"]
    assert len(rolled) == 1 and "injected shard error" in rolled[0].error
    assert not rolled[0].applied and rolled[0].apply_us is None
    assert any(r.applied and r.epoch > rolled[0].epoch for r in mesh.control.log)
    assert mesh.control.continuity_audit()["ok"]
    assert mesh.health.dead_hosts() == ()


def test_mesh_drop_ack_degrades_then_restores(banks):
    mesh = _run_pair(banks, lambda f: f.FaultPlan(faults=(f.DropAck(1, 4),),
                                                  name="lost-ack"),
                     ticks=16, strategy="fused")
    cont = mesh.control.continuity_audit()
    assert cont["ok"] and cont["commit_modes"]["degraded"] >= 1
    assert mesh.failover_epochs and mesh.restore_epochs
    assert mesh.health.state(1).value == "healthy"
    assert [t.to for t in mesh.health.transitions][0] == "suspect"


def test_mesh_delay_retire_straggler(banks):
    mesh = _run_pair(banks, lambda f: f.demo_plan("delay-retire", hosts=2,
                                                  lease_ticks=LEASE),
                     ticks=16, strategy="fused")
    assert mesh.control.continuity_audit()["ok"]
    assert mesh.audit_conservation()["ok"]


def test_mesh_quorum_lost_rolls_back_not_commits(banks):
    mesh = _run_pair(banks, lambda f: f.FaultPlan(
        faults=(f.CrashHost(1, 3), f.CrashHost(2, 3)), name="two-down"),
        hosts=3, ticks=14, strategy="fused")
    rolled = [r for r in mesh.control.log if r.commit_mode == "rollback"]
    assert rolled and all("quorum" in r.error for r in rolled)
    assert not any(r.commit_mode == "degraded" for r in mesh.control.log
                   if r.epoch > rolled[0].epoch)
    assert mesh.control.continuity_audit()["ok"]
    assert sorted(mesh.audit_conservation()["stranded"]["hosts"]) == [1, 2]


def test_mesh_log_capacity_spills_like_reference(banks, tmp_path):
    pair = _mesh_pair(banks, lambda f: None, strategy="fused", log_capacity=2)
    for (mesh, swap, delivery), name in zip(pair, ("jax", "port")):
        mesh.control._spill_path = str(tmp_path / f"{name}.bswel")
        _drive(mesh, swap, delivery, ticks=14, swap_every=2)
    (theirs, _, _), (ours, _, _) = pair
    assert mesh_state(ours) == mesh_state(theirs)
    stats = ours.control.stats()
    assert len(ours.control.log) == 2 and stats["epochs_spilled"] >= 2
    spilled = load_epoch_spill(str(tmp_path / "port.bswel"))
    assert [d["epoch"] for d in spilled] == list(range(1, stats["epochs_spilled"] + 1))
    assert all(d["commit_mode"] == "atomic" for d in spilled)
    assert _untimed(spilled) == _untimed(jload_epoch_spill(str(tmp_path / "jax.bswel")))
    cont = ours.control.continuity_audit()
    assert cont["ok"] and cont["spilled_wrong_verdict"] == 0


def test_mesh_commit_modes_and_snapshot(banks):
    mesh = _run_pair(banks, lambda f: f.demo_plan("crash", hosts=2, lease_ticks=LEASE),
                     ticks=12, strategy="fused")
    for rec in mesh.control.command_log():
        assert rec["commit_mode"] in ("atomic", "degraded", "rollback")
    snap = mesh.snapshot()
    assert snap["degraded_commits"] > 0
    assert snap["health"]["hosts"][1]["state"] == "dead"
    assert snap["fault_events"]


@pytest.mark.parametrize("regime", ["emergency", "flash-crowd", "slot-thrash"])
@pytest.mark.parametrize("plan_seed", [3, 1234])
def test_mesh_random_faults_preserve_invariants(banks, regime, plan_seed):
    """The reference's random-plan property at fixed seeds: conservation
    (stranded included), zero wrong verdicts, per-queue FIFO, and the
    same run as the reference's mesh."""
    jb, tb = banks
    runs = []
    for cls, fmod, wl_mod, bank, delivery, extra, strat in (
            (JMesh, jfaults, jworkloads, jb, _jax_delivery, {}, "take"),
            (MeshDataplane, faults, workloads, tb, _port_delivery,
             dict(device="cpu"), "fused")):
        plan = fmod.random_plan(plan_seed, hosts=2, horizon=16)
        wl = wl_mod.make_workload(regime, num_slots=2, num_queues=2, hosts=2)
        rendered = wl_mod.render(list(wl.phases), num_slots=2, seed=plan_seed,
                                 num_queues=4)
        mesh = cls(bank, hosts=2, num_queues=2, strategy=strat, batch=32,
                   ring_capacity=256, lease_ticks=LEASE, audit=True, record=True,
                   fault_injector=fmod.FaultInjector(plan), **extra)
        wl_mod.play(mesh, rendered, swap_delivery=delivery)
        runs.append(mesh)
    theirs, ours = runs
    aud = ours.audit_conservation()
    assert aud["ok"], aud
    t = aud["totals"]
    assert t["offered"] == (t["completed"] + t["dropped"] + t["occupancy"]
                            + t["in_flight"])
    cont = ours.control.continuity_audit()
    assert cont["ok"] and cont["wrong_verdict_total"] == 0
    for shard in ours.shards:
        for seqs in shard.completed_seq:
            assert (np.diff(np.asarray(seqs)) > 0).all()
    assert mesh_state(ours) == mesh_state(theirs)


def test_faulted_mesh_trace_replays_bit_exactly_both_ways(banks, tmp_path):
    """crash-mid-commit at two hosts, recorded by either package and
    replayed by both on ``make_runtime``'s mesh: equal digests, commit
    modes and stranded packets."""
    jb, tb = banks
    for rec_mod, fmod, cls, bank, delivery, extra, name in (
            (jworkloads, jfaults, JMesh, jb, _jax_delivery, {}, "jax"),
            (workloads, faults, MeshDataplane, tb, _port_delivery,
             dict(device="cpu"), "port")):
        wl = rec_mod.make_workload("crash-mid-commit", num_slots=2, num_queues=2,
                                   hosts=2)
        mesh = cls(bank, hosts=2, num_queues=2, strategy="take", batch=32,
                   ring_capacity=4096, lease_ticks=LEASE, record=True, audit=True,
                   fault_injector=fmod.FaultInjector(wl.fault_plan), **extra)
        rec = rec_mod.record(mesh, path=str(tmp_path / f"{name}.bswt"))
        rec_mod.play(rec, rec_mod.render(list(wl.phases), num_slots=2, seed=9,
                                         num_queues=4), swap_delivery=delivery)
        st = rec.finish(name=wl.name, seed=9)
        assert st.meta["hosts"] == 2 and st.meta["lease_ticks"] == LEASE
        assert st.meta["fault_plan"]["faults"]
    digests = set()
    for name in ("jax", "port"):
        path = str(tmp_path / f"{name}.bswt")
        loaded = workloads.load(path)
        rt = workloads.make_runtime(loaded, audit=True, device="cpu")
        assert isinstance(rt, MeshDataplane) and rt.quorum == loaded.meta["quorum"]
        rep = workloads.replay(loaded, rt)
        assert rep["ok"] and rep["digest_ok"], rep["mismatches"]
        jloaded = jworkloads.load(path)
        jrt = jworkloads.make_runtime(jloaded, audit=True)
        jrep = jworkloads.replay(jloaded, jrt)
        assert jrep["ok"] and jrep["digest_ok"], jrep["mismatches"]
        assert rep["digest"] == jrep["digest"]
        digests.add(rep["digest"]["sha256"])
        assert mesh_state(rt) == mesh_state(jrt)
        assert rt.audit_conservation()["stranded"]["hosts"] == [1]
    assert len(digests) == 1
