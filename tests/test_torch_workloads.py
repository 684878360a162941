"""The port's workload regimes against the JAX reference: every regime's
phase list (at one and two hosts), its rendered bursts, the file corpus,
the registry, each single-host regime played through both runtimes, and
the four regimes that change shape at two hosts played through both
meshes."""

import dataclasses

import jax
import numpy as np
import pytest

from _torch_parity import CPU, mesh_state, one_torch_thread  # noqa: F401
from repro.core import executor as jexecutor
from repro.dataplane import DataplaneRuntime as JRuntime
from repro.dataplane import MeshDataplane as JMesh
from repro.dataplane import faults as jfaults
from repro.dataplane import workloads as jworkloads
from repro.dataplane.workloads import generators as jgenerators
from repro_torch.core import bank as tbank
from repro_torch.control import FailQueues
from repro_torch.dataplane import (DataplaneRuntime, MeshDataplane, faults, scenarios,
                                   workloads)
from repro_torch.dataplane.workloads import generators

CFG = jexecutor.BNNConfig(hidden=16)
TIME_FIELDS = ("apply_latency_us", "apply_us")
NAMES = workloads.REGIME_NAMES
SYNTH = generators.SYNTHETIC_CORPUS


def _norm(obj):
    """A value with each dataclass replaced by (class name, fields), so the
    two packages' phases and commands compare field by field."""
    if dataclasses.is_dataclass(obj):
        return (type(obj).__name__,
                {f.name: _norm(getattr(obj, f.name)) for f in dataclasses.fields(obj)})
    if isinstance(obj, (list, tuple)):
        return [_norm(x) for x in obj]
    if isinstance(obj, np.ndarray):
        return ("ndarray", str(obj.dtype), obj.tolist())
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


def _both(name, **kw):
    kw.setdefault("corpus_root", SYNTH)
    return (workloads.make_workload(name, **kw), jworkloads.make_workload(name, **kw))


def test_regime_names_match_reference():
    assert NAMES == jworkloads.REGIME_NAMES and len(NAMES) == 11


@pytest.mark.parametrize("hosts", [1, 2])
@pytest.mark.parametrize("name", NAMES)
def test_regime_phases_match_reference(name, hosts):
    for scale in (1, 3):
        ours, theirs = _both(name, num_slots=2, num_queues=3, scale=scale, hosts=hosts)
        assert ours.name == theirs.name
        assert _norm(ours.phases) == _norm(theirs.phases)
        assert (ours.fault_plan is None) == (theirs.fault_plan is None)
        if ours.fault_plan is not None:
            assert ours.fault_plan.to_dict() == theirs.fault_plan.to_dict()
        assert (ours.payload_pool is None) == (theirs.payload_pool is None)
        if ours.payload_pool is not None:
            np.testing.assert_array_equal(ours.payload_pool, theirs.payload_pool)
    if name != "file-replay":  # make_scenario takes no corpus root
        assert _norm(workloads.make_scenario(name, num_slots=4, num_queues=4, hosts=hosts)) \
            == _norm(jworkloads.make_scenario(name, num_slots=4, num_queues=4, hosts=hosts))


def test_regimes_refuse_what_the_reference_refuses():
    for mod in (generators, jgenerators):
        with pytest.raises(ValueError, match="zero live"):
            mod.cascading_failover_phases(2, hosts=1, queues_per_host=2)
        with pytest.raises(ValueError, match=">= 2 queues"):
            mod.chaos_queue_surge_phases(2, 1)
        with pytest.raises(ValueError, match=">= 2 global queues"):
            mod.chaos_host_failover_phases(2, hosts=1, queues_per_host=1)
    with pytest.raises(ValueError, match="unknown workload"):
        workloads.make_workload("nope", num_slots=2, num_queues=2)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", NAMES)
def test_render_matches_reference(name, seed):
    ours, theirs = _both(name, num_slots=2, num_queues=4)
    a = workloads.render(list(ours.phases), num_slots=2, seed=seed,
                         payload_pool=ours.payload_pool, num_queues=4)
    b = jworkloads.render(list(theirs.phases), num_slots=2, seed=seed,
                          payload_pool=theirs.payload_pool, num_queues=4)
    assert a.total_packets == b.total_packets > 0
    for pa, pb in zip(a.bursts, b.bursts, strict=True):
        for x, y in zip(pa, pb, strict=True):
            assert x.dtype == y.dtype == np.uint32
            assert x.tobytes() == y.tobytes()


def test_file_corpus_honours_the_environment(tmp_path, monkeypatch):
    (tmp_path / "a.bin").write_bytes(bytes(range(256)) * 64)
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "b.bin").write_bytes(b"emergency" * 4096)
    monkeypatch.setenv(generators.CORPUS_ENV, str(tmp_path))
    assert generators.CORPUS_ENV == jgenerators.CORPUS_ENV
    assert generators.file_corpus() == jgenerators.file_corpus()
    ours, theirs = _both("file-replay", num_slots=2, num_queues=2, corpus_root=None)
    assert [p.name for p in ours.phases] == ["file_a_bin", "file_sub_b_bin"]
    assert _norm(ours.phases) == _norm(theirs.phases)
    np.testing.assert_array_equal(ours.payload_pool, theirs.payload_pool)
    assert ours.payload_pool.tobytes().startswith(bytes(range(256)))
    for seed in (0, 1):
        a = workloads.render(list(ours.phases), num_slots=2, seed=seed,
                             payload_pool=ours.payload_pool, num_queues=2)
        b = jworkloads.render(list(theirs.phases), num_slots=2, seed=seed,
                              payload_pool=theirs.payload_pool, num_queues=2)
        assert all(x.tobytes() == y.tobytes()
                   for pa, pb in zip(a.bursts, b.bursts) for x, y in zip(pa, pb))
    # an explicit synthetic root skips the environment
    assert generators.file_corpus(SYNTH) == jgenerators.file_corpus(SYNTH)
    assert generators.file_corpus(SYNTH)[0][0] == "synthetic_0.bin"


def test_scenarios_shim_reexports_workloads():
    assert scenarios.Phase is workloads.Phase
    assert scenarios.render is workloads.render
    assert scenarios.play is workloads.play
    assert scenarios.make_scenario is workloads.make_scenario
    assert [p.name for p in scenarios.make_scenario("emergency", num_slots=2, num_queues=4)] \
        == ["steady", "flash_crowd", "link_failover", "slot_churn"]


# ---------------------------------------------------------------------------
# every single-host regime through both runtimes
# ---------------------------------------------------------------------------

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


@pytest.mark.parametrize("name", NAMES)
def test_regime_plays_like_reference(banks, name):
    """The regime at hosts=1, 3 queues, batch 64 and ring 256 (the sizes of
    the reference's workload tests), its fault plan armed where it has one:
    identical completion streams, conservation and epoch logs."""
    jb, tb = banks
    runs = []
    for wl_mod, fmod, rt_cls, bank, delivery, extra in (
            (jworkloads, jfaults, JRuntime, jb, _jax_delivery, {}),
            (workloads, faults, DataplaneRuntime, tb, _port_delivery, dict(device="cpu"))):
        wl = wl_mod.make_workload(name, num_slots=2, num_queues=3, corpus_root=SYNTH)
        injector = (fmod.FaultInjector(wl.fault_plan)
                    if wl.fault_plan is not None else None)
        rt = rt_cls(bank, num_queues=3, batch=64, ring_capacity=256, record=True,
                    audit=True, fault_injector=injector, **extra)
        rendered = wl_mod.render(list(wl.phases), num_slots=2, seed=3,
                                 payload_pool=wl.payload_pool, num_queues=3)
        reports = wl_mod.play(rt, rendered, swap_delivery=delivery)
        aud = rt.audit_conservation()
        assert aud["ok"] and aud["wrong_verdict"] == 0
        assert rt.control.continuity_audit()["ok"]
        runs.append((rt.completed_seq, rt.completed_verdicts, rt.completed_slots,
                     rt.dropped_seq, aud, _untimed(rt.control.command_log()),
                     rt.control.continuity_audit(),
                     [{k: r[k] for k in workloads.INVARIANT_KEYS} for r in reports],
                     None if injector is None else injector.events))
    assert runs[0] == runs[1]


# ---------------------------------------------------------------------------
# the mesh regimes, through both meshes
# ---------------------------------------------------------------------------

MESH_REGIMES = ("cascading-failover", "chaos-host-failover", "barrier-straggler",
                "crash-mid-commit")


@pytest.mark.parametrize("name", MESH_REGIMES)
def test_mesh_regime_plays_like_reference(banks, name):
    """The regimes that change shape at two hosts, 2 queues per host, their
    fault plans armed: the same mesh run in both packages (the reference at
    ``take``, the port at ``fused``)."""
    jb, tb = banks
    runs = []
    for wl_mod, fmod, cls, bank, delivery, extra, strat in (
            (jworkloads, jfaults, JMesh, jb, _jax_delivery, {}, "take"),
            (workloads, faults, MeshDataplane, tb, _port_delivery,
             dict(device="cpu"), "fused")):
        wl = wl_mod.make_workload(name, num_slots=2, num_queues=2, hosts=2)
        injector = (fmod.FaultInjector(wl.fault_plan)
                    if wl.fault_plan is not None else None)
        mesh = cls(bank, hosts=2, num_queues=2, strategy=strat, batch=64,
                   ring_capacity=256, record=True, audit=True, lease_ticks=4,
                   fault_injector=injector, **extra)
        rendered = wl_mod.render(list(wl.phases), num_slots=2, seed=3, num_queues=4)
        reports = wl_mod.play(mesh, rendered, swap_delivery=delivery)
        assert mesh.control.continuity_audit()["ok"]
        runs.append((mesh_state(mesh),
                     [{k: r[k] for k in workloads.INVARIANT_KEYS} for r in reports]))
    assert runs[0] == runs[1]


def test_synthesized_replay_deterministic_on_mesh(banks, tmp_path):
    """chaos-host-failover synthesized at two hosts, replayed twice on the
    port's mesh and once on the reference's: one digest, and the host-loss
    epoch failed a whole host's queues with equal barrier stamps."""
    jb, tb = banks
    w = workloads.make_workload("chaos-host-failover", num_slots=2, num_queues=2,
                                hosts=2)
    trace = workloads.synthesize(w.phases, num_slots=2, num_queues=4, seed=5,
                                 name=w.name)
    path = str(tmp_path / "mesh.bswt")
    workloads.save(trace, path)
    trace = workloads.load(path)

    def run():
        rt = MeshDataplane(tb, hosts=2, num_queues=2, batch=64, ring_capacity=256,
                           record=True, audit=True, device="cpu")
        return rt, workloads.replay(trace, rt, swap_delivery=_port_delivery)

    rt1, rep1 = run()
    _, rep2 = run()
    assert rep1["ok"], rep1["mismatches"]
    assert rep1["digest"]["sha256"] == rep2["digest"]["sha256"]
    assert rt1.telemetry.wrong_verdict == 0
    assert rt1.control.continuity_audit()["ok"]
    fails = [r for r in rt1.control.log
             if any(isinstance(c, FailQueues) for c in r.commands)]
    assert fails and fails[0].host_ticks is not None
    assert len(set(fails[0].host_ticks)) == 1
    jtr = jworkloads.load(path)
    jrt = JMesh(jb, hosts=2, num_queues=2, batch=64, ring_capacity=256,
                strategy="take", record=True, audit=True)
    jrep = jworkloads.replay(jtr, jrt, swap_delivery=_jax_delivery)
    assert jrep["digest"] == rep1["digest"]
    assert mesh_state(rt1) == mesh_state(jrt)
