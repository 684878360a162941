"""The port's trace codec and record/replay against the JAX reference: the
MessagePack subset byte for byte against ``msgpack``, traces recorded by
either package (v2 streamed and buffered, v1) replayed in the other with a
matching digest, synthesized traces, and the loader's refusals."""

import os
import struct
import zlib

import jax
import msgpack
import numpy as np
import pytest

from _torch_parity import CPU, one_torch_thread  # noqa: F401
from repro.control import make_policy as jmake_policy
from repro.core import executor as jexecutor
from repro.dataplane import DataplaneRuntime as JRuntime
from repro.dataplane import MeshDataplane as JMesh
from repro.dataplane import workloads as jworkloads
from repro.dataplane.workloads import trace as jtrace
from repro_torch import codec
from repro_torch.control import FailQueues, RestoreQueues, make_policy
from repro_torch.core import bank as tbank
from repro_torch.dataplane import DataplaneRuntime, MeshDataplane, workloads
from repro_torch.dataplane.workloads import Phase, ChaosEvent
from repro_torch.dataplane.workloads import trace as ttrace

CFG = jexecutor.BNNConfig(hidden=16)


def _edges():
    ints = {0, 2**63 - 1, 2**64 - 1, -2**63}
    for b in (5, 7, 8, 15, 16, 31, 32, 63):
        for d in (-1, 0, 1):
            ints |= {2**b + d, -(2**b) + d}
    return sorted(i for i in ints if -2**63 <= i < 2**64)


EDGE_DOCS = {
    "ints": _edges(),
    "floats": [0.0, -0.0, 1.5, -2.25e-300, 1e300, float("inf"), float("-inf"),
               0.1, np.float64(3.25)],
    "strs": ["", "a" * 31, "a" * 32, "a" * 255, "a" * 256, "a" * 65535, "a" * 65536,
             "é漢字", "x" * 70],
    "bins": [b"", b"\0" * 255, b"\1" * 256, b"\2" * 65535, b"\3" * 65536,
             bytearray(b"abc"), memoryview(b"mv")],
    "containers": [[], list(range(15)), list(range(16)), tuple(range(65536)),
                   {}, {str(i): i for i in range(15)}, {str(i): None for i in range(16)},
                   {"k": {"n": [True, False, None, (1, -1.0)]}},
                   {str(i): i for i in range(65536)}],
}


@pytest.mark.parametrize("group", sorted(EDGE_DOCS))
def test_codec_matches_msgpack_on_edge_values(group):
    for value in EDGE_DOCS[group]:
        raw = msgpack.packb(value, use_bin_type=True)
        assert codec.packb(value) == raw, (group, type(value))
        assert codec.unpackb(raw) == msgpack.unpackb(raw, raw=False, strict_map_key=False)
    nan = msgpack.packb(float("nan"), use_bin_type=True)
    assert codec.packb(float("nan")) == nan and np.isnan(codec.unpackb(nan))


def test_codec_refuses_what_msgpack_refuses():
    for bad in (2**64, -2**63 - 1):
        with pytest.raises(OverflowError):
            codec.packb(bad)
    for bad in (np.int64(3), np.float32(1.0), object(), {1, 2}):
        with pytest.raises(TypeError):
            codec.packb(bad)
    with pytest.raises(ValueError, match="extra data"):
        codec.unpackb(b"\x01\x02")
    with pytest.raises(ValueError, match="truncated"):
        codec.unpackb(b"\xcd\x01")
    assert codec.unpackb(msgpack.packb(1.5, use_single_float=True)) == 1.5


# ---------------------------------------------------------------------------
# recordings
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


def small_chaos_phases(phase_cls, chaos_cls, fail, restore, num_slots=2, num_queues=3):
    """The reference tests' compact storyline: a queue dies mid-surge while
    the rings are loaded, comes back, and a slot swaps at the exit."""
    uniform = tuple(1.0 / num_slots for _ in range(num_slots))
    victim = num_queues - 1
    chaos = (chaos_cls(at_tick=2, commands=(fail((victim,)),)),
             chaos_cls(at_tick=4, commands=(restore((victim,)),)))
    return [
        phase_cls("calm", ticks=2, burst=48, flows=16, slot_mix=uniform),
        phase_cls("surge", ticks=6, burst=128, flows=8, slot_mix=uniform, chaos=chaos),
        phase_cls("after", ticks=2, burst=48, flows=16, slot_mix=uniform,
                  swap_slot=1 % num_slots),
    ]


def _port_phases(which):
    if which == "small-chaos":
        return small_chaos_phases(Phase, ChaosEvent, FailQueues, RestoreQueues)
    return list(workloads.make_workload(which, num_slots=2, num_queues=3).phases)


def _jax_phases(which):
    from repro.control import FailQueues as JFail, RestoreQueues as JRestore
    from repro.dataplane.workloads.phases import ChaosEvent as JChaos, Phase as JPhase
    if which == "small-chaos":
        return small_chaos_phases(JPhase, JChaos, JFail, JRestore)
    return list(jworkloads.make_workload(which, num_slots=2, num_queues=3).phases)


def _jax_record(bank, which, path, *, policy=None, streamed=True):
    """A trace of ``which`` recorded by the reference: streamed to ``path``
    (v2), or buffered and saved as v1 by its compatibility writer."""
    rt = JRuntime(bank, num_queues=3, batch=64, ring_capacity=256, record=True,
                  policy=None if policy is None else jmake_policy(policy))
    rendered = jworkloads.render(_jax_phases(which), num_slots=2, seed=11, num_queues=3)
    rec = jworkloads.record(rt, path=path if streamed else None)
    jworkloads.play(rec, rendered, swap_delivery=_jax_delivery)
    out = rec.finish(name=which, seed=11)
    if not streamed:
        jtrace._save_v1(out, path)
    return rt


def _port_record(bank, which, path, *, policy=None, streamed=True):
    rt = DataplaneRuntime(bank, num_queues=3, batch=64, ring_capacity=256, record=True,
                          policy=None if policy is None else make_policy(policy),
                          device="cpu")
    rendered = workloads.render(_port_phases(which), num_slots=2, seed=11, num_queues=3)
    rec = workloads.record(rt, path=path if streamed else None)
    workloads.play(rec, rendered, swap_delivery=_port_delivery)
    out = rec.finish(name=which, seed=11)
    if not streamed:
        assert workloads.save(out, path) == os.path.getsize(path)
    return rt, out


@pytest.mark.parametrize("which,version", [
    ("small-chaos", 2), ("small-chaos", 1), ("slot-thrash", 2), ("diurnal", 1)])
def test_jax_recorded_trace_replays_in_port(banks, tmp_path, which, version):
    jb, _ = banks
    path = str(tmp_path / "jax.bswt")
    theirs = _jax_record(jb, which, path, streamed=version == 2)
    with open(path, "rb") as f:
        assert f.read(9) == ttrace.MAGIC + bytes([version])
    loaded = workloads.load(path)
    assert loaded.meta["name"] == which and loaded.bank_leaves is not None
    rt = workloads.make_runtime(loaded, audit=True, device="cpu")
    rep = workloads.replay(loaded, rt)
    assert rep["ok"], rep["mismatches"]
    assert rep["digest_ok"] is True
    assert rt.completed_seq == theirs.completed_seq
    assert rt.completed_verdicts == theirs.completed_verdicts
    assert rt.telemetry.wrong_verdict == 0 and rt.control.continuity_audit()["ok"]


@pytest.mark.parametrize("which,policy,streamed", [
    ("small-chaos", None, True), ("small-chaos", None, False),
    ("elephant-skew", "least-depth", True), ("chaos-queue-surge", None, False)])
def test_port_recorded_trace_replays_in_jax(banks, tmp_path, which, policy, streamed):
    _, tb = banks
    path = str(tmp_path / "port.bswt")
    ours, out = _port_record(tb, which, path, policy=policy, streamed=streamed)
    assert out.meta["policy"] == policy
    loaded = jworkloads.load(path)
    rt = jworkloads.make_runtime(loaded, audit=True)
    if policy is not None:
        assert rt.policy.name == policy
    rep = jworkloads.replay(loaded, rt)
    assert rep["ok"], rep["mismatches"]
    assert rep["digest_ok"] is True
    assert rt.completed_seq == ours.completed_seq
    assert rt.completed_verdicts == ours.completed_verdicts
    # and back in the port, from the same file
    again = workloads.load(path)
    rep2 = workloads.replay(again, workloads.make_runtime(again, device="cpu"))
    assert rep2["ok"] and rep2["digest_ok"] and rep2["digest"] == rep["digest"]


def test_streamed_recording_equals_buffered_save(banks, tmp_path):
    _, tb = banks
    streamed, buffered = str(tmp_path / "s.bswt"), str(tmp_path / "b.bswt")
    _, st = _port_record(tb, "small-chaos", streamed)
    rt, _ = _port_record(tb, "small-chaos", buffered, streamed=False)
    assert st.nbytes == os.path.getsize(streamed)
    with open(streamed, "rb") as f, open(buffered, "rb") as g:
        assert f.read() == g.read()
    trace = workloads.load(buffered)
    assert trace.total_packets == st.total_packets
    kinds = [type(c).__name__ for _, cmds in trace.command_timeline() for c in cmds]
    assert kinds.count("FailQueues") == 1 and kinds.count("SwapSlot") == 1


def _chunks(path):
    """Each v2 chunk's raw MessagePack bytes."""
    with open(path, "rb") as f:
        f.read(9)
        while head := f.read(5):
            (n,) = struct.unpack("<I", head[1:])
            yield zlib.decompress(f.read(n))


def test_codec_matches_msgpack_on_trace_and_spill_documents(banks, tmp_path):
    """The documents the trace and the spill write, from both packages:
    each chunk re-encodes byte for byte and decodes as msgpack decodes it."""
    jb, tb = banks
    raws = []
    for which in ("small-chaos", "slot-thrash"):
        _jax_record(jb, which, str(tmp_path / f"j-{which}.bswt"))
        _port_record(tb, which, str(tmp_path / f"t-{which}.bswt"))
        for side in "jt":
            raws += list(_chunks(str(tmp_path / f"{side}-{which}.bswt")))
    _jax_record(jb, "small-chaos", str(tmp_path / "v1.bswt"), streamed=False)
    with open(tmp_path / "v1.bswt", "rb") as f:
        raws.append(zlib.decompress(f.read()[9:]))
    spill = str(tmp_path / "epochs.bswel")
    rt = JRuntime(jb, num_queues=2, batch=64, ring_capacity=256, log_capacity=2,
                  log_spill=spill)
    wl = jworkloads.make_workload("slot-thrash", num_slots=2, num_queues=2)
    jworkloads.play(rt, jworkloads.render(list(wl.phases), num_slots=2, seed=1,
                                          num_queues=2), swap_delivery=_jax_delivery)
    with open(spill, "rb") as f:
        f.read(8)
        while head := f.read(4):
            raws.append(zlib.decompress(f.read(struct.unpack("<I", head)[0])))
    assert len(raws) > 10
    for raw in raws:
        doc = msgpack.unpackb(raw, raw=False, strict_map_key=False)
        assert codec.unpackb(raw) == doc
        assert codec.packb(doc) == raw


@pytest.mark.parametrize("regime", ["slot-thrash", "chaos-queue-surge", "emergency"])
def test_synthesized_trace_same_digest_in_both(banks, tmp_path, regime):
    """Given the same bank and swap delivery, both packages replay a
    synthesized trace (SwapSlot specs, no bank) to the same digest."""
    jb, tb = banks
    trace = workloads.synthesize(
        workloads.make_workload(regime, num_slots=2, num_queues=2).phases,
        num_slots=2, num_queues=2, seed=5, name=regime)
    path = str(tmp_path / "syn.bswt")
    workloads.save(trace, path)
    ours = DataplaneRuntime(tb, num_queues=2, batch=64, ring_capacity=256, record=True,
                            audit=True, device="cpu")
    rep = workloads.replay(workloads.load(path), ours, swap_delivery=_port_delivery)
    theirs = JRuntime(jb, num_queues=2, batch=64, ring_capacity=256, record=True, audit=True)
    jrep = jworkloads.replay(jworkloads.load(path), theirs, swap_delivery=_jax_delivery)
    assert rep["ok"] and jrep["ok"], (rep["mismatches"], jrep["mismatches"])
    assert rep["digest_ok"] is None  # a synthesized trace carries no digest
    assert rep["digest"] == jrep["digest"]
    assert rep["phases"] == jrep["phases"]


def test_replay_detects_tampered_invariants(banks):
    _, tb = banks
    rendered = workloads.render(_port_phases("small-chaos"), num_slots=2, seed=3,
                                num_queues=3)

    def rt():
        return DataplaneRuntime(tb, num_queues=3, batch=64, ring_capacity=256,
                                record=True, device="cpu")

    rec = workloads.record(rt())
    workloads.play(rec, rendered, swap_delivery=_port_delivery)
    trace = rec.finish()
    for step in trace.steps:
        if step["kind"] == "phase":
            step["expect"]["completed"] += 1  # lie about one phase
            break
    rep = workloads.replay(trace, rt())
    assert not rep["ok"]
    assert any("completed" in m for m in rep["mismatches"])
    with pytest.raises(AssertionError):
        workloads.replay(trace, rt(), strict=True)
    trace.expect["digest"]["sha256"] = "0" * 64
    rep = workloads.replay(trace, rt())
    assert rep["digest_ok"] is False and any("digest" in m for m in rep["mismatches"])


def test_trace_rejects_bad_files(tmp_path):
    bad = tmp_path / "bad.bswt"
    bad.write_bytes(b"NOTATRACE")
    with pytest.raises(ValueError, match="bad magic"):
        workloads.load(str(bad))
    t = workloads.synthesize(_port_phases("small-chaos"), num_slots=2,
                             num_queues=3, seed=0)
    path = tmp_path / "v.bswt"
    workloads.save(t, str(path))
    blob = bytearray(path.read_bytes())
    blob[len(ttrace.MAGIC)] = 99  # bump the version byte
    path.write_bytes(bytes(blob))
    with pytest.raises(ValueError, match="version"):
        workloads.load(str(path))
    # a streamed recording that never finished has no tail chunk
    partial = tmp_path / "partial.bswt"
    w = ttrace._ChunkWriter(str(partial), chunk_bytes=1)
    w.add_step({"kind": "tick"})
    w.abort()
    with pytest.raises(ValueError, match="no tail chunk"):
        workloads.load(str(partial))


@pytest.mark.parametrize("regime", ["chaos-host-failover", "cascading-failover"])
def test_multi_host_traces_wait_for_the_mesh(banks, tmp_path, regime):
    """A two-host trace, recorded on either package's mesh, replays on the
    other's mesh (``make_runtime`` builds one) with the same digest."""
    jb, tb = banks
    for wl_mod, cls, bank, delivery, extra, name in (
            (jworkloads, JMesh, jb, _jax_delivery, {}, "jax"),
            (workloads, MeshDataplane, tb, _port_delivery, dict(device="cpu"), "port")):
        wl = wl_mod.make_workload(regime, num_slots=2, num_queues=2, hosts=2)
        mesh = cls(bank, hosts=2, num_queues=2, strategy="take", batch=64,
                   ring_capacity=256, record=True, audit=True, **extra)
        rec = wl_mod.record(mesh, path=str(tmp_path / f"{name}.bswt"))
        wl_mod.play(rec, wl_mod.render(list(wl.phases), num_slots=2, seed=4,
                                       num_queues=4), swap_delivery=delivery)
        st = rec.finish(name=regime, seed=4)
        assert (st.meta["hosts"], st.meta["queues_per_host"], st.meta["num_queues"]) \
            == (2, 2, 4)
    digests = set()
    for name in ("jax", "port"):
        path = str(tmp_path / f"{name}.bswt")
        loaded = workloads.load(path)
        rt = workloads.make_runtime(loaded, audit=True, device="cpu")
        assert isinstance(rt, MeshDataplane) and rt.hosts == 2
        rep = workloads.replay(loaded, rt)
        assert rep["ok"] and rep["digest_ok"], rep["mismatches"]
        jloaded = jworkloads.load(path)
        jrep = jworkloads.replay(jloaded, jworkloads.make_runtime(jloaded, audit=True))
        assert jrep["ok"] and jrep["digest_ok"], jrep["mismatches"]
        assert rep["digest"] == jrep["digest"] == loaded.expect["digest"]
        assert rt.control.continuity_audit()["ok"]
        assert all(len(set(b["host_ticks"])) == 1 for b in rt.barrier_log)
        digests.add(rep["digest"]["sha256"])
    assert len(digests) == 1


def test_record_refuses_an_unregistered_policy(banks):
    """A policy the registry cannot rebuild would make the trace silently
    unreplayable (its rebalances regenerate at replay), so finishing fails."""
    _, tb = banks

    class Anon:
        def propose(self, view):
            return None

    rt = DataplaneRuntime(tb, num_queues=2, batch=16, policy=Anon(), record=True,
                          device="cpu")
    with pytest.raises(ValueError, match="non-registry policy"):
        workloads.record(rt).finish()
