"""The port's observability (``repro_torch.obs``) against the JAX reference's
(``repro.obs``): the telemetry delta stream event for event (runtime, a
2-host mesh, a megastep window), the anomaly detector's classification,
detect tick and proposals on every regime, the dashboard server's endpoints
and ``epoch_log_doc``.  Traces are synthesized by the reference, saved, and
loaded by the port, so both packages replay the same step stream over the
same bank and the same swap deliveries."""

import functools
import json
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from _torch_parity import CPU, banks as parity_banks, one_torch_thread, untimed_doc  # noqa: F401
from repro.control import ProgramReta as JProgramReta, SwapSlot as JSwapSlot
from repro.core import executor as jexecutor
from repro.dataplane import DataplaneRuntime as JRuntime
from repro.dataplane import MeshDataplane as JMesh
from repro.dataplane import faults as jfaults
from repro.dataplane import workloads as jworkloads
from repro.dataplane.workloads import generators as jgenerators
from repro.obs import AnomalyDetector as JDetector
from repro.obs import TelemetryStream as JStream
from repro.obs import attach as jattach
from repro.obs import spans as jspans
from repro_torch.control import FailQueues, ProgramReta, SwapSlot
from repro_torch.core import bank as tbank
from repro_torch.core import packet as pkt
from repro_torch.dataplane import DataplaneRuntime, MeshDataplane, faults, workloads
from repro_torch.dataplane import telemetry as telemetry_mod
from repro_torch.dataplane.workloads import generators
from repro_torch.obs import AnomalyDetector, TelemetryStream, attach, detach, spans
from repro_torch.obs.anomaly import RetrainRequest
from repro_torch.obs.server import ObsServer, _json_default

#: regimes whose detection evidence needs the mesh + armed fault plan
MESH_REGIMES = ("cascading-failover", "chaos-host-failover",
                "barrier-straggler", "crash-mid-commit")


@pytest.fixture(scope="module")
def banks():
    return parity_banks(2)


@functools.lru_cache(maxsize=None)
def _jax_delivery(slot, hidden=32):
    return jexecutor.init_params(jax.random.PRNGKey(10_000 + slot),
                                 jexecutor.BNNConfig(hidden=hidden))


def _port_delivery(slot, hidden=32):
    return tbank.from_jax_bank(
        {k: np.asarray(v) for k, v in _jax_delivery(slot, hidden).items()}, CPU)


def _events(stream) -> list[dict]:
    """Every event the stream holds, without its wall-clock fields."""
    return untimed_doc(stream.latest(1 << 20))


def _proposals(det) -> list:
    return [(type(c).__name__, c.describe()) for c in det.proposals()]


def _findings(det) -> list:
    """Findings that do not depend on the host clock (latency inflation
    fires on measured epoch latency; its degraded/rollback form does not)."""
    return [f.as_dict() for f in det.findings if "latency_us" not in f.detail]


def _state_fingerprint(state: dict):
    """The routing-state keys shared by runtime and mesh snapshots."""
    return (np.asarray(state["reta"]).tolist(), sorted(state["failed"]),
            np.asarray(state["bucket_load"]).tolist(),
            state["slot_swaps"], state["reta_updates"])


def _shape(regime):
    hosts = 2 if regime in MESH_REGIMES else 1
    return hosts, (2 if regime in MESH_REGIMES else 4)


def _regime_runtime(pkg, bank, regime):
    """The reference test's runtime for ``regime`` in package ``pkg``."""
    hosts, queues = _shape(regime)
    wl, runtime, mesh, fault_mod, corpus = (
        (jworkloads, JRuntime, JMesh, jfaults, jgenerators.SYNTHETIC_CORPUS)
        if pkg == "jax" else
        (workloads, DataplaneRuntime, MeshDataplane, faults,
         generators.SYNTHETIC_CORPUS))
    kw = dict(batch=128, ring_capacity=4096, record=True)
    if pkg == "torch":
        kw["device"] = "cpu"
    if hosts > 1:
        w = wl.make_workload(regime, num_slots=2, num_queues=queues,
                             hosts=hosts, corpus_root=corpus)
        injector = (fault_mod.FaultInjector(w.fault_plan)
                    if w.fault_plan is not None else None)
        return mesh(bank, hosts=hosts, num_queues=queues,
                    fault_injector=injector, **kw)
    return runtime(bank, num_queues=queues, **kw)


def _observe(rt, stream, det) -> dict:
    det.poll()
    got = det.classify()
    return {"events": _events(stream), "regime": got["regime"],
            "evidence": got["evidence"], "detect_tick": det.detect_tick(),
            "proposals": _proposals(det), "findings": _findings(det),
            "timeline": list(det.timeline),
            "epoch_log": untimed_doc(json.loads(json.dumps(
                (jspans if isinstance(rt, (JRuntime, JMesh)) else spans)
                .epoch_log_doc(rt), default=_json_default)))}


@pytest.fixture(scope="module")
def reference_regimes(banks, tmp_path_factory):
    """Each regime synthesized by the reference, saved, and replayed there
    with the detector attached: (observations, trace path)."""
    jb, _ = banks
    out = {}
    for regime in jworkloads.REGIME_NAMES:
        hosts, queues = _shape(regime)
        w = jworkloads.make_workload(
            regime, num_slots=2, num_queues=queues, hosts=hosts,
            corpus_root=jgenerators.SYNTHETIC_CORPUS)
        trace = jworkloads.synthesize(
            w.phases, num_slots=2, num_queues=hosts * queues, seed=0,
            name=regime, payload_pool=w.payload_pool)
        path = str(tmp_path_factory.mktemp("regimes") / f"{regime}.bswt")
        jworkloads.save(trace, path)
        rt = _regime_runtime("jax", jb, regime)
        stream = JStream(capacity=1 << 16)
        jattach(rt, stream)
        det = JDetector(stream, num_queues=hosts * queues, num_slots=2,
                        hosts=hosts)
        jworkloads.replay(trace, rt, swap_delivery=_jax_delivery)
        out[regime] = (_observe(rt, stream, det), path)
    return out


# ---------------------------------------------------------------------------
# the stream ring itself
# ---------------------------------------------------------------------------

def test_stream_ring_cursor_and_overflow():
    stream = TelemetryStream(capacity=8)
    for i in range(20):
        stream.push({"kind": "delta", "i": i})
    assert len(stream) == 8
    assert stream.dropped_events == 12
    events, cur = stream.tail(0)  # stale cursor resumes at oldest
    assert [e["i"] for e in events] == list(range(12, 20))
    assert cur == 20
    events, cur = stream.tail(cur)
    assert events == [] and cur == 20
    stream.push({"kind": "delta", "i": 20})
    events, cur = stream.tail(cur, limit=1)
    assert [e["i"] for e in events] == [20]
    s = stream.snapshot_stats()
    assert s["next_sid"] == s["buffered"] + s["dropped_events"] == 21
    with pytest.raises(ValueError, match="capacity"):
        TelemetryStream(capacity=0)


def test_stream_keeps_its_counts_under_concurrent_pushes_and_tails():
    """Pushers and tailers on their own threads (the run loop and the
    server's handlers): every sid is handed out once, each tailer sees
    increasing sids, and ``next_sid == buffered + dropped_events``."""
    import sys
    import threading

    stream = TelemetryStream(capacity=64)
    pushers, per = 8, 2000
    seen = [[] for _ in range(4)]
    sids = [[] for _ in range(pushers)]
    stop = threading.Event()

    def push(i):
        for _ in range(per):
            sids[i].append(stream.push({"kind": "delta"}))

    def tail(i):
        cursor = 0
        while not stop.is_set() or cursor < stream.next_sid:
            events, cursor = stream.tail(cursor, limit=16)
            seen[i].extend(e["sid"] for e in events)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = ([threading.Thread(target=tail, args=(i,)) for i in range(4)]
                   + [threading.Thread(target=push, args=(i,)) for i in range(pushers)])
        for t in threads:
            t.start()
        for t in threads[4:]:
            t.join(timeout=60)
        stop.set()
        for t in threads[:4]:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    handed = sorted(sid for got in sids for sid in got)
    assert handed == list(range(pushers * per))
    s = stream.snapshot_stats()
    assert s["next_sid"] == pushers * per == s["buffered"] + s["dropped_events"]
    for got in seen:
        assert got == sorted(set(got)) and got[-1] == pushers * per - 1


def test_stream_matches_reference_ring():
    """Same pushes, same tails, same stats: the ring is the reference's."""
    ours, ref = TelemetryStream(capacity=5), JStream(capacity=5)
    rng = np.random.default_rng(0)
    cur_o = cur_r = 0
    for step in range(40):
        for _ in range(int(rng.integers(0, 4))):
            ev = {"kind": "delta", "step": step}
            assert ours.push(dict(ev)) == ref.push(dict(ev))
        limit = int(rng.integers(1, 6))
        a, cur_o = ours.tail(cur_o, limit=limit)
        b, cur_r = ref.tail(cur_r, limit=limit)
        assert a == b and cur_o == cur_r
        assert ours.latest(3) == ref.latest(3)
        assert ours.snapshot_stats() == ref.snapshot_stats()


# ---------------------------------------------------------------------------
# delta stream
# ---------------------------------------------------------------------------

def _fold(events):
    """Sum a delta-event list back into cumulative totals."""
    tot = {"completed": {}, "dropped": {}, "per_slot": {}, "actions": {},
           "events": {}}
    for ev in events:
        if ev.get("kind") != "delta":
            continue
        for q in ev["queues"]:
            qid = q["queue"]
            tot["completed"][qid] = tot["completed"].get(qid, 0) + q["completed"]
            tot["dropped"][qid] = tot["dropped"].get(qid, 0) + q["dropped"]
            tot["per_slot"][qid] = (np.asarray(q["per_slot"])
                                    + tot["per_slot"].get(qid, 0))
            tot["actions"][qid] = (np.asarray(q["actions"])
                                   + tot["actions"].get(qid, 0))
        for name, d in ev["events"].items():
            tot["events"][name] = tot["events"].get(name, 0) + d
    return tot


def _assert_stream_matches_snapshot(rt, events):
    snap = rt.telemetry.snapshot()
    tot = _fold(events)
    for q in snap["queues"]:
        qid = q["queue"]
        assert tot["completed"].get(qid, 0) == q["completed"]
        assert tot["dropped"].get(qid, 0) == q["dropped"]
        if q["completed"]:
            assert np.array_equal(tot["per_slot"][qid], q["per_slot_total"])
    for name in telemetry_mod.EVENT_COUNTERS:
        assert tot["events"].get(name, 0) == snap[name], name


def _packets(rng, n, num_slots=2):
    slots = rng.integers(0, num_slots, n)
    payload = rng.integers(0, 2**32, (n, pkt.PAYLOAD_WORDS), dtype=np.uint32)
    return pkt.make_packets(slots, payload)


#: dispatch/tick interleavings: (burst size, tick after it?) per step
PLANS = [
    [(80, True), (80, True), (1, False), (64, True)],
    [(7, False), (33, False), (80, False), (80, False), (12, True)],
    [(1, True)] * 6 + [(80, False)] * 3,
    [(50, True), (0, True), (80, False), (40, True), (80, True), (3, False)],
    [(64, False), (64, True), (64, False), (64, True), (64, False),
     (64, True), (64, False), (64, True), (64, False), (64, True)],
]


@pytest.mark.parametrize("plan", range(len(PLANS)))
def test_delta_stream_sum_property(banks, plan):
    """Any dispatch/tick interleaving: the port's delta stream sums to
    ``snapshot()`` and equals the reference's, event for event."""
    jb, tb = banks
    got = {}
    for name, bank, runtime, kw in (("jax", jb, JRuntime, {}),
                                    ("torch", tb, DataplaneRuntime,
                                     dict(device="cpu"))):
        rng = np.random.default_rng(plan)
        rt = runtime(bank, num_queues=3, batch=32, ring_capacity=64, **kw)
        events = []
        rt.telemetry.attach_sink(events.append)
        for n, do_tick in PLANS[plan]:
            rt.dispatch(_packets(rng, n))  # tiny ring: drops exercised too
            if do_tick:
                rt.tick()
        rt.drain()
        rt.retire_all()
        _assert_stream_matches_snapshot(rt, events)
        got[name] = untimed_doc(events)
    assert got["torch"] == got["jax"]


def test_first_delta_carries_preattach_counters(banks):
    _, tb = banks
    rng = np.random.default_rng(1)
    rt = DataplaneRuntime(tb, num_queues=2, batch=64, ring_capacity=256,
                          device="cpu")
    rt.dispatch(_packets(rng, 32))
    rt.drain()
    events = []
    rt.telemetry.attach_sink(events.append)  # cursor resets on attach
    rt.dispatch(_packets(rng, 16))
    rt.drain()
    _assert_stream_matches_snapshot(rt, events)
    first_total = sum(q["completed"] for q in events[0]["queues"])
    assert first_total >= 32  # pre-attach work is in the first delta


@pytest.mark.parametrize("regime", ["emergency", "chaos-host-failover"])
def test_delta_events_match_reference_on_replay(banks, reference_regimes, regime):
    """The runtime (emergency, 4 queues) and a 2-host mesh: the stream's
    delta, epoch and health events equal the reference's, in stream order."""
    _, tb = banks
    ref, path = reference_regimes[regime]
    trace = workloads.load(path)
    rt = _regime_runtime("torch", tb, regime)
    stream = TelemetryStream(capacity=1 << 16)
    attach(rt, stream)
    rep = workloads.replay(trace, rt, swap_delivery=_port_delivery)
    assert rep["ok"], rep["mismatches"]
    events = _events(stream)
    assert [e["sid"] for e in events] == list(range(len(events)))
    assert {e["kind"] for e in events} >= {"delta", "epoch"}
    assert events == ref["events"]
    deltas = [e for e in stream.latest(1 << 20) if e["kind"] == "delta"]
    if regime == "emergency":
        _assert_stream_matches_snapshot(rt, deltas)
    assert all(q["completed"] >= 0 for e in deltas for q in e["queues"])


# Full 256-word payloads, a narrow hidden layer: the megastep tests' shape.
MEGA_HIDDEN = 16


def _mega_bursts(seed, sizes):
    rng = np.random.default_rng(seed)
    out, seq = [], 0
    for n in sizes:
        rows = _packets(rng, n)
        rows[:, workloads.SEQ_WORD] = np.arange(seq, seq + n, dtype=np.uint32)
        seq += n
        out.append(rows)
    return out


def test_delta_events_match_reference_in_a_megastep_window():
    """A window of 8 ticks emits one delta at its drain, in both packages:
    equal events (the window's, not the sequential loop's)."""
    cfg = jexecutor.BNNConfig(hidden=MEGA_HIDDEN)
    jb = jexecutor.init_bank(jax.random.PRNGKey(0), 2, cfg)
    tb = tbank.from_jax_bank({k: np.asarray(v) for k, v in jb.items()}, CPU)
    bursts = _mega_bursts(0, [5, 20, 0, 24, 7, 13, 24, 24, 3, 9, 24])
    swap = {"jax": lambda: JSwapSlot(0, _jax_delivery(0, MEGA_HIDDEN)),
            "torch": lambda: SwapSlot(0, _port_delivery(0, MEGA_HIDDEN))}
    reta = {"jax": JProgramReta, "torch": ProgramReta}
    got = {}
    for name, bank, runtime, kw in (("jax", jb, JRuntime, {}),
                                    ("torch", tb, DataplaneRuntime,
                                     dict(device="cpu"))):
        rt = runtime(bank, num_queues=2, batch=8, ring_capacity=256,
                     audit=True, record=True, megastep_ticks=8, **kw)
        assert rt._mega is not None
        events = []
        rt.telemetry.attach_sink(events.append)
        for t, burst in enumerate(bursts):
            if t == 2:
                rt.control.submit(swap[name]())
            if t == 4:
                rt.control.submit(reta[name](tuple(
                    int(x) for x in (np.arange(16) + t) % 2)))
            rt.dispatch(burst)
            rt.tick()
        rt.drain()
        _assert_stream_matches_snapshot(rt, events)
        got[name] = untimed_doc(events)
    # one delta per window drain (plus the final flush), not one per tick
    assert len(got["torch"]) < len(bursts)
    assert got["torch"] == got["jax"]


def test_epoch_and_health_spans_on_stream(banks, reference_regimes):
    _, tb = banks
    _, path = reference_regimes["crash-mid-commit"]
    rt = _regime_runtime("torch", tb, "crash-mid-commit")
    stream = TelemetryStream()
    attach(rt, stream)
    workloads.replay(workloads.load(path), rt, swap_delivery=_port_delivery)
    kinds = {e["kind"] for e in stream.latest(10_000)}
    assert {"delta", "epoch", "health"} <= kinds
    epochs = [e for e in stream.latest(10_000) if e["kind"] == "epoch"]
    for e in epochs:
        span = e["span"]
        assert span["outcome"] in ("atomic", "degraded", "rollback")
        if span["apply_us"] is not None:
            assert span["total_us"] >= span["apply_us"] >= 0
            assert span["queued_us"] >= 0
    # the mesh epoch log and the stream saw the same epochs
    assert len(epochs) == len(rt.control.log)
    detach(rt)
    assert not rt.shards[0].telemetry.has_sink
    assert rt.control.on_record is None and rt.health.on_transition is None


# ---------------------------------------------------------------------------
# anomaly detection over the full corpus
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("regime", workloads.REGIME_NAMES)
def test_detector_classifies_regime(banks, reference_regimes, regime):
    """On the port's stream the detector names the regime, and its
    classification, detect tick, findings and proposals equal the
    reference's on the reference's stream; proposals stage-accept without
    touching the control state."""
    _, tb = banks
    ref, path = reference_regimes[regime]
    hosts, queues = _shape(regime)
    rt = _regime_runtime("torch", tb, regime)
    stream = TelemetryStream(capacity=1 << 16)
    attach(rt, stream)
    det = AnomalyDetector(stream, num_queues=hosts * queues, num_slots=2,
                          hosts=hosts)
    workloads.replay(workloads.load(path), rt, swap_delivery=_port_delivery)
    got = _observe(rt, stream, det)
    assert got["regime"] == regime, (got["regime"], got["evidence"])
    assert got["detect_tick"] is not None
    for key in ("regime", "evidence", "detect_tick", "timeline", "findings",
                "proposals", "events", "epoch_log"):
        assert got[key] == ref[key], key

    before = rt.control.stats()["epochs_applied"]
    state_before = _state_fingerprint(rt._control_state())
    for cmd in det.proposals():
        if isinstance(cmd, RetrainRequest):
            assert cmd.describe()["cmd"] == "retrain"
            continue
        assert isinstance(cmd, (ProgramReta, FailQueues, SwapSlot))
        rt._validate_command(workloads.materialize_command(
            cmd, swap_delivery=_port_delivery))
    assert rt.control.stats()["epochs_applied"] == before
    assert _state_fingerprint(rt._control_state()) == state_before


def _delta(tick, queues):
    return {"kind": "delta", "seq": tick, "tick": tick, "t_s": None,
            "host": 0, "queues": queues, "events": {}}


def _both_detectors(deltas, **kw):
    """The same crafted deltas through both detectors."""
    out = []
    for stream_cls, det_cls in ((TelemetryStream, AnomalyDetector),
                                (JStream, JDetector)):
        stream = stream_cls()
        det = det_cls(stream, **kw)
        for ev in deltas:
            stream.push(json.loads(json.dumps(ev)))
        det.poll()
        out.append(det)
    ours, ref = out
    assert ours.classify() == ref.classify()
    assert ours.detect_tick() == ref.detect_tick()
    assert _proposals(ours) == _proposals(ref)
    assert [f.as_dict() for f in ours.findings] == \
        [f.as_dict() for f in ref.findings]
    return ours


def test_detector_proposes_failover_for_silent_queue():
    """A backlogged queue that stops completing draws a FailQueues
    proposal (unit-level: crafted deltas, no runtime)."""
    deltas = []
    for tick in range(10):
        q1_done = 32 if tick < 3 else 0  # completes early, then stalls
        deltas.append(_delta(tick, [
            {"queue": 0, "completed": 64, "dropped": 0, "per_slot": [32, 32],
             "actions": [64, 0, 0], "depth": 0},
            {"queue": 1, "completed": q1_done, "dropped": 0,
             "per_slot": [q1_done, 0], "actions": [q1_done, 0, 0],
             "depth": 40}]))
    det = _both_detectors(deltas, num_queues=2, num_slots=2, silence_ticks=3)
    assert any(f.detector == "queue_silence" for f in det.findings)
    fails = [c for c in det.proposals() if isinstance(c, FailQueues)]
    assert fails and 1 in fails[0].queues


def test_detector_proposes_retrain_on_slot_mix_shift():
    """A flipped slot mix draws a SwapSlot *spec* (params=None) plus a
    RetrainRequest for the now-dominant slot."""
    deltas = []
    for tick in range(16):
        per_slot = [64, 0] if tick < 8 else [0, 64]  # mix flips at t=8
        deltas.append(_delta(tick, [
            {"queue": 0, "completed": 64, "dropped": 0,
             "per_slot": per_slot, "actions": [64, 0, 0], "depth": 0},
            {"queue": 1, "completed": 60, "dropped": 0,
             "per_slot": per_slot, "actions": [60, 0, 0], "depth": 0}]))
    det = _both_detectors(deltas, num_queues=2, num_slots=2, window=4)
    assert any(f.detector == "slot_mix_shift" for f in det.findings)
    props = det.proposals()
    swaps = [c for c in props if isinstance(c, SwapSlot)]
    retrains = [c for c in props if isinstance(c, RetrainRequest)]
    assert swaps and swaps[0].slot == 1 and swaps[0].params is None
    assert retrains and retrains[0].slot == 1
    assert retrains[0].reason == "slot_mix_shift"
    assert retrains[0].describe()["cmd"] == "retrain"


def test_detector_proposes_retrain_on_drop_surge():
    """A sustained drop surge without routing skew (balanced queues)
    means the model, not the RETA, mismatches the traffic -> retrain."""
    deltas = []
    for tick in range(12):
        drops = 0 if tick < 6 else 24  # ring-edge drops start at t=6
        deltas.append(_delta(tick, [
            {"queue": 0, "completed": 64, "dropped": drops,
             "per_slot": [64, 0], "actions": [64, 0, 0], "depth": 0},
            {"queue": 1, "completed": 60, "dropped": drops,
             "per_slot": [60, 0], "actions": [60, 0, 0], "depth": 0}]))
    det = _both_detectors(deltas, num_queues=2, num_slots=2, window=4)
    assert any(f.detector == "drop_surge" for f in det.findings)
    assert det.classify()["regime"] != "elephant-skew"
    retrains = [c for c in det.proposals() if isinstance(c, RetrainRequest)]
    assert retrains and retrains[0].slot == 0
    assert retrains[0].reason == "drop_surge"


# ---------------------------------------------------------------------------
# dashboard API
# ---------------------------------------------------------------------------

def test_server_endpoints(banks, reference_regimes):
    _, tb = banks
    ref, path = reference_regimes["emergency"]
    rt = _regime_runtime("torch", tb, "emergency")
    stream = TelemetryStream()
    attach(rt, stream)
    det = AnomalyDetector(stream, num_queues=4, num_slots=2)
    with ObsServer(rt, stream, detector=det) as srv:
        assert srv.host == "127.0.0.1" and srv.port > 0
        workloads.replay(workloads.load(path), rt, swap_delivery=_port_delivery)
        base = f"http://127.0.0.1:{srv.port}"

        def get(ep):
            return json.load(urllib.request.urlopen(base + ep, timeout=10))

        assert get("/healthz") == {"ok": True, "port": srv.port}
        m = get("/metrics")
        snap = rt.telemetry.snapshot()
        assert m["totals"]["completed"] == snap["completed_total"]
        assert m["totals"]["dropped"] == snap["dropped_total"]
        assert len(m["queues"]) == 4
        assert [q["completed"] for q in m["queues"]] == \
            [q["completed"] for q in snap["queues"]]
        assert m["shape"]["num_slots"] == 2 and m["shape"]["hosts"] == 1
        e = get("/epochs")
        assert e["api_version"] == rt.control.API_VERSION
        assert len(e["epochs"]) == len(rt.control.log)
        assert all("span" in rec for rec in e["epochs"])
        # /epochs serves exactly what epoch_log_doc returns
        assert e == json.loads(json.dumps(spans.epoch_log_doc(rt),
                                          default=_json_default))
        assert untimed_doc(e) == ref["epoch_log"]
        a = get("/anomaly")
        assert a["enabled"] and a["regime"] == "emergency"
        assert all(isinstance(p, dict) and "cmd" in p for p in a["proposals"])
        assert [p for _, p in ref["proposals"]] == a["proposals"]
        html = urllib.request.urlopen(base + "/", timeout=10).read()
        assert b"dataplane observer" in html
        with urllib.request.urlopen(base + "/stream?cursor=0", timeout=10) as r:
            assert r.headers["Content-Type"] == "text/event-stream"
            first = r.readline().decode()
            assert first == "id: 0\n"
            data = json.loads(r.readline().decode()[len("data: "):])
            assert data["sid"] == 0 and data["kind"] in ("delta", "epoch")
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(base + "/nope", timeout=10)
        assert err.value.code == 404


def test_json_default_turns_tensors_into_lists():
    import torch
    doc = {"t": torch.arange(3, dtype=torch.int32), "n": np.int64(4),
           "f": np.float32(0.5), "a": np.arange(2)}
    assert json.loads(json.dumps(doc, default=_json_default)) == \
        {"t": [0, 1, 2], "n": 4, "f": 0.5, "a": [0, 1]}


def test_epoch_log_doc_matches_reference_with_faults(reference_regimes, banks):
    """``epoch_log_doc`` on a mesh with an armed fault plan carries the
    health snapshot and the fault events, equal to the reference's."""
    _, tb = banks
    ref, path = reference_regimes["barrier-straggler"]
    rt = _regime_runtime("torch", tb, "barrier-straggler")
    workloads.replay(workloads.load(path), rt, swap_delivery=_port_delivery)
    doc = untimed_doc(json.loads(json.dumps(spans.epoch_log_doc(rt),
                                            default=_json_default)))
    assert {"health", "fault_events"} <= set(doc)
    assert doc == ref["epoch_log"]
