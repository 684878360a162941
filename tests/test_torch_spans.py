"""The data plane's own spans (``repro_torch.spans.SpanRecorder``, each
runtime's ``spans``) and the queue counters beside them (``wait_s``,
``padded``): off, the recorder changes nothing and stores nothing; on, its
tree covers the arrival edge and the tick, its counts equal what the
runtime served and padded, and its spans land on ``torch.profiler``'s host
timeline inside the caller's own range."""

import time

import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401
from repro_torch.core import executor
from repro_torch.dataplane import DataplaneRuntime, telemetry
from repro_torch.dataplane.workloads.phases import SEQ_WORD
from repro_torch import spans as spans_mod
from repro_torch.spans import SPAN_NAMES, SpanRecorder

NUM_SLOTS = 2
NUM_QUEUES = 4
BATCH = 16


@pytest.fixture(scope="module")
def bank():
    return executor.init_bank(np.random.default_rng(0), NUM_SLOTS,
                              executor.BNNConfig(hidden=16), device="cpu")


def _bursts(seed: int, sizes) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    out, seq = [], 0
    for n in sizes:
        rows = rng.integers(0, 2**32, (n, 272), dtype=np.uint32)
        rows[:, 0] = rng.integers(0, NUM_SLOTS, n)
        rows[:, SEQ_WORD] = np.arange(seq, seq + n)
        seq += n
        out.append(rows)
    return out


def _runtime(bank, **kw):
    kw = dict(dict(num_queues=NUM_QUEUES, batch=BATCH, ring_capacity=24,
                   backend="ref", record=True, device="cpu"), **kw)
    return DataplaneRuntime(bank, **kw)


def _drive(rt, bursts) -> dict:
    """Dispatch each burst then tick; drain at the end.  Returns the tick
    calls made and how many of them served."""
    calls = served = 0
    for rows in bursts:
        rt.dispatch(rows)
        calls += 1
        served += rt.tick() > 0
    while any(len(r) for r in rt.rings):
        calls += 1
        served += rt.tick() > 0
    rt.retire_all()
    return {"calls": calls, "served": served}


def _observed(rt) -> tuple:
    snap = rt.telemetry.snapshot(elapsed_s=1.0)
    counts = [(q["completed"], q["dropped"], q["ticks"], q["per_slot_total"],
               q["per_slot_malicious"], q["actions"], q["padded"])
              for q in snap["queues"]]
    return (rt.completed_seq, rt.completed_verdicts, rt.completed_slots,
            rt.dropped_seq, counts, snap["dropped_total"], snap["runtime_ticks"],
            [r.counters.as_dict() for r in rt.rings])


SIZES = [40, 7, 64, 0, 33, 90, 5]     # 90 > 4 x 24 ring rows: tail drops


@pytest.mark.parametrize("fanout", ["loop", "vmap"])
def test_off_changes_nothing_and_stores_nothing(bank, fanout, monkeypatch):
    plain = _runtime(bank, fanout=fanout)
    _drive(plain, _bursts(1, SIZES))

    def no_profiler(name):
        raise AssertionError("a span site called into the profiler while off")

    stopped = _runtime(bank, fanout=fanout)
    stopped.spans.start()
    stopped.spans.stop()
    stopped.spans._range = no_profiler
    monkeypatch.setattr(spans_mod, "_Span", None)   # nothing may build a span
    _drive(stopped, _bursts(1, SIZES))
    assert _observed(stopped) == _observed(plain)
    assert stopped.spans.records == [] and stopped.spans.summary() == {}
    assert plain.spans.records == [] and not plain.spans.on
    assert plain.spans.span("dp.tick") is stopped.spans.span("dp.dispatch")


@pytest.mark.parametrize("fanout", ["loop", "vmap"])
def test_on_covers_the_tree_and_counts_what_was_served(bank, fanout):
    plain = _runtime(bank, fanout=fanout)
    _drive(plain, _bursts(2, SIZES))
    rt = _runtime(bank, fanout=fanout)
    taps = []
    rt.on_retire = lambda q, rows, *rest: taps.append(rows.shape[0])
    rt.spans.start()
    n = _drive(rt, _bursts(2, SIZES))
    rt.spans.stop()
    assert _observed(rt) == _observed(plain)     # on, the verdicts still agree

    s = rt.spans.summary()
    assert set(s) == set(SPAN_NAMES)
    assert rt.spans.overflow == 0
    snap = rt.telemetry.snapshot()
    offered = sum(SIZES)
    completed, dropped = snap["completed_total"], snap["dropped_total"]
    assert completed + dropped == offered and dropped > 0
    assert s["dp.tick"]["count"] == n["calls"]
    assert s["dp.tick.stage"]["count"] == s["dp.tick.h2d"]["count"] \
        == s["dp.tick.launch"]["count"] == s["dp.retire"]["count"] == n["served"]
    assert s["dp.tick.launch"]["queues"] == s["dp.retire.d2h"]["count"]
    assert s["dp.dispatch"]["count"] == len(SIZES)
    assert s["dp.dispatch"]["rows"] == offered
    assert s["dp.dispatch.push"]["admitted"] == completed
    assert s["dp.dispatch.push"]["dropped"] == dropped
    assert s["dp.tick.pop"]["rows"] == s["dp.tick.stage"]["rows"] \
        == s["dp.retire"]["rows"] == completed == sum(taps)
    padded = sum(q["padded"] for q in snap["queues"])
    staged = NUM_QUEUES if fanout == "vmap" else None
    assert s["dp.tick.stage"]["padded"] == padded > 0
    assert s["dp.tick.h2d"]["nbytes"] == (completed + padded) * 272 * 4
    if staged:                      # every queue's batch, every served tick
        assert completed + padded == n["served"] * staged * BATCH
    assert s["dp.retire.tap"]["count"] == len(taps)
    assert s["dp.boundary"]["count"] == len(SIZES) + n["calls"]
    assert s["dp.boundary"]["epochs"] == 0

    # each child's time lies inside its parent's (a span's self time is
    # never negative, and what its children took is its total less its
    # self time); self times add up to the roots' totals
    under = dict.fromkeys(s, 0)
    for name, t0, t1, self_ns, parent, _ in rt.spans.records:
        assert 0 <= self_ns <= t1 - t0, name
        if parent is not None:
            under[parent] += t1 - t0
    for name, v in s.items():
        assert under[name] * 1e-9 == pytest.approx(v["total_s"] - v["self_s"],
                                                   abs=1e-9), name
    roots = sum(v["total_s"] for v in s.values() if v["parent"] is None)
    assert {k for k, v in s.items() if v["parent"] is None} == {"dp.dispatch",
                                                                "dp.tick"}
    assert sum(v["self_s"] for v in s.values()) == pytest.approx(roots, rel=1e-9)


def test_spans_nest_on_the_profiler_timeline(bank):
    rt = _runtime(bank)
    bursts = _bursts(3, [40, 40])
    rt.spans.start()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for rows in bursts:
            with torch.profiler.record_function("bench.dispatch"):
                rt.dispatch(rows)
            with torch.profiler.record_function("bench.tick"):
                rt.tick()
    rt.spans.stop()
    events = [(e.name, e.time_range.start, e.time_range.end)
              for e in prof.events()]
    outer = {n: [(a, b) for m, a, b in events if m == n]
             for n in ("bench.dispatch", "bench.tick")}
    dp = [(n, a, b) for n, a, b in events if n.startswith("dp.")]
    assert {n for n, _, _ in dp} >= {"dp.dispatch", "dp.dispatch.hash",
                                     "dp.dispatch.push", "dp.tick",
                                     "dp.tick.stage", "dp.tick.launch",
                                     "dp.retire.account"}
    for n, a, b in dp:
        enclosing = outer["bench.dispatch" if n.startswith("dp.dispatch")
                          or n == "dp.boundary" else "bench.tick"]
        if n == "dp.boundary":
            enclosing = outer["bench.dispatch"] + outer["bench.tick"]
        assert any(a0 <= a and b <= b0 for a0, b0 in enclosing), n
    # the recorder's own records match the profiler's, name for name
    assert sorted(r[0] for r in rt.spans.records) == sorted(n for n, _, _ in dp)


def test_record_function_serves_where_the_fast_range_is_missing(monkeypatch):
    import torch._C._profiler as cprof

    monkeypatch.delattr(cprof, "_RecordFunctionFast")
    assert spans_mod._profiler_range() is torch.autograd.profiler.record_function
    rec = SpanRecorder()
    rec.start()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with rec.span("dp.tick"):
            with rec.span("dp.tick.pop") as s:
                s.count(rows=3)
    rec.stop()
    assert {"dp.tick", "dp.tick.pop"} <= {e.name for e in prof.events()}
    assert rec.summary()["dp.tick.pop"]["rows"] == 3


def test_recorder_times_nesting_and_overflow():
    rec = SpanRecorder()
    rec.capacity = 5
    with rec.span("dp.tick") as s:
        s.count(rows=1)                              # off: nothing kept
    assert rec.records == [] and rec.overflow == 0
    rec.start()
    with rec.span("dp.tick") as top:
        with rec.span("dp.tick.pop") as s:
            time.sleep(0.002)
            s.count(rows=2)
            s.count(rows=3, padded=1)
        with rec.span("dp.tick.stage"):
            time.sleep(0.001)
        top.count(queues=4)
    s = rec.summary()
    assert s["dp.tick.pop"] == pytest.approx(
        {"count": 1, "total_s": s["dp.tick.pop"]["total_s"],
         "self_s": s["dp.tick.pop"]["total_s"], "parent": "dp.tick",
         "rows": 5, "padded": 1})
    assert s["dp.tick.pop"]["total_s"] >= 0.002
    children = s["dp.tick.pop"]["total_s"] + s["dp.tick.stage"]["total_s"]
    assert s["dp.tick"]["self_s"] == pytest.approx(
        s["dp.tick"]["total_s"] - children, abs=1e-9)
    assert s["dp.tick"]["queues"] == 4 and s["dp.tick"]["parent"] is None
    for _ in range(4):
        with rec.span("dp.retire"):
            pass
    assert len(rec.records) == 5 and rec.overflow == 2
    assert rec.summary()["dp.retire"]["count"] == 2
    rec.stop()
    with rec.span("dp.retire"):
        pass
    assert rec.overflow == 2
    rec.start()                                      # start clears
    assert rec.records == [] and rec.overflow == 0 and rec.on


def test_wait_and_padded_follow_the_ring_and_the_batch(bank):
    rt = _runtime(bank, ring_capacity=64)
    rows = _bursts(4, [50])[0]
    back = time.perf_counter() - 1.0                 # enqueued a second ago
    rt.dispatch(rows, now=back)
    _drive(rt, [])
    snap = rt.telemetry.snapshot()
    for q in snap["queues"]:
        n = q["completed"]
        assert n * 1.0 <= q["wait_s"] < n * 30.0
        assert q["padded"] == -n % BATCH          # the last batch's padding
    assert sum(q["completed"] for q in snap["queues"]) == 50


def test_counters_survive_snapshot_bulk_and_merge():
    a, b = telemetry.Telemetry(2, 2), telemetry.Telemetry(1, 2)
    a.record_tick(0, np.array([0, 1]), np.array([True, False]), np.array([0, 1]),
                  latency_us=np.array([5.0, 9.0]), tick_s=0.1, wait_s=0.25,
                  padded=6)
    a.record_tick(0, np.array([1]), np.array([True]), np.array([2]),
                  latency_us=np.array([3.0]), tick_s=0.1, wait_s=0.5, padded=7)
    a.record_window(1, ticks=3, completed=4, per_slot_total=[2, 2],
                    per_slot_malicious=[1, 0], actions=[4, 0, 0],
                    latency_us=np.ones(4), busy_s=0.2, wait_s=1.5, padded=2)
    b.record_window(0, ticks=1, completed=1, per_slot_total=[1, 0],
                    per_slot_malicious=[0, 0], actions=[1, 0, 0],
                    latency_us=np.ones(1), busy_s=0.1)
    snap = a.snapshot()["queues"]
    assert [(q["wait_s"], q["padded"]) for q in snap] == [(0.75, 13), (1.5, 2)]
    merged = telemetry.merge([a, b]).snapshot()["queues"]
    assert [(q["wait_s"], q["padded"]) for q in merged] == \
        [(0.75, 13), (1.5, 2), (0.0, 0)]
    a.queues[0].padded += 1                          # merge made a deep copy
    assert telemetry.merge([a]).queues[0].padded == 14
    assert merged[0]["padded"] == 13


def test_megastep_window_carries_the_ring_wait(bank):
    rt = _runtime(bank, num_queues=2, ring_capacity=256, megastep_ticks=2)
    assert rt._mega is not None
    rows = _bursts(5, [30])[0]
    rt.dispatch(rows, now=time.perf_counter() - 1.0)
    _drive(rt, [])
    snap = rt.telemetry.snapshot()["queues"]
    assert sum(q["completed"] for q in snap) == 30
    for q in snap:
        assert q["completed"] * 1.0 <= q["wait_s"] < q["completed"] * 30.0
        assert q["padded"] == 0
