"""The port's megastep (deferred mode) against the port's own sequential
ticks and against the JAX reference's megastep: a window of N ticks served
by one fused launch must be observationally identical to N sequential
``tick()`` calls (completion streams, counting telemetry, epoch apply
ticks), including mid-window SwapSlot / ProgramReta epochs and rolled-back
epochs; configurations that need per-tick host control keep the sequential
loop; and the device rings match the reference's jnp rings step by step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU, one_torch_thread  # noqa: F401
from repro.control import ProgramReta as JProgramReta, SwapSlot as JSwapSlot
from repro.core import executor as jexecutor
from repro.dataplane import DataplaneRuntime as JRuntime
from repro.dataplane import ring as jring
from repro_torch.control import FailQueues, ProgramReta, SwapSlot
from repro_torch.core import bank as tbank, packet as pkt
from repro_torch.dataplane import (DataplaneRuntime, FaultInjector, FaultPlan,
                                   StallHost, ring as tring, workloads)
from repro_torch.dataplane import megastep
from repro_torch.dataplane.workloads.phases import SEQ_WORD
from repro_torch.kernels import fused_forward as ff

NUM_QUEUES = 2
NUM_SLOTS = 2
BATCH = 8
RING = 256
# Full 256-word payloads (the packets' fixed layout), narrow hidden layer.
CFG = jexecutor.BNNConfig(hidden=16)


@pytest.fixture(scope="module")
def banks():
    jb = jexecutor.init_bank(jax.random.PRNGKey(0), NUM_SLOTS, CFG)
    return jb, tbank.from_jax_bank({k: np.asarray(v) for k, v in jb.items()}, CPU)


def _jax_params(seed: int):
    return jexecutor.init_params(jax.random.PRNGKey(seed), CFG)


def _port_params(seed: int):
    return {k: np.asarray(v) for k, v in _jax_params(seed).items()}


def _make_bursts(seed: int, sizes: list[int]) -> list[np.ndarray]:
    """Per-tick bursts over a tiny payload pool: repeated payloads with
    per-packet word-0 twists, and a few fully unique payloads."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 2**32, (3, pkt.PAYLOAD_WORDS), dtype=np.uint32)
    seq = 0
    bursts = []
    for n in sizes:
        payload = pool[rng.integers(0, pool.shape[0], n)].copy()
        payload[:, 0] ^= rng.integers(0, 2**32, n, dtype=np.uint32)
        unique = rng.random(n) < 0.2
        payload[unique] = rng.integers(
            0, 2**32, (int(unique.sum()), pkt.PAYLOAD_WORDS), dtype=np.uint32)
        rows = pkt.make_packets(
            rng.integers(0, NUM_SLOTS, n).astype(np.int32), payload)
        rows[:, pkt.CONTROL_WORD_LO] = rng.integers(0, 2, n).astype(np.uint32)
        rows[:, SEQ_WORD] = np.arange(seq, seq + n, dtype=np.uint32)
        seq += n
        bursts.append(rows)
    return bursts


def _drive(bank, bursts, epochs, megastep_ticks, *, audit=True,
           fault_injector=None, strategy="fused", backend="auto",
           on_retire=None, runtime=DataplaneRuntime, catch_at=None):
    """Submit each tick's epochs, dispatch its burst and tick; drain.  At
    tick ``catch_at`` the dispatch's epoch apply must raise ``ValueError``
    (a rolled-back epoch), and the burst is dispatched again after it."""
    kw = {} if runtime is JRuntime else dict(device="cpu")
    rt = runtime(
        bank, num_queues=NUM_QUEUES, strategy=strategy, batch=BATCH,
        ring_capacity=RING, audit=audit, record=True, backend=backend,
        megastep_ticks=megastep_ticks, fault_injector=fault_injector, **kw)
    rt.on_retire = on_retire
    for t, burst in enumerate(bursts):
        if t in epochs:  # one epoch per tick
            rt.control.submit(*epochs[t])
        if t == catch_at:
            with pytest.raises(ValueError):
                rt.dispatch(burst)
            if rt._mega is not None:
                assert rt._mega._deltas == []  # the rolled-back swap is gone
        rt.dispatch(burst)
        rt.tick()
    rt.drain()
    return rt


def _observed(rt) -> tuple:
    """Everything the contract covers, as one comparable value: per-queue
    completion streams, counting telemetry, epoch apply ticks.  (Wall-clock
    fields, busy_s and latency, are excluded.)"""
    queues = []
    for q, qs in enumerate(rt.snapshot()["queues"]):
        queues.append((
            tuple(rt.completed_seq[q]),
            tuple(rt.completed_verdicts[q]),
            tuple(rt.completed_slots[q]),
            qs["completed"], qs["dropped"],
            tuple(qs["per_slot_total"]), tuple(qs["per_slot_malicious"]),
            tuple(sorted(qs["actions"].items())),
        ))
    epochs = tuple((r.applied_tick, type(r.commands[0]).__name__)
                   for r in rt.control.log if r.applied)
    return (tuple(queues), epochs, rt.telemetry.slot_swaps,
            rt.telemetry.reta_updates)


def _epochs(seed, swap_at, reta_at, swap=SwapSlot, reta=ProgramReta,
            params=_port_params):
    out = {swap_at: [swap(swap_at % NUM_SLOTS, params(seed))]}
    out.setdefault(reta_at, []).append(
        reta(tuple(int(x) for x in (np.arange(16) + reta_at) % NUM_QUEUES)))
    return out


CASES = [  # seed, burst sizes, swap tick, RETA tick
    (0, [5, 20, 0, 24, 7, 13, 24, 24, 3], 2, 4),
    (1, [24, 24, 24, 24, 1, 0, 0, 17], 5, 5),
    (2, [3, 11, 19, 24, 24, 2, 9, 24, 24, 6], 0, 7),
]


@pytest.mark.parametrize("window", [2, 3, 8])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_megastep_equals_sequential(banks, window, case):
    """megastep(n) == n sequential ticks, bit for bit, with SwapSlot and
    ProgramReta epochs landing mid-window (both runs audited)."""
    _, tb = banks
    seed, sizes, swap_at, reta_at = CASES[case]
    bursts = _make_bursts(seed, sizes)
    epochs = _epochs(seed, swap_at, reta_at)
    rt_seq = _drive(tb, bursts, epochs, 1)
    rt_meg = _drive(tb, bursts, epochs, window)
    assert rt_seq._mega is None and rt_meg._mega is not None
    assert _observed(rt_seq) == _observed(rt_meg)
    assert rt_seq.telemetry.wrong_verdict == rt_meg.telemetry.wrong_verdict == 0
    assert rt_seq.audit_conservation()["ok"] and rt_meg.audit_conservation()["ok"]


def test_rolled_back_epoch_never_reaches_the_window(banks):
    """[SwapSlot, FailQueues(every queue)]: the apply raises and rolls back;
    the swap's delta is dropped, and both runs serve the old slot."""
    _, tb = banks
    bursts = _make_bursts(5, [16, 24, 24, 9, 24, 4])
    epochs = {2: [SwapSlot(0, _port_params(9)),
                  FailQueues(tuple(range(NUM_QUEUES)))]}
    rt_seq = _drive(tb, bursts, epochs, 1, catch_at=2)
    rt_meg = _drive(tb, bursts, epochs, 8, catch_at=2)
    assert _observed(rt_seq) == _observed(rt_meg)
    assert rt_meg.telemetry.slot_swaps == 0
    assert [r.commit_mode for r in rt_meg.control.log] == ["rollback"]
    assert rt_meg.telemetry.wrong_verdict == 0
    assert rt_meg.audit_conservation()["ok"]


def test_engine_eligibility_and_fallbacks(banks):
    """The window runs for the fused strategy on the ``cuda`` (here its
    plain version on CPU tensors) and ``ref`` backends with no fault
    injector; a fault injector, another strategy or ``mxu`` keep the
    sequential loop, and the audits pass either way."""
    _, tb = banks
    bursts = _make_bursts(7, [16] * 8)
    plan = FaultPlan(faults=(StallHost(0, 2, 2),))
    for kw in (dict(fault_injector=FaultInjector(plan)),
               dict(strategy="take"), dict(backend="mxu")):
        rt = _drive(tb, bursts, {}, 8, **kw)
        assert rt._mega is None, kw
        assert rt.telemetry.wrong_verdict == 0 and rt.audit_conservation()["ok"]
    stalled = _drive(tb, bursts, {}, 8, fault_injector=FaultInjector(plan))
    meg = _drive(tb, bursts, {}, 8)
    for q in range(NUM_QUEUES):  # the stall only delays, never drops
        assert sorted(stalled.completed_seq[q]) == sorted(meg.completed_seq[q])
    seq = _drive(tb, bursts, {}, 1)
    for backend in ("cuda", "ref"):
        rt = _drive(tb, bursts, {}, 8, backend=backend)
        assert rt._mega is not None
        assert _observed(rt) == _observed(seq)
    with pytest.raises(ValueError, match="megastep_ticks"):
        DataplaneRuntime(tb, num_queues=2, megastep_ticks=0, device="cpu")


def test_window_launch_count_and_conservation_mid_window(banks, monkeypatch):
    """Rows staged and not flushed count as in flight; the flush serves
    the whole window through one ``packet_forward_fused`` call (its plain
    version here), and CPU tensors launch no kernel."""
    _, tb = banks
    calls = []
    real = megastep.ops.packet_forward_fused

    def spy(*args, **kw):
        calls.append((args[1].shape, kw["tag"]))
        return real(*args, **kw)

    rt = DataplaneRuntime(tb, num_queues=NUM_QUEUES, batch=BATCH,
                          ring_capacity=RING, audit=True, megastep_ticks=8,
                          device="cpu")
    launches = sum(ff.fused_forward.launches.values())
    monkeypatch.setattr(megastep.ops, "packet_forward_fused", spy)
    for burst in _make_bursts(3, [24, 24, 24, 24]):
        rt.dispatch(burst)
        rt.tick()
    aud = rt.audit_conservation()
    staged = rt._mega.staged_rows()
    assert aud["ok"] and sum(staged) == aud["totals"]["in_flight"] > 0
    assert aud["totals"]["completed"] == 0 and calls == []
    rt.retire_all()
    assert len(calls) == 1 and calls[0][1] == megastep.WINDOW_TAG
    assert calls[0][0][0] == 8 * 32  # one (T_pad * width, 272) slab
    aud = rt.audit_conservation()
    assert aud["ok"] and aud["totals"]["in_flight"] == 0
    assert aud["totals"]["completed"] == sum(staged)
    assert sum(ff.fused_forward.launches.values()) == launches


def test_on_retire_receives_what_sequential_mode_gives(banks):
    _, tb = banks
    bursts = _make_bursts(4, [24, 24, 3, 24, 24, 0, 24])
    epochs = _epochs(4, 3, 5)
    taps = {}
    for window in (1, 8):
        got = taps[window] = []
        _drive(tb, bursts, epochs, window,
               on_retire=lambda *a, got=got: got.append(a))
    assert len(taps[1]) == len(taps[8]) > 0
    for a, b in zip(taps[1], taps[8]):
        assert a[0] == b[0] and a[5] == b[5]  # queue, tick
        for x, y in zip(a[1:5], b[1:5]):    # rows, slots, verdicts, actions
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def test_window_matches_the_reference_window(banks):
    """The port's window against the reference's megastep (JAX on the CPU,
    ``ref`` backend, ``megastep_ticks=8``) on the same bursts, epochs and
    bank: completion streams, counters and epoch ticks are equal."""
    jb, tb = banks
    seed, sizes, swap_at, reta_at = CASES[0]
    bursts = _make_bursts(seed, sizes)
    ref = _drive(jb, bursts, _epochs(seed, swap_at, reta_at, JSwapSlot,
                                     JProgramReta, _jax_params), 8,
                 runtime=JRuntime)
    ours = _drive(tb, bursts, _epochs(seed, swap_at, reta_at), 8)
    assert ref._mega is not None and ours._mega is not None
    assert _observed(ours) == _observed(ref)
    assert ours.telemetry.wrong_verdict == ref.telemetry.wrong_verdict == 0


@pytest.mark.parametrize("which", ["slot-thrash", "chaos-queue-surge"])
def test_recorded_trace_replays_on_a_megastep_runtime(banks, tmp_path, which):
    """A trace recorded on the sequential loop replays on
    ``make_runtime(trace, megastep_ticks=8)`` with the recorded digest
    (``slot-thrash`` puts an epoch inside every window)."""
    _, tb = banks
    path = str(tmp_path / "t.bswt")
    rt = DataplaneRuntime(tb, num_queues=3, batch=64, ring_capacity=256,
                          record=True, device="cpu")
    rec = workloads.record(rt, path=path)
    phases = workloads.make_workload(which, num_slots=2, num_queues=3).phases
    delivery = lambda slot: _port_params(10_000 + slot)  # noqa: E731
    workloads.play(rec, workloads.render(list(phases), num_slots=2, seed=11,
                                         num_queues=3), swap_delivery=delivery)
    rec.finish(name=which, seed=11)
    loaded = workloads.load(path)
    rt2 = workloads.make_runtime(loaded, audit=True, device="cpu",
                                 megastep_ticks=8)
    assert rt2._mega is not None
    rep = workloads.replay(loaded, rt2, swap_delivery=delivery)
    assert rep["ok"], rep["mismatches"]
    assert rep["digest_ok"] is True
    assert rt2.completed_seq == rt.completed_seq
    assert rt2.telemetry.wrong_verdict == 0
    assert rt2.control.continuity_audit()["ok"]


# ---------------------------------------------------------------------------
# device rings against the reference's jnp rings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_device_rings_match_reference(seed):
    """Random push/pop sequences over 3 rings of capacity 8: tail drops,
    wrap-around, bursts shorter than their padded capacity (``count`` <
    ``bmax``) and steps that pop nothing (batch 0)."""
    rng = np.random.default_rng(seed)
    nq, cap, words, width = 3, 8, 5, 32
    ours = tring.device_rings(nq, cap, packet_words=words, device=CPU)
    theirs = jring.device_rings(nq, cap, packet_words=words)
    dropped = wrapped = 0
    for step in range(14):
        bmax = int(rng.choice([0, 8, 24]))
        rows = rng.integers(0, 2**32, (bmax, words), dtype=np.uint32)
        qids = rng.integers(0, nq, bmax).astype(np.int32)
        count = int(rng.integers(0, bmax + 1)) if bmax else 0
        if bmax:
            offered = np.bincount(qids[:count], minlength=nq)
            free = cap - ours["size"].numpy()
            dropped += int(np.maximum(offered - free, 0).sum())
            wrapped += int(((ours["head"].numpy() + ours["size"].numpy()
                             + np.minimum(offered, free)) > cap).sum())
            ours = tring.device_push(ours, pkt.to_device(rows, CPU),
                                     torch.from_numpy(qids), count,
                                     capacity=cap)
            theirs = jring.device_push(theirs, jnp.asarray(rows),
                                       jnp.asarray(qids), count, capacity=cap)
        batch = int(rng.choice([0, 3, 8])) if step % 3 else 0
        ours, p, qq, pv, n = tring.device_pop(ours, batch, width, capacity=cap)
        theirs, jp, jqq, jpv, jn = jring.device_pop(theirs, batch, width,
                                                    capacity=cap)
        np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
        np.testing.assert_array_equal(pv.numpy(), np.asarray(jpv))
        np.testing.assert_array_equal(qq.numpy(), np.asarray(jqq))
        valid = pv.numpy()
        np.testing.assert_array_equal(p.numpy().view(np.uint32)[valid],
                                      np.asarray(jp)[valid])
        for key in ("head", "size"):
            np.testing.assert_array_equal(ours[key].numpy(),
                                          np.asarray(theirs[key]))
        # every ring slot (not the sink row) holds the reference's words
        np.testing.assert_array_equal(
            ours["buf"][:nq * cap].numpy().view(np.uint32),
            np.asarray(theirs["buf"]))
    assert dropped > 0 and wrapped > 0  # tail drops and wrap-around happened


def test_megastep_batched_retires_respect_sampler_and_stream_bounds(banks):
    """Whole-megastep drains hand the deploy/obs taps a window's worth of
    retires back to back: ``PacketSampler.max_pending`` must still bound
    the labeling backlog, and ``TelemetryStream`` overflow accounting
    must stay conserved (``next_sid == buffered + dropped_events``)."""
    from repro_torch import deploy
    from repro_torch.obs import TelemetryStream, attach

    _, tb = banks
    pool, labels = deploy.labeled_pool(samples_per_group=64, seed=0)
    oracle = deploy.LabelOracle(pool, labels)
    rt = DataplaneRuntime(tb, num_queues=NUM_QUEUES, strategy="fused",
                          batch=16, ring_capacity=1024, megastep_ticks=8,
                          device="cpu")
    assert rt._mega is not None
    max_pending = 3
    sampler = deploy.PacketSampler(oracle, num_slots=NUM_SLOTS, per_tick=8,
                                   max_pending=max_pending).attach(rt)
    stream = TelemetryStream(capacity=4)  # tiny: force real overflow
    attach(rt, stream)
    flush_sizes = []
    orig_flush = sampler.flush
    sampler.flush = lambda: (flush_sizes.append(len(sampler._pending)),
                             orig_flush())[-1]
    rng = np.random.default_rng(0)
    peak = 0
    for _ in range(40):
        idx = rng.integers(0, pool.shape[0], 48)
        rt.dispatch(pkt.make_packets(
            rng.integers(0, NUM_SLOTS, 48).astype(np.int32), pool[idx]))
        rt.tick()
        peak = max(peak, len(sampler._pending))
    rt.drain()
    peak = max(peak, len(sampler._pending))
    sampler.detach()  # final flush
    completed = rt.snapshot()["completed_total"]
    assert completed > 0
    assert sampler.seen == completed
    # the backlog bound held across every batched retire burst
    assert peak <= max_pending
    assert max(flush_sizes, default=0) <= max_pending
    assert sampler.labeled + sampler.unknown == sampler.sampled
    # stream conservation: every event is either retained or counted out
    s = stream.snapshot_stats()
    assert s["next_sid"] == s["buffered"] + s["dropped_events"]
    assert s["dropped_events"] > 0  # the tiny ring really overflowed
