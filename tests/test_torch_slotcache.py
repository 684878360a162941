"""The port's ``SlotCache`` (LRU residency over the device slots) and
``SlotMixPrefetcher`` against the JAX reference: LRU order, pinning,
prefetch promotion, the prefetcher's predictions, and fixed interleavings
of traffic with cache churn, where committing by flip must equal committing
by re-stage and the port must equal the reference."""

import types

import jax
import numpy as np
import pytest

from _torch_parity import CPU, one_torch_thread  # noqa: F401
from repro import control as jcontrol
from repro.core import executor as jexecutor
from repro.dataplane import DataplaneRuntime as JRuntime
from repro_torch import control as tcontrol
from repro_torch.core import bank as tbank
from repro_torch.core import packet as tpkt
from repro_torch.dataplane import DataplaneRuntime

CFG = jexecutor.BNNConfig(hidden=16)  # full 256-word payloads, narrow hidden layer

PORT = types.SimpleNamespace(Runtime=DataplaneRuntime, control=tcontrol,
                             kw=dict(device="cpu"))
REF = types.SimpleNamespace(Runtime=JRuntime, control=jcontrol, kw={})


@pytest.fixture(scope="module")
def jbank4():
    return jexecutor.init_bank(jax.random.PRNGKey(0), 4, CFG)


@pytest.fixture(scope="module")
def params_pool():
    """Six models as numpy arrays (``w1p`` uint32), registrable in both."""
    return [{k: np.asarray(v) for k, v in jexecutor.init_params(
        jax.random.PRNGKey(100 + i), CFG).items()} for i in range(6)]


def _bank(pkg, jbank):
    if pkg is REF:
        return jbank
    return tbank.from_jax_bank({k: np.asarray(v) for k, v in jbank.items()}, CPU)


def _cache_rt(pkg, jbank, params_pool, n_models, num_slots=2, **kw):
    bank = {k: v[:num_slots] for k, v in jbank.items()}
    rt = pkg.Runtime(_bank(pkg, bank), num_queues=2, strategy="take",
                     batch=32, **pkg.kw, **kw)
    cache = pkg.control.SlotCache(rt)
    for i in range(n_models):
        cache.register(f"m{i}", params_pool[i])
    return rt, cache


def test_cache_lru_eviction_order(jbank4, params_pool):
    rt, cache = _cache_rt(PORT, jbank4, params_pool, 4)
    s0, s1 = cache.ensure("m0"), cache.ensure("m1")
    assert {s0, s1} == {0, 1} and cache.misses == 2
    assert cache.ensure("m0") == s0 and cache.hits == 1
    # m1 is now least-recently used -> m2 takes its slot
    assert cache.ensure("m2") == s1
    assert not cache.is_resident("m1") and cache.evictions == 1
    rt.flush_control()
    aud = rt.audit_conservation()
    assert aud["ok"] and aud["wrong_verdict"] == 0
    for name, leaf in rt.bank.items():
        np.testing.assert_array_equal(
            leaf[s1].numpy(), params_pool[2][name].view(leaf.numpy().dtype))


def test_evict_pinned_slot_rejected(jbank4, params_pool):
    _, cache = _cache_rt(PORT, jbank4, params_pool, 4)
    cache.ensure("m0")
    cache.ensure("m1")
    cache.pin("m0")
    with pytest.raises(tcontrol.CacheError):
        cache.evict("m0")
    cache.pin("m1")
    with pytest.raises(tcontrol.CacheError):   # miss with every slot pinned
        cache.ensure("m2")
    cache.unpin("m1")
    assert cache.ensure("m2") == 1             # m1's slot, the only evictable one
    cache.unpin("m0")
    assert cache.evict("m0") == 0
    with pytest.raises(tcontrol.CacheError):
        cache.evict("m0")                      # no longer resident
    with pytest.raises(KeyError):
        cache.ensure("nope")


def test_prefetch_promotes_to_flip_only_miss(jbank4, params_pool):
    rt, cache = _cache_rt(PORT, jbank4, params_pool, 4)
    cache.ensure("m0")
    cache.ensure("m1")
    rt.flush_control()                      # commit the fills; shadow free
    assert cache.prefetch("m2") is True     # staged into the shadow
    reserved_slot = cache._prefetched["m2"][0]
    stages = rt._bankbuf.stages
    assert cache.ensure("m2") == reserved_slot
    assert cache.prefetch_hits == 1
    rt.flush_control()
    assert rt._bankbuf.stages == stages     # the commit was flip-only
    for name, leaf in rt.bank.items():
        assert (leaf[reserved_slot] == cache._models["m2"][name]).all()


def test_register_rejects_a_model_that_does_not_fit(jbank4, params_pool):
    _, cache = _cache_rt(PORT, jbank4, params_pool, 1)
    with pytest.raises(ValueError):
        cache.register("bad", dict(params_pool[0], b1=np.zeros(3, np.float32)))


class _ListStream:
    """A telemetry delta stream: events appended by the runtime's sink,
    read with ``tail(cursor)``."""

    def __init__(self):
        self.events = []

    def tail(self, cursor):
        return self.events[cursor:], len(self.events)


@pytest.mark.parametrize("with_stream", [False, True])
def test_prefetcher_matches_reference(jbank4, params_pool, with_stream):
    issued = {}
    for pkg in (PORT, REF):
        rt, cache = _cache_rt(pkg, jbank4, params_pool, 3)
        stream = _ListStream() if with_stream else None
        if stream is not None:
            rt.telemetry.attach_sink(stream.events.append)
        pf = pkg.control.SlotMixPrefetcher(cache, stream, horizon=8)
        rng = np.random.default_rng(4)
        for m in ("m0", "m1", "m2", "m0", "m1", "m2", "m0"):
            cache.ensure(m)
            burst = tpkt.make_packets(
                rng.integers(0, 2, 16),
                rng.integers(0, 2**32, (16, tpkt.PAYLOAD_WORDS), dtype=np.uint32))
            rt.dispatch(burst)
            rt.drain()
        out = pf.poll()
        issued[pkg is PORT] = (out, pf.issued, cache.stats())
    assert issued[True] == issued[False]
    assert issued[True][0] and issued[True][0][0] in ("m1", "m2")


# ---------------------------------------------------------------------------
# fixed interleavings: flip == re-stage, port == reference
# ---------------------------------------------------------------------------

_OPS = ("dispatch", "tick", "ensure", "prefetch", "pinflip")


def _drive(pkg, ops, seed, jbank, params_pool, double_buffer):
    rng = np.random.default_rng(seed)
    rt = pkg.Runtime(_bank(pkg, jbank), num_queues=2, strategy="take",
                     batch=32, ring_capacity=4096, record=True, audit=True,
                     double_buffer=double_buffer, **pkg.kw)
    cache = pkg.control.SlotCache(rt)
    names = [f"m{i}" for i in range(len(params_pool))]
    for n, p in zip(names, params_pool):
        cache.register(n, p)
    pinned = None
    for op in ops:
        if op == "dispatch":
            burst = tpkt.make_packets(
                rng.integers(0, 4, 16),
                rng.integers(0, 2**32, (16, tpkt.PAYLOAD_WORDS), dtype=np.uint32))
            rt.dispatch(burst)
        elif op == "tick":
            rt.tick()
        elif op == "ensure":
            try:
                cache.ensure(names[rng.integers(len(names))])
            except pkg.control.CacheError:
                pass                      # every slot pinned: rejected
        elif op == "prefetch":
            cache.prefetch(names[rng.integers(len(names))])
        elif op == "pinflip":
            m = names[rng.integers(len(names))]
            if pinned == m:
                cache.unpin(m)
                pinned = None
            elif pinned is None and cache.is_resident(m):
                cache.pin(m)
                pinned = m
    rt.drain()
    aud = rt.audit_conservation()
    assert aud["ok"] and aud["wrong_verdict"] == 0, aud
    stats = cache.stats()
    # prefetch_hits counts actual shadow staging, which only the
    # double-buffered stack has; everything packet-observable must match
    stats.pop("prefetch_hits")
    return (rt.completed_seq, rt.completed_verdicts, rt.completed_slots,
            [cache.model_at(i) for i in range(rt.num_slots)], stats)


@pytest.mark.parametrize("seed", range(8))
def test_cache_interleaving_flip_equals_restage(jbank4, params_pool, seed):
    """A fixed interleaving of traffic with cache hits, misses, evictions,
    prefetches and pin churn scores every packet identically whether swaps
    commit by flip or by re-stage, with no wrong verdict, and as the
    reference does."""
    ops_rng = np.random.default_rng(1000 + seed)
    ops = list(ops_rng.choice(_OPS, int(ops_rng.integers(8, 24))))
    flip = _drive(PORT, ops, seed, jbank4, params_pool, double_buffer=True)
    restage = _drive(PORT, ops, seed, jbank4, params_pool, double_buffer=False)
    assert flip == restage
    assert flip == _drive(REF, ops, seed, jbank4, params_pool, double_buffer=True)
    assert sum(len(s) for s in flip[0]) > 0
