"""The port's continuous deployment (``repro_torch.deploy``) against the JAX
reference's (``repro.deploy``): the sampler on the same taps, the trainer
from a shared warm latent, the canary and the auto-remediator with the same
trained params in both packages (equal deploy logs and epoch logs), the
reference's own cases on the port, and recorded deploy runs replaying with
an equal digest in both packages."""

import functools
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU, banks as parity_banks, one_torch_thread, untimed_doc  # noqa: F401
from repro import deploy as jdeploy
from repro.checkpoint import store as jstore
from repro.core import bank as jbank_lib
from repro.core import executor as jexecutor
from repro.dataplane import DataplaneRuntime as JRuntime
from repro.dataplane import MeshDataplane as JMesh
from repro.dataplane import workloads as jworkloads
from repro.obs import AnomalyDetector as JDetector
from repro.obs import TelemetryStream as JStream
from repro.obs import attach as jattach
from repro.obs import spans as jspans
from repro_torch import deploy, obs
from repro_torch.checkpoint import store
from repro_torch.core import bank as bank_lib
from repro_torch.core import executor
from repro_torch.core import packet as pkt
from repro_torch.dataplane import DataplaneRuntime, MeshDataplane, workloads
from repro_torch.obs import AnomalyDetector, TelemetryStream, spans
from repro_torch.obs.server import _json_default


@pytest.fixture(scope="module")
def banks():
    return parity_banks(2)


@functools.lru_cache(maxsize=1)
def _pool():
    return deploy.labeled_pool(samples_per_group=96, seed=0)


@pytest.fixture(scope="module")
def corpus():
    pool, labels = _pool()
    return pool, labels, deploy.LabelOracle(pool, labels)


def _to_port(params) -> dict:
    return bank_lib.from_jax_bank({k: np.asarray(v) for k, v in params.items()}, CPU)


@pytest.fixture(scope="module")
def jtrained(corpus):
    """The reference trainer's fine-tune of the pool (its test's fixture)."""
    pool, labels, _ = corpus
    return jdeploy.OnlineTrainer(steps=24, seed=0).fine_tune(pool, labels)


@pytest.fixture(scope="module")
def trained(jtrained):
    """The same trained slot in each package: {"jax": ..., "torch": ...}."""
    return {"jax": jtrained.params, "torch": _to_port(jtrained.params)}


@functools.lru_cache(maxsize=None)
def _jax_delivery(slot):
    return jexecutor.init_params(jax.random.PRNGKey(10_000 + slot))


def _port_delivery(slot):
    return _to_port(_jax_delivery(slot))


#: Each package's entry points, so one scenario runs in both.
PKG = {
    "jax": types.SimpleNamespace(
        runtime=JRuntime, mesh=JMesh, deploy=jdeploy, bank_lib=jbank_lib,
        workloads=jworkloads, stream=JStream, detector=JDetector,
        attach=jattach, spans=jspans, delivery=_jax_delivery, kw={}),
    "torch": types.SimpleNamespace(
        runtime=DataplaneRuntime, mesh=MeshDataplane, deploy=deploy,
        bank_lib=bank_lib, workloads=workloads, stream=TelemetryStream,
        detector=AnomalyDetector, attach=obs.attach, spans=spans,
        delivery=_port_delivery, kw=dict(device="cpu")),
}


def _bank(banks, name):
    return banks[0] if name == "jax" else banks[1]


@functools.lru_cache(maxsize=None)
def _rendered(name, regime, seed=0, queues=2):
    pool, _labels = _pool()
    wl = PKG[name].workloads
    w = wl.make_workload(regime, num_slots=2, num_queues=queues)
    return wl.render(list(w.phases), num_slots=2, seed=seed,
                     num_queues=queues, payload_pool=pool)


def _drive(driver, pool, rng, ticks, *, controller=None, n=192):
    """Feed pool-payload packets through dispatch/tick for ``ticks``."""
    for _ in range(ticks):
        idx = rng.integers(0, pool.shape[0], n)
        pkts = pkt.make_packets(rng.integers(0, 2, n), pool[idx])
        driver.dispatch(pkts)
        driver.tick()
        if controller is not None:
            controller.step()


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _tree_equal(a, b) -> bool:
    """Equal leaves by bits, whatever package holds each tree."""
    if set(a) != set(b):
        return False
    for k in a:
        x, y = _host(a[k]), _host(b[k])
        if x.shape != y.shape or x.tobytes() != y.tobytes():
            return False
    return True


def _trail(log) -> list:
    """A deploy log's decision trail: what happened, when, in which epoch."""
    return [(d["event"], d["tick"], d.get("epoch"), d.get("slot"))
            for d in log]


def _commands(rt) -> list:
    return untimed_doc(rt.control.command_log())


# ---------------------------------------------------------------------------
# runtime taps and the sampler
# ---------------------------------------------------------------------------

def test_exports_match_reference():
    assert deploy.__all__ == jdeploy.__all__
    assert all(hasattr(deploy, name) for name in deploy.__all__)
    for name in ("AnomalyDetector", "TelemetryStream", "attach", "detach",
                 "epoch_event", "epoch_log_doc", "health_event"):
        assert hasattr(obs, name), name


def test_runtime_taps_account_for_every_row(banks):
    rng = np.random.default_rng(0)
    rt = DataplaneRuntime(banks[1], num_queues=2, batch=64, ring_capacity=128,
                          device="cpu")
    retired, dropped = [], []
    rt.on_retire = lambda q, rows, s, v, a, t: retired.append(rows.shape[0])
    rt.on_drop = lambda q, rows: dropped.append(rows.shape[0])
    pool, _ = _pool()
    for _ in range(6):  # tiny rings: tail drops exercised too
        idx = rng.integers(0, pool.shape[0], 300)
        rt.dispatch(pkt.make_packets(rng.integers(0, 2, 300), pool[idx]))
        rt.tick()
    rt.drain()
    snap = rt.telemetry.snapshot()
    assert sum(retired) == snap["completed_total"] > 0
    assert sum(dropped) == snap["dropped_total"] > 0


def test_label_oracle_matches_reference(corpus):
    pool, labels, oracle = corpus
    jpool, jlabels = jdeploy.labeled_pool(samples_per_group=96, seed=0)
    np.testing.assert_array_equal(pool, jpool)
    np.testing.assert_array_equal(labels, jlabels)
    joracle = jdeploy.LabelOracle(jpool, jlabels)
    assert len(oracle) == len(joracle) == pool.shape[0]
    twisted = pool.copy()
    twisted[:, 0] ^= np.arange(pool.shape[0], dtype=np.uint32) * 2654435761
    got = oracle.lookup(twisted[:64])
    np.testing.assert_array_equal(got, labels[:64])
    unknown = np.random.default_rng(0).integers(0, 2**32, (4, 256), dtype=np.uint32)
    assert (oracle.lookup(unknown) == -1).all()
    mixed = np.concatenate([twisted, unknown])
    np.testing.assert_array_equal(oracle.lookup(mixed), joracle.lookup(mixed))


def test_reservoir_matches_reference():
    ours = deploy.Reservoir(64, 4, np.random.default_rng(0))
    ref = jdeploy.Reservoir(64, 4, np.random.default_rng(0))
    for i in range(10):
        words = np.full((100, 4), i, np.uint32)
        words[:, 1] = np.arange(100)
        for r in (ours, ref):
            r.add(words, np.ones(100, np.int8), np.zeros(100, np.int8), i)
    assert ours.count == 64 and ours.seen == 1000
    words, labels, verdicts = ours.rows()
    assert words.shape == (64, 4) and (labels == 1).all()
    assert len(np.unique(words[:, 0])) > 3  # late batches displace early ones
    for a, b in zip(ours.rows() + (ours.ticks,), ref.rows() + (ref.ticks,)):
        np.testing.assert_array_equal(a, b)


def _sampled_run(name, banks, oracle_of, trace_regime="emergency", **skw):
    ns = PKG[name]
    rt = ns.runtime(_bank(banks, name), num_queues=2, batch=128,
                    ring_capacity=4096, record=True, **ns.kw)
    pool, labels = _pool()
    sampler = ns.deploy.PacketSampler(oracle_of(ns, pool, labels), num_slots=2,
                                      **skw).attach(rt)
    ns.workloads.play(rt, _rendered(name, trace_regime), swap_delivery=ns.delivery)
    sampler.detach()
    return rt, sampler


def _sampler_state(sampler) -> dict:
    words, labels = sampler.training_batch()
    win = sampler.window_since(0)
    return {"stats": sampler.stats(), "words": words.tolist(),
            "labels": labels.tolist(),
            "window": [np.asarray(a).tolist() for a in win],
            "mispredicts": sampler.slot_mispredicts.tolist()}


def test_sampler_is_bounded_and_matches_reference(banks):
    def oracle(ns, pool, labels):
        return ns.deploy.LabelOracle(pool, labels)

    rt_plain = DataplaneRuntime(banks[1], num_queues=2, batch=128,
                                ring_capacity=4096, record=True, device="cpu")
    workloads.play(rt_plain, _rendered("torch", "emergency"),
                   swap_delivery=_port_delivery)
    rt, sampler = _sampled_run("torch", banks, oracle, capacity=256)
    _, jsampler = _sampled_run("jax", banks, oracle, capacity=256)
    assert rt.on_retire is None and rt.on_drop is None
    # verdict/slot streams are bit-identical with the sampler attached
    assert rt.completed_verdicts == rt_plain.completed_verdicts
    assert rt.completed_slots == rt_plain.completed_slots
    st_ = sampler.stats()
    assert st_["seen"] == rt.telemetry.snapshot()["completed_total"]
    assert st_["labeled"] > 0 and st_["unknown"] == 0
    assert all(c <= 256 for c in st_["reservoir_rows"])
    words, labels = sampler.training_batch()
    assert words.shape[0] == labels.shape[0] > 0
    assert set(np.unique(labels)) <= {0, 1}
    assert _sampler_state(sampler) == _sampler_state(jsampler)


def test_sampler_without_oracle_counts_unknowns(banks):
    _, sampler = _sampled_run("torch", banks, lambda ns, p, l: None)
    _, jsampler = _sampled_run("jax", banks, lambda ns, p, l: None)
    assert sampler.stats() == jsampler.stats()
    assert sampler.stats()["labeled"] == 0 < sampler.stats()["unknown"]


def _drops_run(name, banks, oracle):
    ns = PKG[name]
    rng = np.random.default_rng(1)
    rt = ns.runtime(_bank(banks, name), num_queues=2, batch=32,
                    ring_capacity=64, **ns.kw)
    sampler = ns.deploy.PacketSampler(oracle, num_slots=2).attach(rt)
    pool, _ = _pool()
    for _ in range(4):  # overrun the tiny rings without ticking
        idx = rng.integers(0, pool.shape[0], 512)
        rt.dispatch(pkt.make_packets(rng.integers(0, 2, 512), pool[idx]))
    rt.drain()
    sampler.detach()
    return sampler


def test_sampler_harvests_ring_edge_drops(banks, corpus):
    pool, labels, oracle = corpus
    sampler = _drops_run("torch", banks, oracle)
    jsampler = _drops_run("jax", banks, jdeploy.LabelOracle(pool, labels))
    assert sampler.drops_seen > 0
    assert 0 < sampler.drop_reservoir.count <= sampler.drop_reservoir.capacity
    _words, got = sampler.training_batch()
    assert got.size > 0
    assert _sampler_state(sampler) == _sampler_state(jsampler)


def _window_run(name, banks, oracle):
    ns = PKG[name]
    pool, _ = _pool()
    rng = np.random.default_rng(2)
    rt = ns.runtime(_bank(banks, name), num_queues=2, batch=128,
                    ring_capacity=1024, **ns.kw)
    sampler = ns.deploy.PacketSampler(oracle, num_slots=2).attach(rt)
    _drive(rt, pool, rng, 4)
    cut = rt._tick_count
    _drive(rt, pool, rng, 3)
    rt.drain()
    sampler.detach()
    return sampler, cut


def test_sampler_window_filters_by_tick(banks, corpus):
    pool, labels, oracle = corpus
    sampler, cut = _window_run("torch", banks, oracle)
    jsampler, jcut = _window_run("jax", banks, jdeploy.LabelOracle(pool, labels))
    _w, l_all, _v, _s = sampler.window_since(0)
    w2, l2, _v2, _s2 = sampler.window_since(cut)
    assert 0 < l2.size < l_all.size
    assert (oracle.lookup(w2) == l2).all()
    assert cut == jcut
    for a, b in zip(sampler.window_since(cut), jsampler.window_since(cut)):
        np.testing.assert_array_equal(a, b)


def _megastep_sampled(name, banks, oracle):
    """A window-8 megastep runtime with a sampler: the taps see each
    window's retires at its drain, back to back."""
    ns = PKG[name]
    pool, _ = _pool()
    rt = ns.runtime(_bank(banks, name), num_queues=2, batch=16,
                    ring_capacity=1024, megastep_ticks=8, **ns.kw)
    assert rt._mega is not None
    sampler = ns.deploy.PacketSampler(oracle, num_slots=2, per_tick=8,
                                      max_pending=3).attach(rt)
    _drive(rt, pool, np.random.default_rng(8), 20, n=48)
    rt.drain()
    sampler.detach()
    return sampler


def test_sampler_matches_reference_in_a_megastep_window(banks, corpus):
    """The sampler's batches under the megastep equal the reference's
    window, whose retires reach the taps at each window's drain."""
    pool, labels, oracle = corpus
    ours = _megastep_sampled("torch", banks, oracle)
    ref = _megastep_sampled("jax", banks, jdeploy.LabelOracle(pool, labels))
    assert ours.stats()["seen"] > 0 and ours.stats()["labeled"] > 0
    assert _sampler_state(ours) == _sampler_state(ref)


def test_double_attach_rejected(banks):
    rt = DataplaneRuntime(banks[1], num_queues=2, device="cpu")
    s1 = deploy.PacketSampler(None, num_slots=2).attach(rt)
    with pytest.raises(RuntimeError, match="already has a sampler tap"):
        deploy.PacketSampler(None, num_slots=2).attach(rt)
    s1.detach()
    mesh = MeshDataplane(banks[1], hosts=2, num_queues=2, device="cpu")
    s2 = deploy.PacketSampler(None, num_slots=2).attach(mesh)
    assert all(s.on_retire is not None for s in mesh.shards)
    with pytest.raises(RuntimeError, match="host 0 already has a sampler tap"):
        deploy.PacketSampler(None, num_slots=2).attach(mesh)
    s2.detach()
    assert all(s.on_retire is None and s.on_drop is None for s in mesh.shards)


# ---------------------------------------------------------------------------
# trainer
# ---------------------------------------------------------------------------

def test_trainer_matches_reference_from_warm_latent(corpus, jtrained, tmp_path):
    """From the reference's trained latent, one more fine-tune in each
    package: losses within rtol 1e-4, latents within atol 1e-5, equal
    holdout counts; the port's checkpoint restores bit for bit."""
    pool, labels, _ = corpus
    warm = {k: np.asarray(v) for k, v in jtrained.latent.items()}
    ref = jdeploy.OnlineTrainer(steps=16, seed=3).fine_tune(
        pool, labels, warm_latent={k: jnp.asarray(v) for k, v in warm.items()})
    trainer = deploy.OnlineTrainer(checkpoint_dir=str(tmp_path), steps=16,
                                   seed=3, device="cpu")
    res = trainer.fine_tune(pool, labels, warm_latent=warm,
                            extra={"reason": "drift"})
    for key in ("loss_first", "loss_last"):
        np.testing.assert_allclose(res.metrics[key], ref.metrics[key], rtol=1e-4)
    for k, v in ref.latent.items():
        np.testing.assert_allclose(res.latent[k].numpy(), np.asarray(v),
                                   atol=1e-5, rtol=0, err_msg=k)
    for key in ("tp", "fp", "fn", "samples", "holdout", "steps"):
        assert res.metrics[key] == ref.metrics[key], key
    assert res.step == ref.step == 0
    back, extra = store.restore(str(tmp_path), res.step, res.latent, device="cpu")
    assert _tree_equal(back, res.latent)
    assert extra["reason"] == "drift"
    assert extra["metrics"]["samples"] == pool.shape[0]
    # the reference reads the port's checkpoint
    jback, _ = jstore.restore(str(tmp_path), res.step, ref.latent)
    assert _tree_equal(jback, res.latent)


def test_trainer_learns_and_checkpoints(corpus, tmp_path):
    pool, labels, _ = corpus
    trainer = deploy.OnlineTrainer(checkpoint_dir=str(tmp_path), steps=24,
                                   seed=0, keep_last=2, device="cpu")
    res = trainer.fine_tune(pool, labels)
    assert res.metrics["err"] <= 0.35          # beats coin-flip clearly
    assert res.metrics["f1"] > 0.5
    assert res.checkpoint_path and os.path.isdir(res.checkpoint_path)
    back, extra = store.restore(str(tmp_path), res.step, res.latent, device="cpu")
    assert _tree_equal(back, res.latent)
    assert "metrics" in extra and extra["metrics"]["samples"] == pool.shape[0]
    # successive fine-tunes advance the step and GC old checkpoints
    for _ in range(3):
        res = trainer.fine_tune(pool, labels, warm_latent=res.latent)
    assert store.list_steps(str(tmp_path)) == [2, 3]
    with pytest.raises(ValueError, match=">= 2 labeled samples"):
        trainer.fine_tune(pool[:1], labels[:1])


def test_words_to_pm1_matches_reference(corpus):
    pool, _, _ = corpus
    np.testing.assert_array_equal(deploy.words_to_pm1(pool[:8]),
                                  jdeploy.words_to_pm1(pool[:8]))


def test_corrupt_params_invert_the_model(corpus, trained):
    pool, labels, _ = corpus
    good = deploy.paired_err(trained["torch"], pool, labels)
    bad = deploy.paired_err(deploy.corrupt_params(trained["torch"]), pool, labels)
    assert good < 0.35 and bad > 0.65 and abs(good + bad - 1.0) < 1e-6
    assert good == jdeploy.paired_err(trained["jax"], pool, labels)


# ---------------------------------------------------------------------------
# canary lifecycle, in both packages from the same trained params
# ---------------------------------------------------------------------------

def _canary_run(name, banks, trained, *, corrupt=False, seed=3):
    ns = PKG[name]
    pool, labels = _pool()
    rng = np.random.default_rng(seed)
    rt = ns.runtime(_bank(banks, name), num_queues=4, batch=128,
                    ring_capacity=2048, audit=True, **ns.kw)
    sampler = ns.deploy.PacketSampler(
        ns.deploy.LabelOracle(pool, labels), num_slots=2).attach(rt)
    ctl = ns.deploy.CanaryController(rt, sampler, target_slot=0, bake_ticks=5,
                                     min_samples=16)
    before = {s: {k: _host(v).copy() for k, v in
                  ns.bank_lib.select_slot(rt.bank, s).items()} for s in (0, 1)}
    prior_reta = np.asarray(rt.reta).copy()
    _drive(rt, pool, rng, 2)
    params = trained[name]
    ctl.start(ns.deploy.corrupt_params(params) if corrupt else params,
              reason="test")
    assert ctl.state == ctl.BAKING
    assert not np.array_equal(np.asarray(rt.reta), prior_reta)  # steered
    _drive(rt, pool, rng, 6, controller=ctl)
    rt.drain()
    sampler.detach()
    return rt, ctl, before, prior_reta


def test_canary_promote_installs_weights_and_restores_routing(banks, trained):
    rt, ctl, before, prior_reta = _canary_run("torch", banks, trained)
    jrt, jctl, _, _ = _canary_run("jax", banks, trained)
    assert ctl.state == ctl.IDLE and len(ctl.decisions) == 1
    rec = ctl.decisions[0]
    assert rec["event"] == "promoted", rec
    assert _tree_equal(bank_lib.select_slot(rt.bank, 0), trained["torch"])
    assert _tree_equal(bank_lib.select_slot(rt.bank, 1), before[1])
    assert np.array_equal(np.asarray(rt.reta), prior_reta)
    kinds = [tuple(c["cmd"] for c in e["commands"])
             for e in rt.control.command_log()]
    assert ("swap_slot", "program_reta") in kinds            # canary_start
    assert ("swap_slot", "swap_slot", "program_reta") in kinds  # promote
    aud = rt.audit_conservation()
    assert aud["ok"] and aud["wrong_verdict"] == 0
    assert rt.control.continuity_audit()["ok"]
    assert untimed_doc(rt.deploy_log) == untimed_doc(jrt.deploy_log)
    assert _commands(rt) == _commands(jrt)
    assert rt.completed_verdicts == jrt.completed_verdicts


def test_canary_rolls_back_a_regression_bit_exactly(banks, trained):
    rt, ctl, before, prior_reta = _canary_run("torch", banks, trained,
                                              corrupt=True, seed=4)
    jrt, _, _, _ = _canary_run("jax", banks, trained, corrupt=True, seed=4)
    rec = ctl.decisions[0]
    assert rec["event"] == "rolled_back"
    assert rec["metrics"]["err_new"] > rec["metrics"]["err_base"]
    assert _tree_equal(bank_lib.select_slot(rt.bank, 0), before[0])
    assert _tree_equal(bank_lib.select_slot(rt.bank, 1), before[1])
    assert np.array_equal(np.asarray(rt.reta), prior_reta)
    aud = rt.audit_conservation()
    assert aud["ok"] and aud["wrong_verdict"] == 0
    assert rt.control.continuity_audit()["ok"]
    assert untimed_doc(rt.deploy_log) == untimed_doc(jrt.deploy_log)
    assert _commands(rt) == _commands(jrt)


def test_canary_flush_forces_exactly_one_conservative_decision(banks, trained):
    logs = {}
    for name in ("torch", "jax"):
        ns = PKG[name]
        rt = ns.runtime(_bank(banks, name), num_queues=2, **ns.kw)
        ctl = ns.deploy.CanaryController(rt, None, target_slot=0, bake_ticks=50)
        ctl.start(trained[name])
        rec = ctl.flush()               # end of traffic mid-bake
        assert rec["event"] == "rolled_back"
        assert "insufficient" in rec["reason"]
        assert ctl.flush() is None and ctl.step() is None
        assert len(ctl.decisions) == 1
        assert [d["event"] for d in rt.deploy_log] == ["canary_start", "rolled_back"]
        logs[name] = untimed_doc(rt.deploy_log)
    assert logs["torch"] == logs["jax"]


def test_canary_guards(banks, trained):
    bank1 = executor.init_bank(np.random.default_rng(1), 1, device="cpu")
    with pytest.raises(ValueError, match=">= 2 resident slots"):
        deploy.CanaryController(
            DataplaneRuntime(bank1, num_queues=2, device="cpu"), None)
    rt = DataplaneRuntime(banks[1], num_queues=2, device="cpu")
    with pytest.raises(ValueError, match="must differ"):
        deploy.CanaryController(rt, None, target_slot=0, canary_slot=0)
    with pytest.raises(ValueError, match="canary_share"):
        deploy.CanaryController(rt, None, canary_share=0.75)
    ctl = deploy.CanaryController(rt, None)
    ctl.start(trained["torch"])
    with pytest.raises(RuntimeError, match="already baking"):
        ctl.start(trained["torch"])
    ctl.flush()


def _mesh_canary(name, banks, trained):
    ns = PKG[name]
    pool, labels = _pool()
    rng = np.random.default_rng(5)
    mesh = ns.mesh(_bank(banks, name), hosts=2, num_queues=2, batch=128,
                   ring_capacity=2048, **ns.kw)
    sampler = ns.deploy.PacketSampler(
        ns.deploy.LabelOracle(pool, labels), num_slots=2).attach(mesh)
    ctl = ns.deploy.CanaryController(mesh, sampler, target_slot=0,
                                     bake_ticks=4, min_samples=16)
    _drive(mesh, pool, rng, 2)
    ctl.start(trained[name])
    _drive(mesh, pool, rng, 5, controller=ctl)
    mesh.drain()
    sampler.detach()
    return mesh, ctl


def test_canary_on_mesh_promotes_mesh_wide(banks, trained):
    mesh, ctl = _mesh_canary("torch", banks, trained)
    jmesh, _ = _mesh_canary("jax", banks, trained)
    assert ctl.decisions and ctl.decisions[0]["event"] == "promoted"
    assert deploy.bank_of(mesh) is mesh.shards[0].bank
    assert deploy.live_queues(mesh) == [0, 1, 2, 3]
    for shard in mesh.shards:   # mesh-wide: every shard's bank updated
        assert _tree_equal(bank_lib.select_slot(shard.bank, 0), trained["torch"])
    assert mesh.audit_conservation()["ok"]
    assert mesh.control.continuity_audit()["ok"]
    assert untimed_doc(mesh.deploy_log) == untimed_doc(jmesh.deploy_log)
    assert _commands(mesh) == _commands(jmesh)


# ---------------------------------------------------------------------------
# auto-remediation
# ---------------------------------------------------------------------------

class _WarmTrainer:
    """A trainer that fine-tunes from one shared latent, so both packages
    train the same weights (a cold start draws another latent in each)."""

    def __init__(self, trainer, latent):
        self._trainer, self._latent = trainer, latent

    def fine_tune(self, words, labels, **kw):
        return self._trainer.fine_tune(words, labels,
                                       warm_latent=self._latent, **kw)


def _warm_trainer(name, jtrained, **kw):
    warm = {k: np.asarray(v) for k, v in jtrained.latent.items()}
    if name == "jax":
        return _WarmTrainer(jdeploy.OnlineTrainer(**kw),
                            {k: jnp.asarray(v) for k, v in warm.items()})
    return _WarmTrainer(deploy.OnlineTrainer(device="cpu", **kw), warm)


def _mix_shift_stream(stream_cls, ticks=16, flip=8):
    """Crafted delta stream whose slot mix flips halfway (detector fuel)."""
    stream = stream_cls()
    for tick in range(ticks):
        per_slot = [64, 0] if tick < flip else [0, 64]
        stream.push({"kind": "delta", "seq": tick, "tick": tick, "t_s": None,
                     "host": 0,
                     "queues": [{"queue": 0, "completed": 64, "dropped": 0,
                                 "per_slot": per_slot,
                                 "actions": [64, 0, 0], "depth": 0},
                                {"queue": 1, "completed": 60, "dropped": 0,
                                 "per_slot": per_slot,
                                 "actions": [60, 0, 0], "depth": 0}],
                     "events": {}})
    return stream


def _remediated(name, banks, jtrained):
    ns = PKG[name]
    pool, labels = _pool()
    rng = np.random.default_rng(6)
    rt = ns.runtime(_bank(banks, name), num_queues=2, batch=128,
                    ring_capacity=2048, audit=True, **ns.kw)
    sampler = ns.deploy.PacketSampler(
        ns.deploy.LabelOracle(pool, labels), num_slots=2).attach(rt)
    det = ns.detector(_mix_shift_stream(ns.stream), num_queues=2, num_slots=2,
                      window=4)
    rem = ns.deploy.AutoRemediator(
        rt, det, sampler=sampler,
        trainer=_warm_trainer(name, jtrained, steps=16, seed=0),
        canary_kw=dict(bake_ticks=4, min_samples=16), min_retrain_samples=32)
    _drive(rt, pool, rng, 3)          # fill the reservoirs first
    rem.step()                        # proposal -> fine-tune -> canary
    events = [d["event"] for d in rt.deploy_log]
    assert events[:2] == ["retrain", "canary_start"]
    retrain = rt.deploy_log[0]
    assert retrain["reason"] == "slot_mix_shift" and retrain["slot"] == 1
    for _ in range(5):
        _drive(rt, pool, rng, 1)
        rem.step()
    rem.flush()
    rt.drain()
    events = [d["event"] for d in rt.deploy_log]
    assert sum(e in ("promoted", "rolled_back") for e in events) == 1
    rem.step()  # dedup: the same proposal never retrains twice
    assert sum(d["event"] == "retrain" for d in rt.deploy_log) == 1
    sampler.detach()
    return rt


def test_auto_remediator_runs_retrain_canary_pipeline(banks, jtrained):
    rt = _remediated("torch", banks, jtrained)
    jrt = _remediated("jax", banks, jtrained)
    aud = rt.audit_conservation()
    assert aud["ok"] and aud["wrong_verdict"] == 0
    assert rt.control.continuity_audit()["ok"]
    assert _trail(rt.deploy_log) == _trail(jrt.deploy_log)
    assert rt.deploy_log[-1]["reason"] == jrt.deploy_log[-1]["reason"]
    assert [c["commands"] for c in _commands(rt)] == \
        [c["commands"] for c in _commands(jrt)]


def _routing_remediated(name, banks):
    ns = PKG[name]
    rt = ns.runtime(_bank(banks, name), num_queues=4, batch=128,
                    ring_capacity=4096, audit=True, **ns.kw)
    stream = ns.stream()
    ns.attach(rt, stream)
    det = ns.detector(stream, num_queues=4, num_slots=2)
    rem = ns.deploy.AutoRemediator(rt, det)
    driver = ns.deploy.DeployDriver(rt, rem)
    assert ns.deploy.unwrap(driver) is rt
    ns.workloads.play(driver, _rendered(name, "elephant-skew", 0, queues=4),
                      swap_delivery=ns.delivery)
    driver.flush_deploy()
    return rt


def test_auto_remediator_submits_routing_proposals_as_epochs(banks):
    rt = _routing_remediated("torch", banks)
    jrt = _routing_remediated("jax", banks)
    obs.detach(rt)
    acts = [d for d in rt.deploy_log if d["event"] == "auto_remediate"]
    assert acts and acts[0]["command"]["cmd"] == "program_reta"
    assert acts[0]["epoch"] is not None
    aud = rt.audit_conservation()
    assert aud["ok"] and aud["wrong_verdict"] == 0
    assert rt.control.continuity_audit()["ok"]
    assert untimed_doc(rt.deploy_log) == untimed_doc(jrt.deploy_log)
    assert _commands(rt) == _commands(jrt)


# ---------------------------------------------------------------------------
# epoch-log provenance + record/replay
# ---------------------------------------------------------------------------

def test_epoch_log_doc_carries_deployments(banks, trained):
    docs = {}
    for name in ("torch", "jax"):
        ns = PKG[name]
        rt = ns.runtime(_bank(banks, name), num_queues=2, **ns.kw)
        ctl = ns.deploy.CanaryController(rt, None, bake_ticks=3)
        ctl.start(trained[name])
        ctl.flush()
        docs[name] = json.loads(json.dumps(ns.spans.epoch_log_doc(rt),
                                           default=_json_default))
    doc = docs["torch"]
    assert [d["event"] for d in doc["deployments"]] == ["canary_start", "rolled_back"]
    assert doc["continuity"]["ok"]
    applied = {e["epoch"] for e in doc["epochs"]}
    for d in doc["deployments"]:
        assert d["epoch"] in applied   # every decision is a typed epoch
    assert untimed_doc(doc) == untimed_doc(docs["jax"])


def test_recorded_deploy_run_replays_bit_exact(banks, corpus, jtrained, tmp_path):
    """A deploy run recorded by the port (canary start and decision with
    their SwapSlot params) replays to the recorded digest in the port, and
    from the file in the reference."""
    pool, labels, oracle = corpus
    rt = DataplaneRuntime(banks[1], num_queues=2, batch=128,
                          ring_capacity=4096, record=True, device="cpu")
    path = str(tmp_path / "deploy.bswt")
    rec = workloads.record(rt, path=path)
    driver = deploy.DeployDriver(rec)
    assert deploy.unwrap(driver) is rt
    sampler = deploy.PacketSampler(oracle, num_slots=2).attach(rt)
    pilot = deploy.ScheduledRollout(
        driver, sampler, _warm_trainer("torch", jtrained, steps=8, seed=0),
        warmup_ticks=4, min_samples=24,
        canary_kw=dict(bake_ticks=4, min_samples=16))
    driver.add(pilot)
    workloads.play(driver, _rendered("torch", "emergency"),
                   swap_delivery=_port_delivery)
    driver.flush_deploy()
    sampler.detach()
    assert pilot.decision is not None
    saved = rec.finish(name="deploy-promote", seed=0)
    loaded = workloads.load(path)
    swap_epochs = [s for s in loaded.steps if s["kind"] == "commands"
                   and any(type(c).__name__ == "SwapSlot" for c in s["commands"])]
    assert len(swap_epochs) >= 2       # canary_start + decision recorded
    rep = workloads.replay(loaded, workloads.make_runtime(loaded, device="cpu"))
    assert rep["ok"] and rep["digest_ok"]
    assert rep["digest"] == saved.expect["digest"]
    jtrace = jworkloads.load(path)
    jrep = jworkloads.replay(jtrace, jworkloads.make_runtime(jtrace))
    assert jrep["ok"] and jrep["digest_ok"]


# ---------------------------------------------------------------------------
# the canary-lifecycle property: every rollout ends in exactly one of
# promoted / rolled back, with zero wrong verdicts and conservation intact
# ---------------------------------------------------------------------------

PROPERTY_REGIMES = ("emergency", "flash-crowd", "slot-thrash")


def _rollout(name, banks, jtrained, regime, corrupt, seed):
    ns = PKG[name]
    pool, labels = _pool()
    rt = ns.runtime(_bank(banks, name), num_queues=2, batch=128,
                    ring_capacity=4096, audit=True, **ns.kw)
    sampler = ns.deploy.PacketSampler(ns.deploy.LabelOracle(pool, labels),
                                      num_slots=2, seed=seed).attach(rt)
    driver = ns.deploy.DeployDriver(rt)
    pilot = ns.deploy.ScheduledRollout(
        driver, sampler, _warm_trainer(name, jtrained, steps=12, seed=seed),
        warmup_ticks=4, min_samples=24, corrupt=corrupt,
        canary_kw=dict(bake_ticks=6, min_samples=16))
    driver.add(pilot)
    ns.workloads.play(driver, _rendered(name, regime, seed),
                      swap_delivery=ns.delivery)
    driver.flush_deploy()
    sampler.detach()
    return rt, pilot


@pytest.mark.parametrize("corrupt", [False, True])
@pytest.mark.parametrize("regime", PROPERTY_REGIMES)
def test_canary_rollout_property(banks, jtrained, regime, corrupt):
    seed = 0
    rt, pilot = _rollout("torch", banks, jtrained, regime, corrupt, seed)
    jrt, _ = _rollout("jax", banks, jtrained, regime, corrupt, seed)
    events = [d["event"] for d in rt.deploy_log]
    terminal = [e for e in events if e in ("promoted", "rolled_back")]
    if pilot.canary is not None:          # a rollout actually started
        assert len(terminal) == 1, events
        if corrupt:
            assert terminal == ["rolled_back"], rt.deploy_log
    else:                                 # not enough labeled traffic
        assert terminal == []
    aud = rt.audit_conservation()
    assert aud["ok"] and aud["wrong_verdict"] == 0
    assert rt.control.continuity_audit()["ok"]
    assert _trail(rt.deploy_log) == _trail(jrt.deploy_log)
    assert [c["commands"] for c in _commands(rt)] == \
        [c["commands"] for c in _commands(jrt)]
