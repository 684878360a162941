"""The port's ``ServeEngine`` against the reference's, token for token, with
the reference's weights carried by ``from_jax_params`` (f32, reduced
configs): smollm-360m, mamba2-130m, zamba2-7b and olmoe-1b-7b; slot
routing through the adapter bank; the published ``full`` bank served
slot-blind by both; deadline rejection; and h2o-danube-3-4b
with a prompt longer than its sliding window, where both engines give the
same tokens and both differ from the greedy decode (the reference's splice
copies the first window positions of the prefill into the ring, not the
last ones; ROADMAP Queue 3).  Tokens are compared exactly."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401
from repro.configs import registry as jreg
from repro.models import api as japi
from repro.serve import engine as jeng
from repro_torch.configs import registry as treg
from repro_torch.models import api as tapi
from repro_torch.serve import engine as teng


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _models(arch, params=None, **over):
    over = {"remat": "none", "dtype": "float32", **over}
    jcfg = jreg.get_config(arch).reduced(**over)
    tcfg = treg.get_config(arch).reduced(**over)
    jp = params if params is not None else japi.init(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, tapi.from_jax_params(_np(jp), tcfg, device="cpu")


def _serve(engine_mod, params, cfg, reqs, **kw):
    """Serve ``reqs`` ((prompt, slot, n_new) each) in one engine; outputs by rid."""
    if engine_mod is teng:
        kw["device"] = "cpu"
    eng = engine_mod.ServeEngine(params, cfg, **kw)
    for i, (prompt, slot, n_new) in enumerate(reqs):
        eng.submit(engine_mod.Request(rid=i, prompt=list(prompt), slot_id=slot,
                                      max_new_tokens=n_new))
    fins = eng.run_until_done()
    assert len(fins) == len(reqs)
    return {f.rid: f.output for f in fins}, eng


def _greedy_ref(params, cfg, prompt, n_new, slot=None):
    """The reference's no-cache greedy decode (``tests/test_engine.py``)."""
    toks, out = list(prompt), []
    for _ in range(n_new):
        batch = {"tokens": jnp.asarray([toks])}
        if slot is not None:
            batch["slot_ids"] = jnp.asarray([slot], jnp.int32)
        logits, _ = japi.apply(params, batch, cfg)
        out.append(int(jnp.argmax(logits[0, -1])))
        toks.append(out[-1])
    return out


def _greedy_port(params, cfg, prompt, n_new, slot=None):
    toks, out = list(prompt), []
    with torch.inference_mode():
        for _ in range(n_new):
            batch = {"tokens": torch.tensor([toks])}
            if slot is not None:
                batch["slot_ids"] = torch.tensor([slot])
            logits, _ = tapi.apply(params, batch, cfg)
            out.append(int(torch.argmax(logits[0, -1])))
            toks.append(out[-1])
    return out


@pytest.mark.parametrize("arch,over,lengths,n_new,kw", [
    ("smollm-360m", {}, (5, 9, 17), 5,
     dict(max_batch=2, max_seq=64, prefill_buckets=(8, 32))),
    ("mamba2-130m", {}, (5, 9, 17, 30), 5,
     dict(max_batch=4, max_seq=64, prefill_buckets=(8, 32))),
    ("zamba2-7b", {}, (5, 9, 17), 5,
     dict(max_batch=4, max_seq=64, prefill_buckets=(8, 32))),
    ("olmoe-1b-7b", {"moe_capacity_factor": 16.0}, (6, 11), 4,
     dict(max_batch=2, max_seq=64, prefill_buckets=(16,))),
])
def test_engine_matches_reference_engine(rng, arch, over, lengths, n_new, kw):
    jcfg, tcfg, jp, tp = _models(arch, bank_mode="none", **over)
    reqs = [(rng.integers(0, jcfg.vocab_size, n), 0, n_new) for n in lengths]
    want, jeng_ = _serve(jeng, jp, jcfg, reqs, **kw)
    got, teng_ = _serve(teng, tp, tcfg, reqs, **kw)
    assert got == want
    assert teng_.ticks == jeng_.ticks
    # and the port's engine is its own greedy decode (the reference's property)
    for rid, (prompt, _, _) in enumerate(reqs[:2]):
        assert got[rid] == _greedy_port(tp, tcfg, prompt, n_new), rid


def _bumped(jcfg, scale):
    """Reference params whose slot-1 adapters differ (their ``b`` is zero at
    init), as ``test_slot_routing_changes_behavior`` bumps them."""
    params = japi.init(jax.random.PRNGKey(0), jcfg)

    def walk(t):
        if isinstance(t, dict):
            t = {k: walk(v) for k, v in t.items()}
            if "a" in t and "b" in t:
                t["b"] = t["b"].at[1].set(
                    jax.random.normal(jax.random.PRNGKey(7), t["b"].shape[1:]) * scale)
        return t
    return walk(params)


def test_slot_routing_matches_reference(rng):
    over = dict(bank_mode="adapter", bank_slots=2)
    jcfg = jreg.get_config("smollm-360m").reduced(remat="none", dtype="float32", **over)
    jcfg, tcfg, jp, tp = _models("smollm-360m", params=_bumped(jcfg, 0.5), **over)
    prompt = rng.integers(0, jcfg.vocab_size, 8)
    reqs = [(prompt, 0, 6), (prompt, 1, 6)]
    kw = dict(max_batch=2, max_seq=64, prefill_buckets=(8,))
    want, _ = _serve(jeng, jp, jcfg, reqs, **kw)
    got, _ = _serve(teng, tp, tcfg, reqs, **kw)
    assert got == want
    assert got[0] != got[1], "slots did not induce distinct behaviors"
    assert got[0] == _greedy_port(tp, tcfg, prompt, 6, slot=0)
    assert got[1] == _greedy_port(tp, tcfg, prompt, 6, slot=1)


def test_deadline_rejection():
    _, tcfg, _, tp = _models("smollm-360m", bank_mode="none")
    eng = teng.ServeEngine(tp, tcfg, max_batch=2, max_seq=64, prefill_buckets=(8,),
                           device="cpu")
    eng.submit(teng.Request(rid=0, prompt=[1, 2, 3], max_new_tokens=4,
                            deadline_s=time.monotonic() - 1.0))
    eng.submit(teng.Request(rid=1, prompt=[1, 2, 3], max_new_tokens=4))
    by_rid = {f.rid: f for f in eng.run_until_done()}
    assert by_rid[0].rejected and by_rid[0].output == [] and not by_rid[1].rejected
    assert eng.rejected_count == 1
    assert len(by_rid[1].output) == 4
    with pytest.raises(ValueError, match="engine runs on"):
        teng.ServeEngine(tp, tcfg, device="meta")


def test_sliding_window_past_the_window(rng):
    """h2o-danube-3-4b reduced (window 32): a prompt inside the window is
    served as the greedy decode; one of 40 tokens is served identically by
    both engines, and both differ from the greedy decode."""
    jcfg, tcfg, jp, tp = _models("h2o-danube-3-4b", bank_mode="none")
    assert jcfg.sliding_window == 32
    short, long_ = rng.integers(0, 256, 20), rng.integers(0, 256, 40)
    kw = dict(max_batch=2, max_seq=64, prefill_buckets=(32, 64))
    reqs = [(short, 0, 5), (long_, 0, 5)]
    want, _ = _serve(jeng, jp, jcfg, reqs, **kw)
    got, _ = _serve(teng, tp, tcfg, reqs, **kw)
    assert got == want
    assert got[0] == _greedy_ref(jp, jcfg, short, 5)
    assert got[1] != _greedy_ref(jp, jcfg, long_, 5)
    assert got[1] != _greedy_port(tp, tcfg, long_, 5)


def test_full_bank_serves_slot_blind(rng):
    """smollm-360m's published ``bank_mode="full"``: both engines ignore the
    request's slot (the reference's docstring promises per-slot segments
    its code does not build; ROADMAP Queue 3), so one prompt on slots 0
    and 1 gives one output, the unrouted greedy decode."""
    jcfg, tcfg, jp, tp = _models("smollm-360m")
    assert jcfg.bank_mode == "full" and jcfg.bank_slots == 2
    prompt = rng.integers(0, jcfg.vocab_size, 7)
    reqs = [(prompt, 0, 4), (prompt, 1, 4)]
    kw = dict(max_batch=2, max_seq=64, prefill_buckets=(8,))
    want, _ = _serve(jeng, jp, jcfg, reqs, **kw)
    got, _ = _serve(teng, tp, tcfg, reqs, **kw)
    assert got == want and got[0] == got[1]
    assert got[0] == _greedy_port(tp, tcfg, prompt, 4)
