"""The port's train step (``repro_torch.train.train_step``) against the
reference's, from the same weights (``from_jax_params``, reduced configs in
f32) and the same NumPy batch: one step for every arch of
``tests/test_models_smoke.py``, 1 microbatch against 4, the int8
gradient codec, remat "full" against "none", and ``head.w`` under
``bank_mode="head"`` (no gradient reaches it; it still decays).

Tolerances: losses and grad norms within 1e-5 relative (f32 forward and
backward summed in other orders).  Updated params within a tenth of the
learning rate: AdamW moves every element by about lr whatever its
gradient's size, so an element whose gradient is near zero can move by a
visible fraction of lr on a last-place difference of that gradient
(measured: at most 0.022 lr over the ten archs); every other element
agrees to its f32 rounding.  Where rounding is coarse (bf16 gradients; the
int8 codec, whose code can step by one on a last-place difference of its
input), a first step may move an element the other way: at most 2 lr
apart (step 1's normalised update is at most 1 in size), and at most one
element in a hundred beyond a tenth of lr (measured: 0.22% with the codec,
whose 0 <-> +-1 code steps each move an element by lr); the codec's grad
norm within 1e-3 relative.  A bf16 model is compared on its f32 master
copy: its bf16 params are that copy rounded, one bf16 ulp apart where the
copies differ across a rounding boundary."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401
from repro.configs import registry as jreg
from repro.models import api as japi
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch.configs import registry as treg
from repro_torch.models import api as tapi
from repro_torch.models import lm as tlm
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts

ARCHS = [a for a in jreg.ARCH_IDS if a != "boundswitch-h32"]
HEAD_BANKED = [a for a in ARCHS if jreg.get_config(a).bank_mode == "head"]
RTOL = 1e-5
LR = 3e-4
PARAM_ATOL = 0.1 * LR


def batch_np(cfg, rng, b=2, s=32) -> dict:
    """``tests/test_models_smoke.py``'s batch, as NumPy arrays."""
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.frontend == "patch":
        batch["patch_embeds"] = rng.normal(
            size=(b, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    if cfg.bank_mode in ("adapter", "head"):
        batch["slot_ids"] = rng.integers(0, cfg.bank_slots, (b,)).astype(np.int32)
    batch["labels"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    batch["loss_mask"] = np.ones((b, s), np.float32)
    return batch


def leaves(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(leaves(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, torch.Tensor):  # a bf16 leaf of ``state_tree``
        return {prefix: tree.float().numpy()}
    return {prefix: np.asarray(tree, np.float32)}


def setup(arch, *, batch=2, seq=32, **over):
    """(reference state, port state, configs, NumPy batch) from one init."""
    over = {"remat": "none", "dtype": "float32", **over}
    jcfg = jreg.get_config(arch).reduced(**over)
    tcfg = treg.get_config(arch).reduced(**over)
    kw = dict(warmup_steps=1, total_steps=10, learning_rate=LR,
              moments_dtype=jcfg.moments_dtype, master_weights=jcfg.master_weights)
    jo, to = jopt.OptimizerConfig(**kw), topt.OptimizerConfig(**kw)
    jp = japi.init(jax.random.PRNGKey(0), jcfg)
    model = tapi.from_jax_params(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                                 device="cpu")
    jstate = {"params": jp, "opt": jopt.adamw_init(jp, jo),
              "step": jnp.zeros((), jnp.int32)}
    tstate = {"params": model, "opt": topt.adamw_init(list(model.parameters()), to),
              "step": torch.zeros((), dtype=torch.int32)}
    b = batch_np(jcfg, np.random.default_rng(0), batch, seq)
    return jstate, tstate, (jcfg, tcfg, jo, to), b


def run_ref(jstate, jcfg, jo, b, **kw):
    step = jax.jit(jts.make_train_step(jcfg, jo, **kw))
    return step(jstate, {k: jnp.asarray(v) for k, v in b.items()})


def run_port(tstate, tcfg, to, b, **kw):
    step = tts.make_train_step(tcfg, to, **kw)
    return step(tstate, {k: torch.from_numpy(v) for k, v in b.items()})


def assert_step_close(js, jm, ts, tm, *, coarse=False, norm_rtol=RTOL,
                      prefixes=("/params", "/opt/master")):
    for k, rtol in (("loss", RTOL), ("grad_norm", norm_rtol), ("lr", RTOL)):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=rtol, err_msg=k)
    assert int(ts["step"]) == int(js["step"]) == 1
    assert int(ts["opt"]["step"]) == int(js["opt"]["step"])
    got = leaves(tts.state_tree(ts))
    want = leaves(jax.tree_util.tree_map(np.asarray, js))
    assert sorted(got) == sorted(want)
    far = total = 0
    for name in want:
        if name.startswith(prefixes):
            diff = np.abs(got[name] - want[name])
            if not coarse:
                np.testing.assert_allclose(got[name], want[name], rtol=0,
                                           atol=PARAM_ATOL, err_msg=name)
            assert diff.max() <= 2.01 * LR, name
            far += int((diff > PARAM_ATOL).sum())
            total += diff.size
    assert far <= total / 100, f"{far} of {total} elements beyond a tenth of lr"


@pytest.mark.parametrize("arch", ARCHS)
def test_one_step_matches_reference(arch):
    jstate, tstate, (jcfg, tcfg, jo, to), b = setup(arch)
    js, jm = run_ref(jstate, jcfg, jo, b)
    ts, tm = run_port(tstate, tcfg, to, b)
    assert np.isfinite(float(tm["loss"])) and float(tm["grad_norm"]) > 0
    np.testing.assert_allclose(float(tm["aux"]), float(jm["aux"]), rtol=RTOL,
                               atol=1e-7)
    assert_step_close(js, jm, ts, tm)


def test_microbatches_match_reference_and_one_microbatch():
    """4 microbatches against the reference's 4 (the loss is the mean of
    the totals, aux 0), and against 1 microbatch (the reference's
    ``test_microbatch_equivalence``: near-identical updates)."""
    jstate, tstate, (jcfg, tcfg, jo, to), b = setup("smollm-360m", batch=8, seq=16,
                                                     n_layers=2)
    js, jm = run_ref(jstate, jcfg, jo, b, num_microbatches=4)
    ts4, tm4 = run_port(tstate, tcfg, to, b, num_microbatches=4)
    assert float(tm4["aux"]) == float(jm["aux"]) == 0.0
    assert_step_close(js, jm, ts4, tm4)
    _, t1, _, _ = setup("smollm-360m", batch=8, seq=16, n_layers=2)
    t1, tm1 = run_port(t1, tcfg, to, b)
    assert float(tm1["loss"]) == pytest.approx(float(tm4["loss"]), rel=1e-4)
    d = {k: np.abs(v - leaves(tts.state_tree(ts4))[k]).max()
         for k, v in leaves(tts.state_tree(t1)["params"], "/params").items()}
    assert max(d.values()) < 5e-4


def test_microbatch_grads_accumulate_in_f32():
    """A bf16 model with 2 microbatches: the grads reaching the clip are
    f32 (the reference's f32 zeros), and the step equals the reference's."""
    jstate, tstate, (jcfg, tcfg, jo, to), b = setup("smollm-360m", batch=4, seq=8,
                                                     n_layers=1, dtype="bfloat16")
    seen = []
    real = topt.clip_by_global_norm

    def spy(grads, max_norm):
        seen.extend(g.dtype for g in grads)
        return real(grads, max_norm)
    topt.clip_by_global_norm = spy
    try:
        ts, tm = run_port(tstate, tcfg, to, b, num_microbatches=2)
    finally:
        topt.clip_by_global_norm = real
    assert set(seen) == {torch.float32}
    js, jm = run_ref(jstate, jcfg, jo, b, num_microbatches=2)
    # bf16 forward and backward: the loss and norm agree to bf16's rounding
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=2.0 ** -8)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=2.0 ** -6)
    tm = dict(tm, loss=jm["loss"], grad_norm=jm["grad_norm"])
    assert_step_close(js, jm, ts, tm, coarse=True, prefixes=("/opt/master",))
    for p, m in zip(ts["params"].parameters(), ts["opt"]["master"]):
        assert torch.equal(p.detach(), m.to(torch.bfloat16))


def test_compressed_step_matches_reference_and_is_close_to_exact():
    jstate, tstate, (jcfg, tcfg, jo, to), b = setup("smollm-360m", batch=4, seq=16,
                                                     n_layers=2)
    js, jm = run_ref(jstate, jcfg, jo, b, compress_gradients=True)
    ts, tm = run_port(tstate, tcfg, to, b, compress_gradients=True)
    assert_step_close(js, jm, ts, tm, coarse=True, norm_rtol=1e-3)
    _, exact, _, _ = setup("smollm-360m", batch=4, seq=16, n_layers=2)
    exact, _ = run_port(exact, tcfg, to, b)
    a = leaves(tts.state_tree(exact)["params"])
    c = leaves(tts.state_tree(ts)["params"])
    rel = max(np.abs(a[k] - c[k]).max() / (np.abs(a[k]).max() + 1e-9) for k in a)
    assert rel < 0.2


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_full_gives_the_grads_of_none(arch, monkeypatch):
    """The same step with every layer checkpointed: equal loss and grads,
    and the checkpoint was taken (one call per layer, group and mamba
    layer inside a group)."""
    calls = []
    real = tlm.checkpoint

    def counting(fn, *a, **kw):
        calls.append(fn)
        return real(fn, *a, **kw)
    monkeypatch.setattr(tlm, "checkpoint", counting)
    out = {}
    for remat in ("none", "full"):
        _, tstate, (_, tcfg, _, to), b = setup(arch, remat=remat)
        model = tstate["params"]
        params = list(model.parameters())
        loss_fn = tts.make_loss_fn(tcfg)
        batch = {k: torch.from_numpy(v) for k, v in b.items()}
        out[remat] = tts._grads(loss_fn, model, params, batch)
        if remat == "none":
            assert not calls
    assert calls
    (l0, _, g0), (l1, _, g1) = out["none"], out["full"]
    assert torch.equal(l0, l1)
    for a, c in zip(g0, g1):
        assert (a is None) == (c is None)
        if a is not None:
            torch.testing.assert_close(a, c, rtol=1e-6, atol=1e-7)


def test_remat_is_off_without_a_graph(monkeypatch):
    """Serving (no graph recorded) never recomputes under remat "full"."""
    monkeypatch.setattr(tlm, "checkpoint", lambda *a, **k: pytest.fail("remat"))
    cfg = treg.get_config("smollm-360m").reduced(dtype="float32", remat="full")
    model = tapi.init(0, cfg, device="cpu")
    with torch.inference_mode():
        tapi.apply(model, {"tokens": torch.zeros((1, 4), dtype=torch.long)}, cfg)


@pytest.mark.parametrize("arch", HEAD_BANKED)
def test_unused_head_decays_as_in_the_reference(arch):
    """``bank_mode="head"`` routes the logits through the bank: ``head.w``
    gets no gradient (``None`` in the port, zeros in the reference) and
    still decays, equal to the reference's."""
    jstate, tstate, (jcfg, tcfg, jo, to), b = setup(arch)
    w0 = tstate["params"].head.w.detach().clone()
    loss_fn = tts.make_loss_fn(tcfg)
    model = tstate["params"]
    _, _, grads = tts._grads(loss_fn, model, list(model.parameters()),
                             {k: torch.from_numpy(v) for k, v in b.items()})
    assert grads[[n for n, _ in model.named_parameters()].index("head.w")] is None
    js, _ = run_ref(jstate, jcfg, jo, b)
    ts, _ = run_port(tstate, tcfg, to, b)
    w1 = ts["params"].head.w.detach()
    assert not torch.equal(w0, w1)
    lr, wd = to.learning_rate, to.weight_decay  # step 1 of warmup 1: lr itself
    torch.testing.assert_close(w1, w0 - lr * wd * w0, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(w1.numpy(), np.asarray(js["params"]["head"]["w"]),
                               rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("arch", ["smollm-360m", "mamba2-130m"])
def test_prefill_and_serve_steps_match_reference(arch):
    """``make_prefill_step`` and ``make_serve_step``: the next token of a
    prompt, then two decode steps on the returned cache grown to 16
    positions, equal to the reference's; caches within 1e-4 (the model
    tests' tolerance)."""
    jstate, tstate, (jcfg, tcfg, _, _), _ = setup(arch)
    jp, model = jstate["params"], tstate["params"]
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 8)).astype(np.int32)
    jn, jc = jax.jit(jts.make_prefill_step(jcfg))(jp, {"tokens": jnp.asarray(toks)})
    tn, tc = tts.make_prefill_step(tcfg)(model, {"tokens": torch.from_numpy(toks)})
    assert tn.dtype == torch.int32
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    jcache = japi.init_cache(jcfg, 2, 16)
    tcache = tapi.init_cache(tcfg, 2, 16, device="cpu")
    jserve, tserve = jax.jit(jts.make_serve_step(jcfg)), tts.make_serve_step(tcfg)
    jt, tt = jn, tn
    for i in range(2):
        jt, jcache = jserve(jp, jt, jcache, i)
        tt, tcache = tserve(model, tt, tcache, i)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        jt, tt = jt[:, None], tt[:, None]
    got, want = leaves(tcache), leaves(jax.tree_util.tree_map(np.asarray, jcache))
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=1e-4, rtol=1e-4,
                                   err_msg=name)
    for name, t in leaves(tc).items():
        assert np.isfinite(t).all(), name
