"""The port's BNN slot training against the JAX reference: the losses, the
straight-through sign, one SGD step and one epoch from one NumPy latent,
the packed slots, ``evaluate``, the trained slot pair (Fig. 6), the
``--train`` driver and the quickstart counterpart, all on the CPU."""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import MARGIN, one_torch_thread  # noqa: F401
from repro.core import executor as jexecutor
from repro.data import packets as jpk
from repro.train import bnn as jbnn
from repro.train import losses as jlosses
from repro_torch.core import bank as tbank
from repro_torch.core import executor as texecutor
from repro_torch.launch import packetpath
from repro_torch.train import bnn, losses

ROOT = pathlib.Path(__file__).resolve().parents[1]
STE_POINTS = [-1.5, -1.0, -0.5, 0.0, 0.5, 1.0, 1.5]
# The port's trained slots start from other initial weights than the
# reference's (a torch.Generator against jax.random keys), so their F1 on
# the same split differs: over seeds 0-7 at epochs=2, samples_per_group=384
# the largest gap was 0.098 (seed 1, slot 1); the band is 1.5x that.
F1_BAND = 0.15


def _latent(seed: int, cfg=jexecutor.H32) -> dict:
    """One NumPy latent that both packages start from."""
    rng = np.random.default_rng(seed)
    return {"w1": (rng.normal(size=(cfg.hidden, cfg.d_bits)) * 0.01).astype(np.float32),
            "b1": (rng.normal(size=cfg.hidden) * 0.1).astype(np.float32),
            "w2": (rng.normal(size=(cfg.n_out, cfg.hidden)) / np.sqrt(cfg.hidden)).astype(np.float32),
            "b2": np.zeros(cfg.n_out, np.float32)}


def _torch_latent(latent: dict) -> dict:
    return {k: torch.from_numpy(v.copy()) for k, v in latent.items()}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_losses_match_reference(seed):
    rng = np.random.default_rng(seed)
    scores = (rng.normal(size=257) * 4).astype(np.float32)
    labels = rng.integers(0, 2, 257)
    for pw in (4.0, 0.5, 1.0):
        got = losses.weighted_bce_with_logits(torch.from_numpy(scores),
                                              torch.from_numpy(labels), pw)
        want = jlosses.weighted_bce_with_logits(jnp.asarray(scores), jnp.asarray(labels), pw)
        np.testing.assert_allclose(float(got), float(want), rtol=0, atol=1e-6)
    logits = rng.normal(size=(3, 5, 11)).astype(np.float32)
    tokens = rng.integers(0, 11, (3, 5))
    mask = rng.integers(0, 2, (3, 5))
    for m in (None, mask):
        got = losses.cross_entropy(torch.from_numpy(logits), torch.from_numpy(tokens),
                                   None if m is None else torch.from_numpy(m))
        want = jlosses.cross_entropy(jnp.asarray(logits), jnp.asarray(tokens),
                                     None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(float(got), float(want), rtol=0, atol=1e-6)


def test_ste_sign_value_and_gradient_match_reference():
    """Including the gradient of 0.5 at exactly +-1 (jnp.clip's tie)."""
    x = torch.tensor(STE_POINTS, requires_grad=True)
    y = bnn.ste_sign(x)
    y.sum().backward()
    xj = jnp.asarray(STE_POINTS)
    want_y = np.asarray(jbnn.ste_sign(xj))
    want_g = np.asarray(jax.grad(lambda v: jbnn.ste_sign(v).sum())(xj))
    np.testing.assert_array_equal(y.detach().numpy(), want_y)
    np.testing.assert_array_equal(x.grad.numpy(), want_g)
    np.testing.assert_array_equal(want_g, [0, 0.5, 1, 1, 1, 0.5, 0])


@pytest.mark.parametrize("seed", [0, 1])
def test_sgd_step_matches_reference(seed):
    latent = _latent(seed)
    xb, yb = jpk.load_split("train", 64, seed)
    idx = np.random.default_rng(seed).permutation(xb.shape[0])[:256]
    x, y = jpk.to_pm1_bits(xb[idx]), yb[idx]
    for pw in (4.0, 0.5):
        jlat, jloss = jbnn._sgd_step({k: jnp.asarray(v) for k, v in latent.items()},
                                     jnp.asarray(x), jnp.asarray(y), pos_weight=pw, lr=0.05)
        tlat, tloss = bnn._sgd_step(_torch_latent(latent), torch.from_numpy(x),
                                    torch.from_numpy(y), pos_weight=pw, lr=0.05)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5, atol=0)
        for k in latent:
            np.testing.assert_allclose(tlat[k].numpy(), np.asarray(jlat[k]),
                                       rtol=0, atol=1e-6, err_msg=k)


def test_pack_trained_matches_reference():
    """The same latent packs to the same slot, bit for bit, and the packed
    slot gives the reference's verdicts."""
    latent = _latent(3)
    want = jbnn.pack_trained({k: jnp.asarray(v) for k, v in latent.items()})
    got = bnn.pack_trained(_torch_latent(latent))
    for k, leaf in want.items():
        arr = np.asarray(leaf)
        np.testing.assert_array_equal(got[k].numpy().view(arr.dtype), arr, err_msg=k)
    xb, _ = jpk.load_split("val", 64, 0)
    w = jpk.to_payload_words(xb)
    np.testing.assert_array_equal(
        texecutor.forward(got, torch.from_numpy(w.view(np.int32))).numpy() > 0,
        np.asarray(jexecutor.forward(want, jnp.asarray(w))) > 0)


def test_train_bnn_epoch_matches_reference(monkeypatch):
    """One epoch at samples_per_group=128 from one NumPy latent: the same
    batches, per-step losses within 1e-4, nearly every packed bit equal and
    equal verdicts wherever the score is clear of the decision boundary."""
    latent = _latent(5)
    xb, yb = jpk.load_split("train", 128, 0)
    x = jpk.to_pm1_bits(xb)
    monkeypatch.setattr(jbnn, "init_latent",
                        lambda key, cfg=jexecutor.H32: {k: jnp.asarray(v) for k, v in latent.items()})
    jlat, jlosses_ = jbnn.train_bnn(jax.random.PRNGKey(0), x, yb, pos_weight=4.0, epochs=1)
    tlat, tlosses = bnn.train_bnn(_torch_latent(latent), x, yb, pos_weight=4.0, epochs=1)
    assert len(tlosses) == len(jlosses_) == x.shape[0] // 256
    np.testing.assert_allclose(tlosses, jlosses_, rtol=1e-4, atol=0)
    jslot, tslot = jbnn.pack_trained(jlat), bnn.pack_trained(tlat)
    bits_t = np.unpackbits(tslot["w1p"].numpy().view(np.uint8))
    bits_j = np.unpackbits(np.asarray(jslot["w1p"]).view(np.uint8))
    assert (bits_t == bits_j).mean() >= 0.999
    xv, _ = jpk.load_split("val", 128, 0)
    w = jpk.to_payload_words(xv)
    st = texecutor.forward(tslot, torch.from_numpy(w.view(np.int32)))[:, 0].numpy()
    sj = np.asarray(jexecutor.forward(jslot, jnp.asarray(w)))[:, 0]
    clear = np.abs(sj) > MARGIN
    np.testing.assert_array_equal((st > 0)[clear], (sj > 0)[clear])


@pytest.fixture(scope="module")
def val():
    xb, yb = jpk.load_split("val", 384, 0)
    return jpk.to_payload_words(xb), yb


@pytest.fixture(scope="module")
def jax_slots():
    return jbnn.train_slot_pair(seed=0, epochs=2, samples_per_group=384)


def test_port_slot_pair_shows_fig6_within_band(jax_slots, val):
    """The port's own training at the sizes of the reference's tests: slot 0
    (pos_weight 4.0) recall-oriented, slot 1 (0.5) precision-oriented, and
    each slot's F1 within ``F1_BAND`` of the reference's on the same split."""
    w, y = val
    slots = bnn.train_slot_pair(seed=0, epochs=2, samples_per_group=384, device="cpu")
    m0, m1 = (bnn.evaluate(s, w, y) for s in slots)
    assert m0["recall"] > m1["recall"], (m0, m1)
    assert m1["precision"] >= m0["precision"], (m0, m1)
    assert m0["f1"] > 0.5
    for got, jslot in zip((m0, m1), jax_slots):
        want = jbnn.evaluate(jslot, w, y)
        assert abs(got["f1"] - want["f1"]) <= F1_BAND, (got, want)


def test_jax_trained_slots_evaluate_identically(jax_slots, val):
    w, y = val
    for jslot in jax_slots:
        slot = tbank.from_jax_bank({k: np.asarray(v) for k, v in jslot.items()}, "cpu")
        assert bnn.evaluate(slot, w, y) == jbnn.evaluate(jslot, w, y)


def test_packetpath_trains_on_cpu(capsys):
    assert packetpath.main(["--device", "cpu", "--train", "--epochs", "1",
                            "--samples-per-group", "64", "--packets", "256",
                            "--batch", "64"]) == 0
    out = capsys.readouterr().out
    assert "slot0: precision=" in out and "slot1: precision=" in out
    assert "wrong_slot=0 wrong_verdict=0" in out
    with pytest.raises(SystemExit):  # a bank is trained or loaded, not both
        packetpath.build_parser().parse_args(["--train", "--bank", "b.npz"])


def _quickstart():
    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", ROOT / "examples" / "quickstart_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_counterpart_runs_on_cpu(capsys):
    assert _quickstart().main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "resident bank: 2 slots" in out and "slot flip on identical payload" in out
