"""The port's model API (``repro_torch.models.api``) against the reference's
for every arch at ``reduced(dtype="float32")``, with the reference's weights
carried by ``from_jax_params``: the ``to_numpy_params`` round trip bit for
bit, ``init_cache`` leaf for leaf (names, shapes, dtypes; the int8 variant
too), ``apply`` with its prefill cache, and three ``decode_step``s at
per-row cache lengths; then one bf16 forward.

Tolerances: f32 logits and cache leaves within atol 1e-4, rtol 1e-4 (two
layers of f32 work summed in other orders; logits reach ~40).  The bf16
forward within 2**-8 (bf16's unit roundoff) times 16 times the largest
|logit|: the residual stream is rounded to bf16 about 8 times per layer, and
a last-place difference of an f32 intermediate can round any of them the
other way, each such ulp carried on to the logits."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401
from repro.configs import registry as jreg
from repro.models import api as japi
from repro_torch.configs import registry as treg
from repro_torch.models import api as tapi

ARCHS = [a for a in jreg.ARCH_IDS if a != "boundswitch-h32"]
ATOL = RTOL = 1e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _assert_tree_close(got: dict, want: dict, atol=ATOL, rtol=RTOL):
    g, w = _leaves(got), _leaves(want)
    assert sorted(g) == sorted(w)
    for name in w:
        assert tuple(g[name].shape) == tuple(w[name].shape), name
        np.testing.assert_allclose(g[name].float().numpy(), np.asarray(w[name], np.float32),
                                   atol=atol, rtol=rtol, err_msg=name)


def _models(arch, **over):
    jcfg = jreg.get_config(arch).reduced(remat="none", **over)
    tcfg = treg.get_config(arch).reduced(remat="none", **over)
    jp = japi.init(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, tapi.from_jax_params(_np(jp), tcfg, device="cpu")


def _batch(cfg, rng, b=2, s=16):
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s))}
    if cfg.frontend == "patch":
        batch["patch_embeds"] = rng.normal(size=(b, cfg.frontend_len, cfg.d_model)
                                           ).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    else:  # right-padded rows, as the engine's bucketed prefill sends them
        batch["pad_mask"] = (np.arange(s)[None] < np.array([[s], [s - 5]])
                             ).astype(np.float32)
    if cfg.bank_mode in ("adapter", "head"):
        batch["slot_ids"] = np.array([0, cfg.bank_slots - 1], np.int32)
    return batch


@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip_and_caches(arch):
    jcfg, tcfg, jp, tp = _models(arch, dtype="float32")
    ref_np = _np(jp)
    back = tapi.to_numpy_params(tp)
    assert sorted(_leaves(back)) == sorted(_leaves(ref_np))
    for name, leaf in _leaves(ref_np).items():
        got = _leaves(back)[name]
        assert got.dtype == leaf.dtype and got.shape == leaf.shape, name
        np.testing.assert_array_equal(got, leaf, err_msg=name)
    again = tapi.to_numpy_params(tapi.from_jax_params(back, tcfg, device="cpu"))
    for name, leaf in _leaves(back).items():
        np.testing.assert_array_equal(_leaves(again)[name], leaf)
    with pytest.raises(ValueError, match="keys"):
        tapi.from_jax_params({**ref_np, "stray": {}}, tcfg, device="cpu")
    for cfgs in ((jcfg, tcfg), (dataclasses.replace(jcfg, cache_dtype="int8"),
                                dataclasses.replace(tcfg, cache_dtype="int8"))):
        want = _leaves(japi.init_cache(cfgs[0], 2, 40))
        got = _leaves(tapi.init_cache(cfgs[1], 2, 40, device="cpu"))
        assert sorted(got) == sorted(want)
        for name in want:
            assert tuple(got[name].shape) == want[name].shape, name
            assert str(got[name].dtype).split(".")[-1] == str(want[name].dtype), name
            assert not got[name].any()


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_and_decode(arch, rng):
    jcfg, tcfg, jp, tp = _models(arch, dtype="float32")
    batch = _batch(jcfg, rng)
    want_logits, want_aux, want_cache = japi.apply(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg, return_cache=True)
    with torch.inference_mode():
        got_logits, got_aux, got_cache = tapi.apply(
            tp, {k: _t(v) for k, v in batch.items()}, tcfg, return_cache=True)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), atol=1e-6, rtol=1e-5)
    _assert_tree_close(got_cache, want_cache)

    slots = batch.get("slot_ids")
    jc = japi.init_cache(jcfg, 2, 24)
    tc = tapi.init_cache(tcfg, 2, 24, device="cpu")
    for step, cache_len in enumerate(([0, 3], 5, [4, 9])):
        toks = rng.integers(0, jcfg.vocab_size, (2, 1))
        wl, jc = japi.decode_step(jp, jnp.asarray(toks), jc,
                                  jnp.asarray(cache_len, jnp.int32), jcfg,
                                  None if slots is None else jnp.asarray(slots))
        with torch.inference_mode():
            gl, tc = tapi.decode_step(tp, _t(toks), tc, _t(cache_len), tcfg,
                                      None if slots is None else _t(slots))
        np.testing.assert_allclose(gl.numpy(), np.asarray(wl), atol=ATOL, rtol=RTOL,
                                   err_msg=f"step {step}")
    _assert_tree_close(tc, jc)


def test_bf16_forward(rng):
    jcfg, tcfg, jp, tp = _models("smollm-360m")
    assert tcfg.dtype == "bfloat16" and tp.layers[0].attn.wq.dtype == torch.bfloat16
    batch = _batch(jcfg, rng, s=32)
    want, _ = japi.apply(jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    with torch.inference_mode():
        got, _ = tapi.apply(tp, {k: _t(v) for k, v in batch.items()}, tcfg)
    assert got.dtype == torch.float32  # logits in f32, as the reference asks
    want = np.asarray(want)
    real = slice(0, jcfg.vocab_size)
    bound = 16 * 2.0 ** -8 * np.abs(want[..., real]).max()
    np.testing.assert_allclose(got.numpy()[..., real], want[..., real], atol=bound, rtol=0)
    np.testing.assert_array_equal(got.numpy()[..., jcfg.vocab_size:],
                                  want[..., jcfg.vocab_size:])
