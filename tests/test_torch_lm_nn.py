"""The port's NN blocks (``repro_torch.nn.modules``) against the reference's
on the same NumPy inputs and weights: RMSNorm, rotary embeddings, the flash
attention (GQA, sliding window, q/kv blocks smaller than S), decode
attention with per-row cache lengths (full and ring cache), the int8 decode
(equal int8 cache entries, outputs close), the SwiGLU MLP, the embedding
and the logits (tied and untied head, padded vocab masked).

Tolerances: f32 results within atol 1e-5, rtol 1e-5 (the two packages sum
in other orders; one f32 ulp at these magnitudes is ~1e-7), bf16 results
within 2**-7 relative (two bf16 ulps: a last-place difference of an f32
intermediate can round the bf16 result either way)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU, one_torch_thread  # noqa: F401
from repro.configs.base import ModelConfig as JConfig
from repro.nn import modules as jm
from repro_torch.configs.base import ModelConfig as TConfig
from repro_torch.models import api
from repro_torch.nn import modules as tm

ATOL = RTOL = 1e-5
BF16_RTOL = 2.0 ** -7


def _cfgs(**kw):
    base = dict(name="t", family="dense", n_layers=1, d_model=64, n_heads=4,
                n_kv_heads=2, d_ff=128, vocab_size=256, dtype="float32")
    base.update(kw)
    return JConfig(**base), TConfig(**base)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _close(got: torch.Tensor, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm(rng, dtype):
    x = rng.normal(size=(3, 5, 64)).astype(np.float32) * 3
    scale = rng.normal(size=(64,)).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    want = jm.rmsnorm({"scale": jnp.asarray(scale, dtype)}, jx, 1e-5)
    norm = tm.RMSNorm(64, getattr(torch, dtype), CPU)
    api.load_params(norm, _np({"scale": jnp.asarray(scale, dtype)}))
    got = tm.rmsnorm(norm, _t(np.asarray(jx.astype(jnp.float32))).to(norm.scale.dtype), 1e-5)
    assert got.dtype == norm.scale.dtype
    if dtype == "float32":
        _close(got, want)
    else:
        _close(got, np.asarray(want.astype(jnp.float32)), atol=0, rtol=BF16_RTOL)


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_rope(rng, theta):
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 4096, (2, 7))
    want = jm.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    _close(tm.rope(_t(x), _t(pos), theta), want)


def _attn(cfgs, seed=0):
    jcfg, tcfg = cfgs
    jp = jm.attention_init(jax.random.PRNGKey(seed), jcfg)
    return jp, api.load_params(tm.Attention(tcfg, None, CPU), _np(jp))


@pytest.mark.parametrize("window,qb,kb,heads,kv,s", [
    (None, 16, 16, 4, 2, 64), (None, 8, 32, 4, 4, 64), (16, 16, 16, 4, 1, 64),
    (None, 64, 64, 6, 3, 64), (8, 4, 8, 2, 2, 64), (None, 512, 1024, 4, 2, 48),
    (8, 512, 1024, 4, 2, 24),
])
def test_flash_attention(rng, window, qb, kb, heads, kv, s):
    cfgs = _cfgs(n_heads=heads, n_kv_heads=kv, head_dim=16, d_model=heads * 16,
                 sliding_window=window)
    jp, tp = _attn(cfgs)
    x = rng.normal(size=(2, s, heads * 16)).astype(np.float32)
    pos = np.arange(s)[None].repeat(2, 0)
    want, wkv = jm.attention_apply(jp, jnp.asarray(x), cfgs[0], positions=jnp.asarray(pos),
                                   q_block=qb, k_block=kb)
    got, gkv = tm.attention_apply(tp, _t(x), cfgs[1], positions=_t(pos),
                                  q_block=qb, k_block=kb)
    _close(got, want)
    _close(gkv["k"], wkv["k"])
    _close(gkv["v"], wkv["v"])


@pytest.mark.parametrize("window", [None, 8])
def test_decode_attention_per_row(rng, window):
    """Rows at their own cache lengths (a (B,) vector), written in place at
    ``cache_len`` (ring slot ``cache_len % L`` under a window)."""
    cfgs = _cfgs(sliding_window=window)
    jp, tp = _attn(cfgs, 1)
    lc = 8 if window else 40
    k = rng.normal(size=(3, 2, lc, 16)).astype(np.float32)
    v = rng.normal(size=(3, 2, lc, 16)).astype(np.float32)
    cl = np.array([3, 7, 21]) if window else np.array([0, 17, 38])
    xt = rng.normal(size=(3, 1, 64)).astype(np.float32)
    pos = cl[:, None]
    want, wc = jm.attention_apply(jp, jnp.asarray(xt), cfgs[0], positions=jnp.asarray(pos),
                                  kv_cache={"k": jnp.asarray(k), "v": jnp.asarray(v)},
                                  cache_len=jnp.asarray(cl, jnp.int32))
    cache = {"k": _t(k), "v": _t(v)}
    got, gc = tm.attention_apply(tp, _t(xt), cfgs[1], positions=_t(pos),
                                 kv_cache=cache, cache_len=_t(cl))
    assert gc is cache  # written in place
    _close(got, want)
    _close(gc["k"], wc["k"])
    _close(gc["v"], wc["v"])


def test_decode_matches_prefill(rng):
    """The port's decode of token s equals its own prefill of s + 1 tokens."""
    _, tcfg = _cfgs()
    tp = tm.Attention(tcfg, torch.Generator().manual_seed(1), CPU)
    s = 24
    x = torch.from_numpy(rng.normal(size=(2, s + 1, 64)).astype(np.float32))
    pos = torch.arange(s + 1)[None].expand(2, -1)
    full, kv = tm.attention_apply(tp, x, tcfg, positions=pos, q_block=8, k_block=8)
    cache = {n: torch.nn.functional.pad(kv[n][:, :, :s], (0, 0, 0, 40 - s)) for n in kv}
    with torch.no_grad():
        out, _ = tm.attention_apply(tp, x[:, s:], tcfg, positions=pos[:, s:],
                                    kv_cache=cache, cache_len=torch.tensor([s, s]))
    _close(out[:, 0], full[:, -1].detach().numpy(), atol=1e-4, rtol=1e-4)


def test_int8_decode(rng):
    """Equal int8 cache entries and scales (round half to even in both), and
    outputs within the f32 tolerance."""
    cfgs = _cfgs()
    jp, tp = _attn(cfgs, 2)
    lc = 16
    kq = rng.integers(-127, 128, (2, 2, lc, 16)).astype(np.int8)
    vq = rng.integers(-127, 128, (2, 2, lc, 16)).astype(np.int8)
    ks = rng.random((2, 2, lc)).astype(np.float32) * 0.05
    vs = rng.random((2, 2, lc)).astype(np.float32) * 0.05
    cl = np.array([5, 12])
    xt = rng.normal(size=(2, 1, 64)).astype(np.float32)
    cache = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    want, wc = jm.attention_apply(jp, jnp.asarray(xt), cfgs[0],
                                  positions=jnp.asarray(cl[:, None]),
                                  kv_cache={n: jnp.asarray(a) for n, a in cache.items()},
                                  cache_len=jnp.asarray(cl, jnp.int32))
    got, gc = tm.attention_apply(tp, _t(xt), cfgs[1], positions=_t(cl[:, None]),
                                 kv_cache={n: _t(a) for n, a in cache.items()},
                                 cache_len=_t(cl))
    for n in ("k", "v"):
        assert gc[n].dtype == torch.int8
        np.testing.assert_array_equal(gc[n].numpy(), np.asarray(wc[n]))
    for n in ("k_scale", "v_scale"):
        _close(gc[n], wc[n], atol=0, rtol=1e-6)
    _close(got, want)


def test_int8_dot_is_exact():
    """Integer dots past f32's 2**24 (a long PV) still come out exact."""
    a = torch.full((1, 2048), 127, dtype=torch.int8)
    b = torch.full((2048, 1), -127, dtype=torch.int8)
    assert int(tm._int_dot(a, b, 2048)) == -127 * 127 * 2048
    q, s = tm._quantize_rows(torch.tensor([[0.5, -1.5, 2.5, 127.0]]))
    np.testing.assert_array_equal(q.numpy(), [[0, -2, 2, 127]])  # half to even


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp(rng, dtype):
    jcfg, tcfg = _cfgs(dtype=dtype)
    jp = jm.mlp_init(jax.random.PRNGKey(3), jcfg)
    tp = api.load_params(tm.MLP(tcfg, None, CPU), _np(jp))
    x = jnp.asarray(rng.normal(size=(2, 5, 64)), dtype)
    want = jm.mlp_apply(jp, x).astype(jnp.float32)
    got = tm.mlp_apply(tp, _t(np.asarray(x.astype(jnp.float32))).to(tp.wg.dtype))
    if dtype == "float32":
        _close(got, want)
    else:  # a bf16 chain of three products: a few bf16 ulps of the output scale
        np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want),
                                   atol=4 * BF16_RTOL * float(jnp.abs(want).max()))


@pytest.mark.parametrize("tied", [True, False])
def test_embedding_and_logits(rng, tied):
    jcfg, tcfg = _cfgs(vocab_size=250, vocab_pad_multiple=32, tie_embeddings=tied)
    je = jm.embed_init(jax.random.PRNGKey(4), jcfg)
    jh = jm.head_init(jax.random.PRNGKey(5), jcfg)
    te = api.load_params(tm.Embed(tcfg, None, CPU), _np(je))
    th = api.load_params(tm.head_init(tcfg, None, CPU), _np(jh))
    assert not tied or dict(th.named_parameters()) == {}
    toks = rng.integers(0, 256, (2, 9))
    _close(tm.embed_apply(te, _t(toks)), jm.embed_apply(je, jnp.asarray(toks)), atol=0, rtol=0)
    x = rng.normal(size=(2, 9, 64)).astype(np.float32)
    want = jm.logits_apply(je, jh, jnp.asarray(x), jcfg)
    got = tm.logits_apply(te, th, _t(x), tcfg)
    assert got.dtype == torch.float32 and got.shape == (2, 9, 256)
    assert (got[..., 250:] == torch.finfo(torch.float32).min).all()
    _close(got, want)
    # the port's own padded rows are zero too
    drawn = tm.Embed(tcfg, torch.Generator().manual_seed(0), CPU)
    assert (drawn.embedding[250:] == 0).all() and (drawn.embedding[:250] != 0).any()
