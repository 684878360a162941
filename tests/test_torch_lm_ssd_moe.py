"""The port's SSD / Mamba2 block (``repro_torch.nn.ssd``) and MoE layer
(``repro_torch.nn.moe``) against the reference's on the same NumPy inputs
and weights: ``ssd_chunked`` against the reference and against the port's
own ``ssd_sequential`` oracle, the mamba block's decode against its full
pass, the pad-mask state, ``dispatch_by_expert`` bit for bit on given
expert ids, and ``moe_apply`` on inputs whose k-th / (k+1)-th gate margin
is asserted (so ``top_k`` cannot break a tie differently).

Tolerances: f32 results within atol 1e-5, rtol 1e-5 against the reference
(other summation orders); the chunked form against the token recurrence,
and a decode against a full pass, within 1e-4 (a different algorithm in
f32, as the reference's own tests hold it)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU, one_torch_thread  # noqa: F401
from repro.configs.base import ModelConfig as JConfig
from repro.nn import moe as jmoe, ssd as jssd
from repro_torch.configs.base import ModelConfig as TConfig
from repro_torch.models import api
from repro_torch.nn import moe as tmoe, ssd as tssd

ATOL = RTOL = 1e-5


def _cfgs(**kw):
    base = dict(name="t", family="ssm", n_layers=1, d_model=64, n_heads=0,
                n_kv_heads=0, d_ff=0, vocab_size=256, dtype="float32",
                ssm_state=16, ssm_head_dim=32, ssm_chunk=8)
    base.update(kw)
    return JConfig(**base), TConfig(**base)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol, rtol=rtol)


def _ssd_inputs(rng, b, s, h, p, n):
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, s, h)))).astype(np.float32)
    a = -np.exp(rng.normal(size=(h,)) * 0.3).astype(np.float32)
    bb = rng.normal(size=(b, s, n)).astype(np.float32)
    cc = rng.normal(size=(b, s, n)).astype(np.float32)
    return x, dt, a, bb, cc


def _port(ins):
    """The reference's SSD inputs as the port takes them: its one-group B
    and C, (B, S, N), as (B, S, 1, N)."""
    x, dt, a, bb, cc = map(_t, ins)
    return x, dt, a, bb[:, :, None], cc[:, :, None]


@pytest.mark.parametrize("b,s,h,p,n,chunks", [
    (2, 32, 3, 8, 4, (4, 8, 32)), (1, 16, 1, 4, 2, (1, 16)), (3, 24, 4, 8, 4, (8,))])
def test_ssd_chunked(rng, b, s, h, p, n, chunks):
    ins = _ssd_inputs(rng, b, s, h, p, n)
    init = rng.normal(size=(b, h, p, n)).astype(np.float32)
    for chunk in chunks:
        for state0 in (None, init):
            want_y, want_s = jssd.ssd_chunked(*map(jnp.asarray, ins), chunk,
                                              None if state0 is None else jnp.asarray(state0))
            got_y, got_s = tssd.ssd_chunked(*_port(ins), chunk,
                                            None if state0 is None else _t(state0))
            _close(got_y, want_y)
            _close(got_s, want_s)
            seq_y, seq_s = tssd.ssd_sequential(
                *_port(ins), None if state0 is None else _t(state0))
            _close(got_y, seq_y.numpy(), atol=1e-4, rtol=1e-4)
            _close(got_s, seq_s.numpy(), atol=1e-4, rtol=1e-4)
    with pytest.raises(ValueError, match="not divisible"):
        tssd.ssd_chunked(*_port(ins), 5)


def test_ssd_sequential_and_decode_step(rng):
    ins = _ssd_inputs(rng, 2, 6, 2, 4, 4)
    want_y, want_s = jssd.ssd_sequential(*map(jnp.asarray, ins))
    got_y, got_s = tssd.ssd_sequential(*_port(ins))
    _close(got_y, want_y)
    _close(got_s, want_s)


def _mamba(cfgs, seed=0, perturb=None):
    jp = jssd.mamba_init(jax.random.PRNGKey(seed), cfgs[0])
    if perturb is not None:  # non-trivial dt_bias / A_log / D / conv_b
        jp = dict(jp, **{k: jnp.asarray(perturb.normal(size=jp[k].shape) * 0.5, jnp.float32)
                         for k in ("dt_bias", "A_log", "D", "conv_b")})
    return jp, api.load_params(tssd.Mamba(cfgs[1], None, CPU), _np(jp))


def test_mamba_block_full_and_decode(rng):
    cfgs = _cfgs()
    jp, tp = _mamba(cfgs, perturb=rng)
    s = 16
    x = rng.normal(size=(2, s, 64)).astype(np.float32)
    want = jssd.mamba_apply(jp, jnp.asarray(x), cfgs[0])
    got = tssd.mamba_apply(tp, _t(x), cfgs[1])
    for g, w in zip(got, want):
        _close(g, w)
    # the port's decode, token by token, against its own full pass
    st, conv = tssd.init_mamba_state(cfgs[1], 2, CPU)
    with torch.no_grad():
        outs = []
        for i in range(s):
            y, st, conv = tssd.mamba_apply(tp, _t(x[:, i:i + 1]), cfgs[1],
                                           ssm_state=st, conv_state=conv)
            outs.append(y)
    _close(torch.cat(outs, 1), got[0].detach().numpy(), atol=1e-4, rtol=1e-4)
    _close(st, got[1].detach().numpy(), atol=1e-4, rtol=1e-4)
    _close(conv, got[2].detach().numpy(), atol=0, rtol=0)
    # one decode step against the reference's
    jst, jconv = jssd.init_mamba_state(cfgs[0], 2)
    want1 = jssd.mamba_apply(jp, jnp.asarray(x[:, :1]), cfgs[0], ssm_state=jst,
                             conv_state=jconv)
    st0, conv0 = tssd.init_mamba_state(cfgs[1], 2, CPU)
    got1 = tssd.mamba_apply(tp, _t(x[:, :1]), cfgs[1], ssm_state=st0, conv_state=conv0)
    for g, w in zip(got1, want1):
        _close(g, w)


def test_mamba_pad_mask_state_exact(rng):
    """Bucketed prefill: right-pads leave the carried state exactly the
    state at the prompt's end, in the port and in the reference."""
    cfgs = _cfgs(ssm_state=8, ssm_chunk=4)
    jp, tp = _mamba(cfgs, perturb=rng)
    x = rng.normal(size=(2, 12, 64)).astype(np.float32)
    xpad = np.concatenate([x, rng.normal(size=(2, 4, 64)).astype(np.float32)], 1)
    mask = np.zeros((2, 16), np.float32)
    mask[0, :12] = 1
    mask[1, :9] = 1
    last = mask.sum(1).astype(np.int32)
    _, st_exact, conv_exact = tssd.mamba_apply(tp, _t(x), cfgs[1])
    _, st9, conv9 = tssd.mamba_apply(tp, _t(x[1:, :9]), cfgs[1])
    _, st_pad, conv_pad = tssd.mamba_apply(tp, _t(xpad), cfgs[1], pad_mask=_t(mask),
                                           last_valid=_t(last))
    _close(st_pad[0], st_exact[0].detach().numpy())
    _close(st_pad[1], st9[0].detach().numpy())
    _close(conv_pad[0], conv_exact[0].detach().numpy(), atol=0, rtol=0)
    _close(conv_pad[1], conv9[0].detach().numpy(), atol=0, rtol=0)
    want = jssd.mamba_apply(jp, jnp.asarray(xpad), cfgs[0], pad_mask=jnp.asarray(mask),
                            last_valid=jnp.asarray(last))
    for g, w in zip((st_pad, conv_pad), want[1:]):
        _close(g, w)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,k,e,cap", [(16, 2, 4, 8), (32, 2, 4, 4), (24, 3, 6, 2),
                                        (40, 8, 8, 8)])
def test_dispatch_by_expert_bit_exact(rng, t, k, e, cap):
    ids = rng.integers(0, e + 1, (t, k)).astype(np.int32)  # id e: masked pads
    w = rng.random((t, k)).astype(np.float32)
    want = jmoe.dispatch_by_expert(jnp.asarray(ids), jnp.asarray(w), e, cap)
    got = tmoe.dispatch_by_expert(_t(ids), _t(w), e, cap)
    assert got.capacity == want.capacity
    np.testing.assert_array_equal(got.dest.numpy(), np.asarray(want.dest))
    np.testing.assert_array_equal(got.token.numpy(), np.asarray(want.token))
    np.testing.assert_array_equal(got.weight.numpy(), np.asarray(want.weight))
    kept = got.dest.numpy() < e * cap
    assert len(set(got.dest.numpy()[kept])) == kept.sum()  # no two rows collide


def _moe_case(rng, cfgs, bsz, s, k):
    """Reference params and inputs whose top-k gates are separated from the
    (k+1)-th by a margin that no f32 summation order can close."""
    jcfg = cfgs[0]
    for seed in range(50):
        jp = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg)
        x = rng.normal(size=(bsz, s, jcfg.d_model)).astype(np.float32)
        probs = np.asarray(jax.nn.softmax(jnp.asarray(x.reshape(-1, jcfg.d_model))
                                          @ jp["router"], -1))
        top = -np.sort(-probs, -1)
        if (top[:, k - 1] - top[:, k]).min() > 1e-5:
            return jp, x
    raise AssertionError("no seed with a clear top-k margin")


@pytest.mark.parametrize("dense_residual", [False, True])
@pytest.mark.parametrize("capacity,masked", [(None, False), (None, True), (8, False)])
def test_moe_apply(rng, capacity, masked, dense_residual):
    cfgs = _cfgs(family="moe", n_heads=4, n_kv_heads=2, d_ff=32, ssm_state=0,
                 n_experts=4, experts_per_token=2, moe_dense_residual=dense_residual)
    jp, x = _moe_case(rng, cfgs, 2, 12, 2)
    tp = api.load_params(tmoe.MoE(cfgs[1], None, CPU), _np(jp))
    mask = (np.arange(12)[None] < np.array([[12], [7]])).astype(np.float32) if masked else None
    want, waux = jmoe.moe_apply(jp, jnp.asarray(x), cfgs[0], capacity=capacity,
                                token_mask=None if mask is None else jnp.asarray(mask))
    got, gaux = tmoe.moe_apply(tp, _t(x), cfgs[1], capacity=capacity,
                               token_mask=None if mask is None else _t(mask))
    _close(got, want)
    _close(gaux, waux)
    if masked:
        assert (got[1, 7:] == 0).all()
