"""The port's optimizer, token pipeline and gradient codec
(``repro_torch.train.optimizer``, ``repro_torch.data.tokens``,
``repro_torch.distributed.compress``) against the reference's on the same
NumPy inputs, and the optimizer, codec and straggler cases of
``tests/test_train.py`` run on the port.

Tolerances: the schedule, norms and f32 AdamW leaves within 1e-6 of each
value and of the leaf's largest magnitude (the same f32 operations in the
same order; ``pow``, ``cos`` and a division by a scalar may round a last
place otherwise, and an update rounds at the leaf's scale); bf16 leaves
within one bf16 ulp (2**-8) on the same terms.  Token batches and int8
codes are compared bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401
from repro.data import tokens as jtok
from repro.distributed import compress as jcomp
from repro.train import optimizer as jopt
from repro.train.loop import StragglerMonitor as JStragglerMonitor
from repro_torch.data import tokens as ttok
from repro_torch.distributed import compress as tcomp
from repro_torch.train import optimizer as topt
from repro_torch.train.loop import StragglerMonitor

RTOL = 1e-6
BF16_RTOL = 2.0 ** -8
SHAPES = [(3, 4), (5,), (2, 2, 2), (7, 3)]


def _t(a) -> torch.Tensor:
    """A JAX or NumPy array as a CPU tensor of the same dtype (bf16 too)."""
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _close(got: torch.Tensor, want, what: str):
    want = np.asarray(want)
    rtol = BF16_RTOL if want.dtype == jnp.bfloat16 else RTOL
    assert str(got.dtype).endswith(str(want.dtype)), (what, got.dtype, want.dtype)
    want = want.astype(np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()), err_msg=what)


# ---------------------------------------------------------------------------
# the cases of tests/test_train.py
# ---------------------------------------------------------------------------

def test_adamw_converges_quadratic():
    cfg = topt.OptimizerConfig(learning_rate=0.1, warmup_steps=0,
                               total_steps=200, weight_decay=0.0)
    target = torch.tensor([3.0, -2.0, 0.5])
    w = torch.zeros(3, requires_grad=True)
    state = topt.adamw_init([w], cfg)
    loss = lambda: torch.sum((w - target) ** 2)  # noqa: E731
    for _ in range(200):
        (g,) = torch.autograd.grad(loss(), [w])
        topt.adamw_update([g], state, [w], cfg)
    assert float(loss().detach()) < 1e-3


def test_lr_schedule_shape():
    cfg = topt.OptimizerConfig(learning_rate=1.0, warmup_steps=10,
                               total_steps=100, min_lr_ratio=0.1)
    lrs = [float(topt.lr_schedule(cfg, torch.tensor(s))) for s in [0, 5, 10, 55, 100]]
    assert lrs[0] == 0.0 and abs(lrs[1] - 0.5) < 1e-6
    assert abs(lrs[2] - 1.0) < 1e-6
    assert 0.1 < lrs[3] < 1.0
    assert abs(lrs[4] - 0.1) < 1e-6  # floor


def test_grad_clip():
    g = [torch.full((4,), 100.0)]
    clipped, norm = topt.clip_by_global_norm(g, 1.0)
    assert abs(float(topt.global_norm(clipped)) - 1.0) < 1e-5
    assert float(norm) == pytest.approx(200.0)


@pytest.mark.parametrize("seed,scale", [(0, 0.1), (1, 1.0), (2, 3.7), (3, 250.0),
                                        (4, 1e4), (123456, 42.0)])
def test_quantize_roundtrip_error_bound(seed, scale):
    x = torch.from_numpy(np.random.default_rng(seed).normal(size=(64,))
                         .astype(np.float32)) * scale
    y = tcomp.quantize_dequantize(x)
    amax = float(x.abs().max())
    assert float((x - y).abs().max()) <= amax / 127.0 + 1e-6


def test_straggler_monitor():
    mon = StragglerMonitor(n_hosts=4, factor=1.5)
    for _ in range(5):
        flagged = mon.observe(np.asarray([1.0, 1.0, 1.0, 5.0]))
    assert flagged == [3]
    plan = mon.reassignment_plan(flagged, n_shards=4)
    assert 3 in plan and plan[3] != 3


def test_straggler_monitor_matches_reference():
    times = np.random.default_rng(3).gamma(4.0, 0.25, size=(12, 6))
    times[4:, 2] *= 3.0
    mons = StragglerMonitor(6, factor=1.4), JStragglerMonitor(6, factor=1.4)
    for row in times:
        flagged = [m.observe(row) for m in mons]
        assert flagged[0] == flagged[1]
        np.testing.assert_array_equal(mons[0].ewma, mons[1].ewma)
        assert mons[0].reassignment_plan(flagged[0], 6) == \
            mons[1].reassignment_plan(flagged[1], 6)


# ---------------------------------------------------------------------------
# the optimizer against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("warmup,total", [(0, 10), (1, 10), (10, 100), (20, 300)])
def test_lr_schedule_matches_reference(warmup, total):
    kw = dict(learning_rate=3e-4, warmup_steps=warmup, total_steps=total)
    jc, tc = jopt.OptimizerConfig(**kw), topt.OptimizerConfig(**kw)
    steps = np.arange(0, total + 30, dtype=np.int32)
    want = np.asarray(jax.jit(lambda s: jopt.lr_schedule(jc, s))(jnp.asarray(steps)))
    got = topt.lr_schedule(tc, torch.from_numpy(steps))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)


def _tree(rng, dtype=np.float32, scale=3.0):
    return [(rng.normal(size=s) * scale).astype(np.float32).astype(dtype) for s in SHAPES]


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_global_norm_and_clip_match_reference(dtype, max_norm):
    g = _tree(np.random.default_rng(1), dtype)
    jg = [jnp.asarray(x) for x in g]
    tg = [_t(x) for x in g]
    _close(topt.global_norm(tg), jopt.global_norm(jg), "norm")
    jc, jn = jopt.clip_by_global_norm(jg, max_norm)
    tc, tn = topt.clip_by_global_norm(tg, max_norm)
    _close(tn, jn, "norm")
    for i, (a, b) in enumerate(zip(tc, jc)):
        _close(a, b, f"clipped leaf {i}")


CASES = {
    "f32 master": (np.float32, "float32", True),
    "f32 no master": (np.float32, "float32", False),
    "bf16 params, master": (jnp.bfloat16, "float32", True),
    "bf16 params, bf16 moments (arctic)": (jnp.bfloat16, "bfloat16", True),
    "f32 params, bf16 moments": (np.float32, "bfloat16", True),
    "bf16 params, no master": (jnp.bfloat16, "float32", False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_adamw_update_matches_reference(case):
    """Five steps from the same params and grads (one leaf with no gradient
    in the port, zeros in the reference): params, m, v, master, step, lr
    and grad norm."""
    pdt, mdt, master = CASES[case]
    kw = dict(warmup_steps=2, total_steps=8, moments_dtype=mdt, master_weights=master,
              learning_rate=1e-2, clip_norm=5.0)
    jc, tc = jopt.OptimizerConfig(**kw), topt.OptimizerConfig(**kw)
    rng = np.random.default_rng(7)
    jp = [jnp.asarray(x) for x in _tree(rng, pdt, 1.0)]
    tp = [_t(x).requires_grad_() for x in jp]
    js, ts = jopt.adamw_init(jp, jc), topt.adamw_init(tp, tc)
    assert sorted(ts) == sorted(js)
    for _ in range(5):
        g = _tree(rng, pdt)
        g[1] = np.zeros_like(g[1])
        jp, js, jm = jopt.adamw_update([jnp.asarray(x) for x in g], js, jp, jc)
        tg = [_t(x) for x in g]
        tg[1] = None
        tp, ts, tm = topt.adamw_update(tg, ts, tp, tc)
        assert int(ts["step"]) == int(js["step"])
        _close(tm["lr"], jm["lr"], "lr")
        _close(tm["grad_norm"], jm["grad_norm"], "grad_norm")
        for name in ("m", "v") + (("master",) if master else ()):
            for i, (a, b) in enumerate(zip(ts[name], js[name])):
                _close(a, b, f"{name}[{i}]")
        for i, (a, b) in enumerate(zip(tp, jp)):
            _close(a.detach(), b, f"param {i}")
    if master or pdt is np.float32:
        # the leaf with no gradient still decays (a bf16 leaf with no master
        # copy does not: lr * decay is under half its ulp, in both packages)
        assert not np.array_equal(tp[1].detach().float().numpy(), _tree(
            np.random.default_rng(7), pdt, 1.0)[1].astype(np.float32))


# ---------------------------------------------------------------------------
# the token pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("structured", [True, False])
@pytest.mark.parametrize("n_hosts,host_id", [(1, 0), (2, 1)])
def test_synthetic_tokens_bit_equal(structured, n_hosts, host_id):
    kw = dict(vocab_size=97, seq_len=24, global_batch=6, seed=5,
              structured=structured, n_hosts=n_hosts, host_id=host_id)
    jd = jtok.SyntheticTokens(jtok.TokenPipelineConfig(**kw))
    td = ttok.SyntheticTokens(ttok.TokenPipelineConfig(**kw))
    for _ in range(4):
        want, got = next(jd), next(td)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert td.cursor == jd.cursor == 4


def test_synthetic_tokens_resume_exactly():
    cfg = ttok.TokenPipelineConfig(vocab_size=64, seq_len=16, global_batch=4, seed=2)
    full = ttok.SyntheticTokens(cfg)
    stream = [next(full) for _ in range(6)]
    resumed = ttok.SyntheticTokens(cfg)
    resumed.restore(3)
    for want in stream[3:]:
        got = next(resumed)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    assert resumed.cursor == 6


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------

def _codec_inputs():
    rng = np.random.default_rng(11)
    ties = (np.arange(-300, 301) * 0.5).astype(np.float32)  # halves: round to even
    return {
        "normal": rng.normal(size=(33, 17)).astype(np.float32),
        "wide": (rng.normal(size=(4096,)) * 1e4).astype(np.float32),
        "ties": ties,
        "zeros": np.zeros((5, 3), np.float32),
        "bf16": np.asarray(jnp.asarray(rng.normal(size=(64,)), jnp.bfloat16)),
    }


@pytest.mark.parametrize("name", list(_codec_inputs()))
@pytest.mark.parametrize("axis", [None, 0])
def test_codec_codes_bit_equal(name, axis):
    x = _codec_inputs()[name]
    if axis is not None and x.ndim < 2:
        x = x.reshape(-1, 1)
    jc, js = jcomp.quantize(jnp.asarray(x), axis=axis)
    tc, ts = tcomp.quantize(_t(x), axis=axis)
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    want = np.asarray(jcomp.quantize_dequantize(jnp.asarray(x)))
    got = tcomp.quantize_dequantize(_t(x))
    assert str(got.dtype).endswith(str(want.dtype))
    np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))


def test_compress_grads_leaf_by_leaf():
    g = _tree(np.random.default_rng(4))
    want = jcomp.compress_grads([jnp.asarray(x) for x in g])
    got = tcomp.compress_grads([_t(x) for x in g[:2]] + [None] + [_t(g[3])])
    assert got[2] is None
    for a, b in zip([got[0], got[1], got[3]], [want[0], want[1], want[3]]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
