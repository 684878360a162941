"""Decode attention (``repro_torch.kernels.decode_attention``) on the CPU:
the wrapper's plain version against the decode branch's earlier arithmetic
(``nn.modules._qk``, the causal or ring mask, softmax, ``_pv``) over ragged
per-row lengths (0, mid, L - 1, and past L, which both masks clamp), one
and four query heads a group, head dims 224 and 64, bf16 and f32 caches,
causal and ring caches: equal bit for bit, the same operations on the same
values.  Then the paths that keep the earlier branch: a CPU cache runs the
plain version, while a DTensor cache and an int8 cache never reach the
wrapper; none launches the kernel."""

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import decode_attention as da
from repro_torch.launch.mesh import _build
from repro_torch.nn import modules as tm

L = 40


def _earlier_branch(q, ck, cv, cl, scale, window, out_dtype):
    """The decode branch of ``attention_apply`` before the wrapper."""
    kpos = torch.arange(ck.shape[2])
    if window is None:
        valid = kpos[None, :] <= cl[:, None]
    else:
        valid = kpos[None, :] < torch.clamp(cl + 1, max=ck.shape[2])[:, None]
    scores = tm._qk(q, ck) * scale
    scores = torch.where(valid[:, None, None, None], scores, tm.NEG)
    return tm._pv(torch.softmax(scores, dim=-1), cv).to(out_dtype)


@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("gq,d", [(1, 224), (4, 64), (1, 64), (4, 224)])
def test_plain_version_is_the_earlier_branch(window, dtype, gq, d):
    rng = np.random.default_rng(gq * 1000 + d)
    g = 2
    cl = torch.tensor([0, L // 2, L - 1, L + 5])
    if window is not None:  # a ring past its first lap: every position resident
        cl = torch.tensor([0, L // 2, L - 1, 3 * L + 7])
    b = len(cl)
    q = torch.from_numpy(rng.standard_normal((b, g, gq, 1, d)).astype(np.float32)).to(dtype)
    ck = torch.from_numpy(rng.standard_normal((b, g, L, d)).astype(np.float32)).to(dtype)
    cv = torch.from_numpy(rng.standard_normal((b, g, L, d)).astype(np.float32)).to(dtype)
    scale = d ** -0.5
    before = dict(da.decode_attention.launches)
    got = da.decode_attention(q, ck, cv, cl, scale, dtype)
    want = _earlier_branch(q, ck, cv, cl, scale, window, dtype)
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.equal(got, want)
    assert dict(da.decode_attention.launches) == before


@pytest.fixture
def one_rank(tmp_path):
    """A gloo group of one rank in this process, destroyed after."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    yield _build((1,), ("model",), "cpu")
    dist.destroy_process_group()


def _attn(cfg, rng):
    p = tm.Attention(cfg, torch.Generator().manual_seed(0), "cpu")
    x = torch.from_numpy(rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32))
    cache = {n: torch.from_numpy(rng.standard_normal((3, 2, 16, 16)).astype(np.float32))
             for n in ("k", "v")}
    return p, x, cache, torch.tensor([2, 9, 15])


def _not_reached(*args, **kw):
    raise AssertionError("the wrapper was reached")


@pytest.mark.parametrize("cache", ["cpu", "dtensor", "int8"])
def test_paths_that_launch_no_kernel(cache, one_rank, monkeypatch):
    """A CPU cache runs the wrapper's plain version; a DTensor cache keeps
    the mesh branch and an int8 cache ``_decode_attention_int8``, neither
    reaching the wrapper; the outputs equal the plain path's where the
    arithmetic is the same (the DTensor case), and no kernel launches."""
    rng = np.random.default_rng(3)
    cfg = ModelConfig(name="t", family="dense", n_layers=1, d_model=64, n_heads=4,
                      n_kv_heads=2, d_ff=128, vocab_size=256, dtype="float32")
    p, x, kv, cl = _attn(cfg, rng)
    pos = cl[:, None]
    with torch.no_grad():
        want, _ = tm.attention_apply(p, x, cfg, positions=pos,
                                     kv_cache={n: t.clone() for n, t in kv.items()},
                                     cache_len=cl)
    da.decode_attention.launches.clear()
    if cache != "cpu":
        monkeypatch.setattr(tm, "decode_attention", _not_reached)
    with torch.no_grad():
        if cache == "cpu":
            got, _ = tm.attention_apply(p, x, cfg, positions=pos, kv_cache=kv, cache_len=cl)
            assert torch.equal(got, want)
        elif cache == "dtensor":
            for name, w in list(p.named_parameters()):
                setattr(p, name, torch.nn.Parameter(
                    distribute_tensor(w, one_rank, [Replicate()]), requires_grad=False))
            dkv = {n: distribute_tensor(t, one_rank, [Replicate()]) for n, t in kv.items()}
            with implicit_replication():
                got, out_kv = tm.attention_apply(
                    p, distribute_tensor(x, one_rank, [Replicate()]), cfg, positions=pos,
                    kv_cache=dkv, cache_len=cl)
            assert out_kv is dkv
            np.testing.assert_allclose(got.full_tensor().numpy(), want.numpy(),
                                       rtol=0, atol=1e-6)
        else:
            q8 = {n: t.clamp(-1, 1).mul(127).round().to(torch.int8) for n, t in kv.items()}
            q8.update({f"{n}_scale": torch.full((3, 2, 16), 1 / 127) for n in ("k", "v")})
            got, out_kv = tm.attention_apply(p, x, cfg, positions=pos, kv_cache=q8,
                                             cache_len=cl)
            assert out_kv["k"].dtype == torch.int8 and torch.isfinite(got).all()
    assert not da.decode_attention.launches
