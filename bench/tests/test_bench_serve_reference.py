"""ServeEngine on the CPU against the plain reference (``configs/mamba2_lm.py``)
on seeded random weights: a reduced mamba2 with its head bank, in float32
and bfloat16.  Each request is prefilled, then decoded through the cache;
the logits of every generated position are held against the reference's
full forward over the prompt and the served tokens, within a tolerance
written with its reason.  The float8 control, the reference with float8
e4m3 matrices, lies outside the bfloat16 tolerance, and every head slot is
served."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from benchkit.spec import _module
from conftest import BENCH

ref = _module(BENCH / "configs" / "mamba2_lm.py", "bench_reference_mamba2_lm_test")
serve = _module(BENCH / "runners" / "serve.py", "bench_runner_serve_test")
CONFIG = json.loads((BENCH / "configs" / "mamba2-130m-h4.json").read_text())
SMALL = dict(n_layers=2, d_model=64, ssm_head_dim=16, ssm_state=16, ssm_chunk=16,
             vocab_size=250, vocab_pad_multiple=32)
# Largest |program - reference| over the real vocabulary's logits (unit
# scale: a unit-RMS hidden state through a fan_in ** -0.5 head).  float32:
# the same arithmetic in another order, a few ulps of the logits' sums
# (read: 1.5e-6 to 1.9e-6 over three seeds); bfloat16: the activations and
# the residual stream rounded to 8 bits of mantissa in every layer (read:
# 0.035 to 0.037).  The float8 control read 0.35 to 0.51.
TOL = {"float32": 1e-4, "bfloat16": 0.1}


def serve_and_capture(dtype, seed, n_req=12):
    from repro_torch.configs.registry import get_config
    from repro_torch.models import api
    from repro_torch.models.lm import LM
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = dataclasses.replace(get_config("mamba2-130m"),
                              **dict(CONFIG["model"], **SMALL, dtype=dtype))
    weights = serve.make_weights(LM, cfg, CONFIG["init"], seed, torch.device("cpu"))
    params = api.from_jax_params(weights, cfg, device="cpu")
    eng = ServeEngine(params, cfg, max_batch=4, max_seq=256,
                      prefill_buckets=(16, 32, 64), max_admit_wait_s=1.0, device="cpu")
    got, last = {}, {}
    real_apply, real_decode = api.apply, api.decode_step
    real_prefill, real_step = ServeEngine._prefill_into_row, ServeEngine._decode

    def apply(*a, **k):
        out = real_apply(*a, **k)
        last["logits"] = out[0]
        return out

    def decode(*a, **k):
        out = real_decode(*a, **k)
        last["logits"] = out[0]
        return out

    def prefill_into_row(self, req, row):
        real_prefill(self, req, row)
        got[req.rid] = [last["logits"][0, len(req.prompt) - 1]]

    def step(self):
        nxt = real_step(self)
        for row, req in enumerate(self.row_req):
            if self.active[row]:
                got[req.rid].append(last["logits"][row, -1])
        return nxt

    rng = np.random.default_rng(seed)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                               int(rng.integers(3, 64))).tolist(),
                    slot_id=i % cfg.bank_slots, max_new_tokens=int(rng.integers(2, 30)))
            for i in range(n_req)]
    mp = pytest.MonkeyPatch()
    with mp.context() as m:
        m.setattr(api, "apply", apply)
        m.setattr(api, "decode_step", decode)
        m.setattr(ServeEngine, "_prefill_into_row", prefill_into_row)
        m.setattr(ServeEngine, "_decode", step)
        for r in reqs:
            eng.submit(r)
        done = eng.run_until_done()
    return cfg, weights, reqs, done, got


def reference_logits(w, cfg, req, out):
    m = dataclasses.asdict(cfg)
    seq = list(req.prompt) + list(out[:-1])
    s_pad = -(-len(seq) // cfg.ssm_chunk) * cfg.ssm_chunk
    toks = torch.zeros(1, s_pad, dtype=torch.long)
    toks[0, :len(seq)] = torch.tensor(seq)
    h = ref.hidden(w, toks, m)[0, len(req.prompt) - 1:len(seq)]
    return ref.logits(w, h, torch.full((h.shape[0],), req.slot_id), m)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_matches_the_full_forward(dtype):
    cfg, weights, reqs, done, got = serve_and_capture(dtype, 2**31 + 61)
    w = ref.as_f32(weights)
    wc = ref.fp8(w)
    assert sorted(f.rid for f in done) == [r.rid for r in reqs]
    assert {r.slot_id for r in reqs} == set(range(cfg.bank_slots))
    worst = worst_ctl = 0.0
    v = cfg.vocab_size
    for f in done:
        req = reqs[f.rid]
        assert len(f.output) == req.max_new_tokens
        mine = torch.stack(got[f.rid]).float()[:, :v]
        # the engine's served tokens are its logits' greedy tokens
        assert mine.argmax(-1).tolist() == f.output
        want = reference_logits(w, cfg, req, f.output)[:, :v]
        worst = max(worst, float((mine - want).abs().max()))
        ctl = reference_logits(wc, cfg, req, f.output)[:, :v]
        worst_ctl = max(worst_ctl, float((ctl - want).abs().max()))
    assert worst <= TOL[dtype], worst
    # the control, the precision next below bfloat16, lies outside it
    assert worst_ctl > TOL["bfloat16"], worst_ctl


def test_the_reference_scan_is_the_recurrence():
    # the chunked dual form against the token-by-token recurrence
    g = torch.Generator().manual_seed(5)
    bt, s, h, p, n = 2, 32, 3, 4, 5
    x = torch.randn(bt, s, h, p, generator=g)
    dt = torch.rand(bt, s, h, generator=g) * 0.5
    a = -torch.rand(h, generator=g) * 4
    b, c = torch.randn(bt, s, n, generator=g), torch.randn(bt, s, n, generator=g)
    state = torch.zeros(bt, h, p, n)
    ys = []
    for t in range(s):
        state = (torch.exp(dt[:, t] * a)[:, :, None, None] * state
                 + dt[:, t, :, None, None] * x[:, t, :, :, None] * b[:, t, None, None, :])
        ys.append(torch.einsum("bhpn,bn->bhp", state, c[:, t]))
    want = torch.stack(ys, 1)
    for chunk in (4, 8, 32):
        assert torch.allclose(ref.ssd(x, dt, a, b, c, chunk), want, atol=1e-5, rtol=1e-5)
