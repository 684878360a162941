"""The banked LM head grouped by slot (``models.lm.banked_logits``).

Where autograd records nothing, on plain tensors and a bf16 bank, the head
groups its rows by slot and runs ``banked_matmul``'s f32-output variant,
whose plain version runs here on the CPU.  It is held against the path it
replaces (each row's slot gathered, both operands copied to f32, ``bmm``)
and against the reference's ``_final_logits`` (its ``einsum`` of bf16
operands with ``preferred_element_type=float32``) on the same bf16 weights:
decode rows 1, 7 and 256 with the slots uniform, all on one and one left
empty; prefills of 32 and 512 tokens; the published padded vocabulary
(50,277 to 50,288).  Both sum the same exact products in f32, so they may
differ by the order of the sums only.  Then when the path engages (grad
mode, an f32 bank), its span in a serving engine and the variant rule for
an f32 output.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401
from repro.configs import registry as jreg
from repro.models import lm as jlm
from repro_torch.configs import registry as treg
from repro_torch.kernels import banked_matmul as tbm
from repro_torch.models import api as tapi
from repro_torch.models import lm as tlm
from repro_torch.nn import modules as tnn
from repro_torch.serve.engine import Request, ServeEngine

K = 4
F32_MIN = torch.finfo(torch.float32).min


def _cfgs(**over):
    over = {"remat": "none", "dtype": "bfloat16", "bank_mode": "head",
            "bank_slots": K, "vocab_size": 250, **over}
    return (jreg.get_config("mamba2-130m").reduced(**over),
            treg.get_config("mamba2-130m").reduced(**over))


def _slots(rng, rows, pattern):
    if pattern == "uniform":
        return rng.integers(0, K, rows)
    if pattern == "one_slot":
        return np.full(rows, 2)
    return rng.choice([0, 1, 3], rows)  # slot 2 empty


def _head(rng, tcfg):
    """The final norm and a bf16 bank of K heads, as the port's modules."""
    w = torch.from_numpy(rng.normal(size=(K, tcfg.d_model, tcfg.padded_vocab))
                         .astype(np.float32) * tcfg.d_model ** -0.5).to(torch.bfloat16)
    scale = torch.from_numpy(rng.normal(1.0, 0.1, tcfg.d_model).astype(np.float32))
    return types.SimpleNamespace(
        final_norm=types.SimpleNamespace(scale=scale.to(torch.bfloat16)),
        bank_head=types.SimpleNamespace(w=w))


def _reference(params, x, jcfg, slot_ids):
    """The reference's ``_final_logits`` on the same bf16 values."""
    bf = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)  # noqa: E731
    jp = {"final_norm": {"scale": bf(params.final_norm.scale)},
          "bank_head": {"w": bf(params.bank_head.w)}}
    return np.asarray(jlm._final_logits(jp, bf(x), jcfg, jnp.asarray(slot_ids.numpy())),
                      np.float32)


# (rows, tokens a row, slots, vocabulary): decode steps, two prefills, and
# the published vocabulary padded to 50,288
CASES = [(rows, 1, pattern, 250) for rows in (1, 7, 256)
         for pattern in ("uniform", "one_slot", "slot_empty")]
CASES += [(1, 32, "one_slot", 250), (1, 512, "one_slot", 250), (7, 1, "uniform", 50277)]


@pytest.mark.parametrize("rows,t,pattern,vocab", CASES)
def test_grouped_head_matches_gather_and_reference(rows, t, pattern, vocab):
    jcfg, tcfg = _cfgs(vocab_size=vocab, vocab_pad_multiple=16)
    assert tcfg.padded_vocab == (50288 if vocab == 50277 else 256)
    rng = np.random.default_rng(rows * 1000 + t)
    params = _head(rng, tcfg)
    x = torch.from_numpy(rng.normal(size=(rows, t, tcfg.d_model)).astype(np.float32)) \
        .to(torch.bfloat16)
    slot_ids = torch.from_numpy(_slots(rng, rows, pattern))
    with torch.inference_mode():
        got = tlm._final_logits(params, x, tcfg, slot_ids)
    gather = tlm._final_logits(params, x, tcfg, slot_ids)  # grad mode on: each row's slot
    want = torch.from_numpy(_reference(params, x, jcfg, slot_ids))
    assert got.dtype == torch.float32 and got.shape == (rows, t, tcfg.padded_vocab)

    # f32 sums of d exact products in two orders: each within d u sum|p|
    xn = tnn.rmsnorm(params.final_norm, x, tcfg.norm_eps).float()
    absref = torch.einsum("bsd,bdv->bsv", xn.abs(),
                          params.bank_head.w.float().abs()[slot_ids])
    tol = 2 * tcfg.d_model * 2.0 ** -24 * absref + 1e-30
    real = slice(0, tcfg.vocab_size)
    for other in (gather, want):
        assert bool(((got - other).abs()[..., real] <= tol[..., real]).all())
        assert bool((other[..., tcfg.vocab_size:] == F32_MIN).all())
    assert bool((got[..., tcfg.vocab_size:] == F32_MIN).all())
    # the argmax agrees wherever the top two lie further apart than that
    top2 = torch.topk(want[..., real], 2, dim=-1)
    clear = (top2.values[..., 0] - top2.values[..., 1]) > 2 * tol[..., real].amax(-1)
    assert bool((got.argmax(-1) == want.argmax(-1))[clear].all())
    assert bool((gather.argmax(-1) == want.argmax(-1))[clear].all())


@pytest.mark.parametrize("mode,bank_dtype,engaged", [
    ("inference", torch.bfloat16, True), ("no_grad", torch.bfloat16, True),
    ("grad", torch.bfloat16, False), ("inference", torch.float32, False),
])
def test_head_path_engages_outside_autograd_on_a_bf16_bank(monkeypatch, mode, bank_dtype,
                                                           engaged):
    """The grouped path runs ``banked_matmul`` once, tagged ``/head``, where
    autograd records nothing and the bank is bf16; training and an f32 bank
    keep the gather path."""
    _, tcfg = _cfgs(dtype=str(bank_dtype).removeprefix("torch."))
    calls = []
    real = tlm.banked_matmul

    def spy(*args, **kw):
        calls.append(kw["tag"])
        return real(*args, **kw)

    monkeypatch.setattr(tlm, "banked_matmul", spy)
    rng = np.random.default_rng(5)
    params = _head(rng, tcfg)
    params.bank_head.w = params.bank_head.w.to(bank_dtype).requires_grad_(True)
    x = torch.randn(7, 1, tcfg.d_model).to(bank_dtype)
    slot_ids = torch.from_numpy(rng.integers(0, K, 7))
    ctx = {"inference": torch.inference_mode, "no_grad": torch.no_grad,
           "grad": torch.enable_grad}[mode]
    with ctx():
        logits = tlm._final_logits(params, x, tcfg, slot_ids)
    assert calls == (["/head"] if engaged else [])
    assert logits.requires_grad == (mode == "grad")


def test_serve_engine_head_span_and_counts(monkeypatch):
    """A served bf16 head bank: one grouped head a prefill and a decode
    step, and a ``serve.decode.head`` span a step with its rows and the
    padding of their grouping (rows + K blocks, rounded to a block)."""
    _, tcfg = _cfgs()
    calls = []
    real = tlm.banked_matmul

    def spy(x, *args, **kw):
        calls.append(x.shape[0])
        return real(x, *args, **kw)

    monkeypatch.setattr(tlm, "banked_matmul", spy)
    params = tapi.init(0, tcfg, device="cpu")
    eng = ServeEngine(params, tcfg, max_batch=4, max_seq=64, prefill_buckets=(8, 32),
                      device="cpu")
    rng = np.random.default_rng(3)
    for rid, n in enumerate((5, 9, 17)):
        eng.submit(Request(rid=rid, prompt=rng.integers(0, tcfg.vocab_size, n).tolist(),
                           slot_id=rid % K, max_new_tokens=4))
    eng.spans.start()
    outs = eng.run_until_done()
    summary = eng.spans.summary()
    decodes = summary["serve.decode"]["count"]
    head = summary["serve.decode.head"]
    b = tlm.HEAD_BLOCK_B
    b_pad = -(-(eng.max_batch + K * b) // b) * b
    assert head["count"] == decodes and head["parent"] == "serve.decode"
    assert head["rows"] == decodes * eng.max_batch
    assert head["padded"] == decodes * (b_pad - eng.max_batch)
    assert sorted(calls) == sorted([b_pad] * decodes + [-(-(8 + K * b) // b) * b]
                                   + [-(-(32 + K * b) // b) * b] * 2)
    assert all(len(f.output) == 4 for f in outs)


@pytest.mark.parametrize("dtype,d,h,aligned,out,want", [
    (torch.bfloat16, 768, 50288, True, torch.float32, "bf16/wgmma.f32out"),
    (torch.bfloat16, 768, 50288, True, torch.bfloat16, "bf16/wgmma"),
    (torch.bfloat16, 37, 70, True, torch.float32, ValueError),
    (torch.bfloat16, 768, 50288, False, torch.float32, ValueError),
    (torch.float32, 768, 50288, True, torch.float32, "f32/fma"),
    (torch.float32, 768, 50288, True, torch.bfloat16, TypeError),
])
def test_matmul_variant_of_an_f32_output(dtype, d, h, aligned, out, want):
    if isinstance(want, str):
        assert tbm.matmul_variant(dtype, d, h, aligned, out) == want
    else:
        with pytest.raises(want):
            tbm.matmul_variant(dtype, d, h, aligned, out)


def test_banked_matmul_f32_out_on_the_cpu():
    """bf16 operands, f32 output, no bias: each block's rows times its slot
    in f32, nothing rounded to bf16."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.normal(size=(256, 64)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.normal(size=(K, 64, 96)).astype(np.float32)).to(torch.bfloat16)
    block_slots = torch.tensor([3, 0, 0, 1])
    got = tbm.banked_matmul(x, w, None, block_slots, block_b=64, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    for i, s in enumerate(block_slots.tolist()):
        want = x[64 * i:64 * (i + 1)].float() @ w[s].float()
        torch.testing.assert_close(got[64 * i:64 * (i + 1)], want, rtol=1e-6, atol=1e-5)
    assert tbm.banked_matmul.launches == {}  # CPU tensors: the plain version


@pytest.mark.parametrize("dtype,out,bias", [
    (torch.bfloat16, torch.float32, True),    # the head's output with a bias
    (torch.bfloat16, None, False),            # bf16 out without one
    (torch.float32, torch.float32, False),    # f32 without one
])
def test_banked_matmul_takes_no_bias_exactly_with_an_f32_output_from_bf16(dtype, out, bias):
    """One rule, in the argument checks of the kernel and its plain version
    alike: bf16 operands with an f32 output take ``b=None``, every other
    pair of dtypes a bias."""
    x, w = torch.zeros(64, 16, dtype=dtype), torch.zeros(K, 16, 8, dtype=dtype)
    b = torch.zeros(K, 8, dtype=dtype) if bias else None
    slots = torch.zeros(1, dtype=torch.int32)
    for fn in (tbm.banked_matmul, tbm.banked_matmul_ref):
        with pytest.raises(ValueError, match="b=None exactly"):
            fn(x, w, b, slots, block_b=64, out_dtype=out)
