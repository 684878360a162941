"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; each test skips where there is no CUDA device.  Run on a
GPU machine with:

    python -m pytest -m cuda tests/test_torch_cuda.py

Shapes cover ragged widths (W not a multiple of 4 or 8, H below and above
32 units and not a multiple of 8, several outputs C), long rows (W = 2048
words), packet rows whose stride is not a multiple of 16 bytes (the
kernels' 4-byte loads), 16-byte aligned payload views of (B, 272) packet
rows (their 16-byte loads), the data plane's batch (B = 2048, K = 16),
``xnor_matmul`` on both CTA shapes of ``xnor_warps``, and for the banked
kernels ragged blocks, D and H, row tiles that would cross a block, H past
the wgmma column tile, out-of-range slot ids and both dtypes; each
banked_matmul case checks the variant that ran (``matmul_variant``); the
f32-output variant at the banked LM head's shape, and the bf16-output
variant as its sums rounded once.  Decode attention at
zamba2-7b-instruct.chat64-sat's shape and four others (f32 and bf16
caches, a ring, 1 to 16 query heads a group), reading nothing past a row's
length (NaN there changes no bit), and a tiny zamba2 decode step against
the CPU.
Last, one run of the data-plane CLI on the card, its every tick served by
the fused kernel; the runtime's spans under a profiler of host and device;
the LM serving engine (no kernel of the port but decode attention) and the
LM trainer (none) on the card (preempted and resumed); a sharded
train step and ``compressed_psum`` over a one-rank NCCL mesh, bit-equal to
the unsharded step and to the codec.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import bank as tbank
from repro_torch.core import packet as pkt
from repro_torch.kernels import banked_matmul as bm
from repro_torch.kernels import bnn_xnor, fused_forward as ff, ref
from repro_torch.kernels import decode_attention as da

pytestmark = pytest.mark.cuda

ATOL, RTOL = 1e-5, 1e-6


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _words(rng, shape, dev):
    a = rng.integers(0, 2**32, shape, dtype=np.uint32)
    return torch.from_numpy(a.view(np.int32)).to(dev)


def _bank(rng, k, w, h, c, dev):
    return tbank.stack_bank([ref.random_bnn_params(rng, 32 * w, h, c, device=dev)
                             for _ in range(k)])


@pytest.mark.parametrize("w,h,c", [(64, 16, 1), (256, 32, 1), (36, 20, 3), (7, 1, 2),
                                   (2048, 32, 1), (12, 32, 2)])
@pytest.mark.parametrize("meta,gather", [(16, True), (0, True), (16, False), (0, False)])
def test_fused_kernel_matches_plain(dev, w, h, c, meta, gather):
    rng = np.random.default_rng(w * 100 + h)
    k, b, bb = 5, 77, 32
    bank = _bank(rng, k, w, h, c, dev)
    rows = _words(rng, (b, 16 + w), dev)
    rows[:, 2] = torch.from_numpy(rng.integers(0, 2, b)).to(dev, torch.int32)
    x = rows[:, 16 - meta:]  # meta=0: a strided payload view
    g = tbank.group_by_slot_padded(
        torch.from_numpy(rng.integers(0, k, b)).to(dev), k, bb)
    if not gather:
        x = tbank.scatter_padded(x, g)
    args = (x, bank["w1p"], bank["b1"], bank["w2"], bank["b2"], g.block_slots,
            g.row_ids if gather else None)
    kw = dict(block_b=bb, meta_words=meta, with_actions=meta > 0)
    before = sum(ff.fused_forward.launches.values())
    got = ff.fused_forward(*args, **kw)
    want = ff.fused_forward_ref(*args, **kw)
    torch.cuda.synchronize()
    assert sum(ff.fused_forward.launches.values()) == before + 1
    if meta:
        assert torch.equal(got[1], want[1])
        got, want = got[0], want[0]
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


# (B, H, W) of the xnor_matmul cases, shared with tests/test_torch_variants.py,
# which holds the warp-count rule on the CPU: B = 1 and 33 at W = 2048 on
# both H tiles' edges, H = 40 and 7 (not multiples of 32 or 8), B = 4200 by
# H = 40 (4-warp tiles, ragged in both) and B = 8192.
XNOR_SHAPES = [
    (1, 32, 256), (33, 40, 64), (100, 7, 9), (8192, 32, 256), (1, 32, 2048),
    (1, 40, 2048), (33, 32, 2048), (33, 40, 2048), (4200, 40, 64),
]


def _xnor_matches_plain(x, wts):
    b = x.shape[0]
    before = bnn_xnor.xnor_matmul.launches[b]
    got = bnn_xnor.xnor_matmul(x, wts)
    torch.cuda.synchronize()
    assert bnn_xnor.xnor_matmul.launches[b] == before + 1
    assert torch.equal(got, ref.xnor_matmul_ref(x, wts))


@pytest.mark.parametrize("b,h,w", XNOR_SHAPES)
def test_xnor_kernel_matches_plain(dev, b, h, w):
    rng = np.random.default_rng(b + h + w)
    x = _words(rng, (b, w + 3), dev)[:, 3:]  # rows with a stride of w + 3 words
    _xnor_matches_plain(x, _words(rng, (h, w), dev))


@pytest.mark.parametrize("b,h", [(1, 32), (33, 40), (256, 7), (8192, 32)])
def test_xnor_kernel_on_packet_rows(dev, b, h):
    """Payload views of (B, 272) packet rows: 16-byte aligned with a stride
    of 272 words, so the kernel takes its 16-byte loads."""
    rng = np.random.default_rng(272 + b + h)
    rows = _words(rng, (b, pkt.META_WORDS + pkt.PAYLOAD_WORDS), dev)
    _xnor_matches_plain(pkt.payload_of(rows), _words(rng, (h, pkt.PAYLOAD_WORDS), dev))


@pytest.mark.parametrize("h", [1, 20, 32])
@pytest.mark.parametrize("stride_pad", [0, 3])
def test_fused_kernel_at_dataplane_batch(dev, h, stride_pad):
    """B = 2048 packets over K = 16 slots, block_b 256, gather mode with
    actions; stride_pad 3 makes the row stride 275 words (not a multiple
    of 16 bytes), so the kernel takes its 4-byte loads."""
    rng = np.random.default_rng(2048 + h + stride_pad)
    k, b, bb, w = 16, 2048, 256, 256
    bank = _bank(rng, k, w, h, 1, dev)
    rows = _words(rng, (b, 16 + w + stride_pad), dev)[:, :16 + w]
    rows[:, 2] = torch.from_numpy(rng.integers(0, 2, b)).to(dev, torch.int32)
    g = tbank.group_by_slot_padded(
        torch.from_numpy(rng.integers(0, k, b)).to(dev), k, bb)
    args = (rows, bank["w1p"], bank["b1"], bank["w2"], bank["b2"], g.block_slots, g.row_ids)
    kw = dict(block_b=bb, meta_words=16, with_actions=True)
    got = ff.fused_forward(*args, **kw)
    want = ff.fused_forward_ref(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1])
    torch.testing.assert_close(got[0], want[0], atol=ATOL, rtol=RTOL)


def test_kernels_reject_what_they_cannot_take(dev):
    rng = np.random.default_rng(0)
    bank = _bank(rng, 2, 8, 33, 1, dev)
    x = _words(rng, (8, 8), dev)
    slots = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="hidden"):
        ff.fused_forward(x, bank["w1p"], bank["b1"], bank["w2"], bank["b2"],
                         slots, block_b=8)
    bank = _bank(rng, 2, 8, 8, 1, dev)
    with pytest.raises(ValueError, match="one device"):
        ff.fused_forward(x, bank["w1p"].cpu(), bank["b1"], bank["w2"],
                         bank["b2"], slots, block_b=8)
    # No kernel keeps a row in shared memory: W = 2048 is taken, and
    # matches the plain version.
    x_long, w_long = _words(rng, (1, 2048), dev), _words(rng, (1, 2048), dev)
    assert torch.equal(bnn_xnor.xnor_matmul(x_long, w_long), ref.xnor_matmul_ref(x_long, w_long))
    args = (_words(rng, (8, 2048), dev), _words(rng, (2, 8, 2048), dev),
            bank["b1"], bank["w2"], bank["b2"], slots)
    torch.testing.assert_close(ff.fused_forward(*args, block_b=8),
                               ff.fused_forward_ref(*args, block_b=8), atol=ATOL, rtol=RTOL)


def _banked_xnor_matches_plain(rng, x, h, k, bb, dev):
    b, w = x.shape
    w1 = _words(rng, (k, h, w), dev)
    b1 = torch.from_numpy(rng.normal(size=(k, h)).astype(np.float32)).to(dev)
    slots = torch.from_numpy(rng.integers(-1, k + 1, b // bb)).to(dev)  # clamped
    before = bm.banked_xnor_layer1.launches
    got = bm.banked_xnor_layer1(x, w1, b1, slots, block_b=bb)
    want = bm.banked_xnor_layer1_ref(x, w1, b1, slots, block_b=bb)
    torch.cuda.synchronize()
    assert bm.banked_xnor_layer1.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("b,bb,h,w,k", [
    (64, 32, 32, 256, 4), (90, 45, 7, 9, 3), (40, 40, 1, 64, 2), (8192, 256, 32, 256, 32),
    (96, 48, 32, 2048, 3), (33, 33, 20, 2048, 2),
])
def test_banked_xnor_layer1_matches_plain(dev, b, bb, h, w, k):
    rng = np.random.default_rng(b + h + w)
    x = _words(rng, (b, w + 5), dev)[:, 5:]  # rows with a stride of w + 5 words
    _banked_xnor_matches_plain(rng, x, h, k, bb, dev)


@pytest.mark.parametrize("b,bb,h,k", [(8192, 256, 32, 16), (90, 45, 7, 3)])
def test_banked_xnor_layer1_on_packet_rows(dev, b, bb, h, k):
    """Payload views of (B, 272) packet rows: the 16-byte loads."""
    rng = np.random.default_rng(272 + b + h)
    rows = _words(rng, (b, pkt.META_WORDS + pkt.PAYLOAD_WORDS), dev)
    _banked_xnor_matches_plain(rng, pkt.payload_of(rows), h, k, bb, dev)


# Shared with tests/test_torch_variants.py, which holds the variant rule on
# the CPU: (B, block_b, D, H, K).  (320, 160, 64, 200, 3): block_b is not a
# multiple of the 128-row tile and H = 200 is not a multiple of the column
# tile; (192, 96, 64, 64, 2): a 128-row tile would cross a block.
MATMUL_SHAPES = [
    (64, 16, 16, 8, 3), (120, 40, 37, 70, 2), (256, 128, 960, 960, 4), (33, 33, 1, 5, 1),
    (320, 160, 64, 200, 3), (192, 96, 64, 64, 2), (256, 128, 72, 36, 2),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,bb,d,h,k", MATMUL_SHAPES)
def test_banked_matmul_matches_plain(dev, dtype, b, bb, d, h, k):
    rng = np.random.default_rng(b + d + h)
    x, w, bias = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dev, dtype)
                  for s in ((b, d), (k, d, h), (k, h)))
    slots = torch.from_numpy(rng.integers(-1, k + 1, b // bb)).to(dev)  # clamped
    slots[0] = k + 5  # at least one slot id out of range
    kind = bm.matmul_variant(dtype, d, h)
    before = bm.banked_matmul.launches[kind]
    got = bm.banked_matmul(x, w, bias, slots, block_b=bb)
    want = bm.banked_matmul_ref(x, w, bias, slots, block_b=bb)
    torch.cuda.synchronize()
    assert bm.banked_matmul.launches[kind] == before + 1
    assert got.dtype == dtype
    # f32: another summation order over d terms; bf16: one rounding of that
    tol = dict(atol=1e-2, rtol=1e-2) if dtype == torch.bfloat16 else dict(atol=2e-3, rtol=1e-5)
    torch.testing.assert_close(got.float(), want.float(), **tol)


# The banked LM head (``models.lm.banked_logits``): mamba2-130m's D and
# padded vocabulary, 256 rows over 4 slots in ragged counts, grouped by slot
# as the head groups them (``group_head_rows``): the blocks past the last
# slot's rows are padding only, and 50,288 columns end in a ragged
# 192-column tile.
HEAD_D, HEAD_V, HEAD_ROWS = 768, 50288, (90, 7, 0, 159)


def test_head_kernel_matches_plain(dev):
    from repro_torch.models.lm import HEAD_BLOCK_B, group_head_rows
    rng = np.random.default_rng(31)
    k = len(HEAD_ROWS)
    slots = torch.from_numpy(rng.permutation(np.repeat(np.arange(k), HEAD_ROWS))).to(dev)
    g, block_slots = group_head_rows(slots, k)
    x, w = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dev, torch.bfloat16)
            for s in ((len(slots), HEAD_D), (k, HEAD_D, HEAD_V)))
    xs = tbank.scatter_padded(x, g)
    assert g.b_pad - int(g.dest.max()) - 1 >= HEAD_BLOCK_B  # a block of padding only
    key = "bf16/wgmma.f32out/head"
    before = bm.banked_matmul.launches[key]
    kw = dict(block_b=HEAD_BLOCK_B, out_dtype=torch.float32)
    got = bm.banked_matmul(xs, w, None, block_slots, tag="/head", **kw)
    want = bm.banked_matmul_ref(xs, w, None, block_slots, **kw)
    absref = bm.banked_matmul_ref(xs.abs(), w.abs(), None, block_slots, **kw)
    torch.cuda.synchronize()
    assert bm.banked_matmul.launches[key] == before + 1
    assert got.dtype == torch.float32 and got.shape == (g.b_pad, HEAD_V)
    # the same exact bf16 products summed in f32 in two orders: within
    # 2 D u sum|terms|
    rows = g.dest.long()
    diff = (got[rows] - want[rows]).abs()
    assert bool((diff <= 2 * HEAD_D * 2.0 ** -24 * absref[rows]).all())


@pytest.mark.parametrize("b,bb,d,h,k", [s for s in MATMUL_SHAPES
                                        if bm.matmul_variant(torch.bfloat16, s[2], s[3])
                                        == "bf16/wgmma"])
def test_wgmma_bf16_out_is_the_f32_sums_rounded_once(dev, b, bb, d, h, k):
    """``bf16/wgmma`` writes what ``bf16/wgmma.f32out`` sums, with the bias
    added in f32 and rounded once to bf16: one accumulation in both
    epilogues."""
    rng = np.random.default_rng(b + d + h)
    x, w, bias = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dev, torch.bfloat16)
                  for s in ((b, d), (k, d, h), (k, h)))
    slots = torch.from_numpy(rng.integers(0, k, b // bb)).to(dev)
    got = bm.banked_matmul(x, w, bias, slots, block_b=bb)
    sums = bm.banked_matmul(x, w, None, slots, block_b=bb, out_dtype=torch.float32)
    row_bias = bias.float()[slots.long().repeat_interleave(min(bb, b))]
    torch.cuda.synchronize()
    assert torch.equal(got, (sums + row_bias).to(torch.bfloat16))


def test_banked_kernels_reject_what_they_cannot_take(dev):
    rng = np.random.default_rng(1)
    slots = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="hidden"):
        bm.banked_xnor_layer1(_words(rng, (8, 8), dev), _words(rng, (2, 33, 8), dev),
                              torch.zeros(2, 33, device=dev), slots, block_b=8)
    x = torch.zeros(8, 4, device=dev)
    with pytest.raises(TypeError, match="dtype"):
        bm.banked_matmul(x, torch.zeros(2, 4, 3, device=dev, dtype=torch.float16),
                         torch.zeros(2, 3, device=dev), slots, block_b=8)
    with pytest.raises(ValueError, match="one device"):
        bm.banked_matmul(x, torch.zeros(2, 4, 3), torch.zeros(2, 3, device=dev),
                         slots, block_b=8)


# Decode attention (``kernels.decode_attention``): (rows, groups, query heads
# a group, head dim, cache positions, cache dtype, ring cache).  First
# zamba2-7b-instruct.chat64-sat's sites, then phase 9 (a)'s f32 smollm-360m,
# glm4-9b's 16 heads a group over a cache that ends inside a chunk, a
# reduced ring cache and the least head dim.
DECODE_SHAPES = [
    (64, 32, 1, 224, 1536, torch.bfloat16, False),
    (8, 5, 3, 64, 512, torch.float32, False),
    (6, 2, 16, 128, 300, torch.bfloat16, False),
    (5, 2, 2, 16, 32, torch.float32, True),
    (3, 1, 5, 8, 700, torch.bfloat16, False),
]


def _decode_inputs(shape, seed, dev):
    """q, and K and V as layer 1 of a stacked (2, B, G, L, D) cache (the
    engine's layout); cache lengths for chat64-sat's mix (ShareGPT's
    log-normal means 161.31 in and 337.99 out, sigma 1.0 and 0.7, cut at 512
    and 1024, a row part-way through its output), else uniform over [0, 2 L);
    rows 0 to 2 at 0, L - 1 and past L (clamped by both masks)."""
    b, g, gq, d, lc, dtype, ring = shape
    rng = np.random.default_rng(seed)
    if lc == 1536:
        prompt = np.minimum(rng.lognormal(np.log(161.31) - 0.5, 1.0, b), 512).astype(int)
        out = np.minimum(rng.lognormal(np.log(337.99) - 0.245, 0.7, b), 1024).astype(int)
        cl = prompt + (rng.random(b) * out).astype(int)
    else:
        cl = rng.integers(0, 2 * lc, b)
    cl[:3] = [0, lc - 1, lc + 3 if not ring else 5 * lc + 2]
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, cache = (torch.randn(s, generator=gen, device=dev, dtype=dtype)
                for s in ((b, g, gq, 1, d), (2, 2, b, g, lc, d)))
    return q, cache[0, 1], cache[1, 1], torch.from_numpy(cl).to(dev)


def _decode_tolerance(want, absref, d, lc, kv_dtype, out_dtype):
    """The kernel and the plain version sum the D-term scores and the L-term
    value products in other orders (within 2 (D + L) u of the sums of
    absolute terms, u f32's unit roundoff); a bf16 cache rounds each
    probability, which may land one bf16 ulp (2**-7 relative) apart, and a
    bf16 output may round one ulp apart."""
    rel = 2 * (d + lc) * 2.0 ** -24 + (2.0 ** -7 if kv_dtype == torch.bfloat16 else 0.0)
    out_ulp = 2.0 ** -7 if out_dtype == torch.bfloat16 else 0.0
    return rel * absref + out_ulp * want.abs()


@pytest.mark.parametrize("shape", DECODE_SHAPES)
def test_decode_attention_kernel_matches_plain(dev, shape):
    b, g, gq, d, lc, dtype, ring = shape
    q, k, v, cl = _decode_inputs(shape, b * d + lc, dev)
    scale = d ** -0.5
    key = str(dtype).removeprefix("torch.")
    before = da.decode_attention.launches[key]
    got = da.decode_attention(q, k, v, cl, scale, dtype)
    again = da.decode_attention(q, k, v, cl, scale, dtype)
    want = da.decode_attention_ref(q, k, v, cl, scale, torch.float32)
    absref = da.decode_attention_ref(q, k, v.abs(), cl, scale, torch.float32)
    torch.cuda.synchronize()
    assert da.decode_attention.launches[key] == before + 2
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.equal(got, again)  # sums in a fixed order
    diff = (got.float() - want).abs()
    assert bool((diff <= _decode_tolerance(want, absref, d, lc, dtype, dtype)).all()), \
        float(diff.max())


def test_decode_attention_reads_no_position_past_a_rows_length(dev):
    """Every K and V position at or past min(cache_len + 1, L) set to NaN:
    the kernel's output is the same to the bit."""
    shape = DECODE_SHAPES[0]
    q, k, v, cl = _decode_inputs(shape, 5, dev)
    lc, scale = shape[4], shape[3] ** -0.5
    clean = da.decode_attention(q, k, v, cl, scale, torch.bfloat16)
    past = torch.arange(lc, device=dev)[None, :] >= torch.clamp(cl + 1, max=lc)[:, None]
    assert bool(past.any())
    for t in (k, v):
        t.masked_fill_(past[:, None, :, None], float("nan"))
    poisoned = da.decode_attention(q, k, v, cl, scale, torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(clean, poisoned)


def test_decode_attention_refuses_what_it_cannot_take(dev):
    q = torch.zeros(2, 1, 1, 1, 12, device=dev)
    cl = torch.zeros(2, dtype=torch.int64, device=dev)
    kv = torch.zeros(2, 1, 16, 12, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        da.decode_attention(q, kv, kv, cl, 1.0, torch.float32)
    q, kv = torch.zeros(2, 1, 1, 1, 16, device=dev), torch.zeros(2, 1, 16, 16, device=dev)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        da.decode_attention(q, kv.half(), kv.half(), cl, 1.0, torch.float32)
    odd = torch.zeros(2, 1, 16, 18, device=dev)[..., 1:17]
    with pytest.raises(ValueError, match="16-byte"):
        da.decode_attention(q, odd, odd, cl, 1.0, torch.float32)


def test_zamba2_decode_step_on_the_card(dev):
    """One decode step of a tiny zamba2 (f32, three sites) from a random
    cache with rows at their own lengths, on the card against the CPU: a
    prefill launches no decode attention; the logits within 2e-4 (f32 in
    other orders, as the CPU tests hold the port to the float32
    reference), the written caches within 1e-4, and the kernel launched
    once a site."""
    import copy
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.models import api

    cfg = dataclasses.replace(
        get_config("zamba2-7b-instruct"), n_layers=8, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=32, d_ff=96, ssm_state=16, ssm_head_dim=16, ssm_chunk=16,
        hybrid_layer_ids=(1, 3, 6), shared_adapter_rank=8, vocab_size=250,
        vocab_pad_multiple=32, dtype="float32")
    params = api.init(0, cfg, device="cpu")
    rng = np.random.default_rng(11)
    cache = api.init_cache(cfg, 3, 64, device="cpu")

    def fill(t):
        if isinstance(t, dict):
            return {n: fill(x) for n, x in t.items()}
        return torch.from_numpy((rng.standard_normal(t.shape) * 0.5).astype(np.float32))
    cache = fill(cache)
    card_cache = {n: {m: x.to(dev) for m, x in c.items()} if isinstance(c, dict) else c.to(dev)
                  for n, c in copy.deepcopy(cache).items()}
    tokens = torch.from_numpy(rng.integers(0, 250, (3, 1)))
    cl = torch.tensor([0, 17, 63])
    card = copy.deepcopy(params).to(dev)
    da.decode_attention.launches.clear()
    with torch.inference_mode():
        api.apply(card, {"tokens": torch.from_numpy(rng.integers(0, 250, (2, 40))).to(dev)}, cfg)
        torch.cuda.synchronize()
        assert not da.decode_attention.launches  # a prefill runs the flash loop
        want, cache = api.decode_step(params, tokens, cache, cl, cfg)
        got, card_cache = api.decode_step(card, tokens.to(dev), card_cache, cl.to(dev), cfg)
    torch.cuda.synchronize()
    assert dict(da.decode_attention.launches) == {"float32": len(cfg.hybrid_layer_ids)}
    np.testing.assert_allclose(got.cpu().numpy()[..., :250], want.numpy()[..., :250],
                               rtol=0, atol=2e-4)
    for n in ("k", "v"):
        np.testing.assert_allclose(card_cache["kv"][n].cpu().numpy(), cache["kv"][n].numpy(),
                                   rtol=0, atol=1e-4)


def test_dataplane_cli_on_the_card(dev, tmp_path):
    """``python -m repro_torch.launch.dataplane --queues 4 --audit`` in
    process, on its default device: conserved, no wrong verdict, and the
    fused kernel launched (one launch per live queue per tick)."""
    import json

    from repro_torch.launch import dataplane

    ff.fused_forward.launches.clear()
    out = tmp_path / "report.json"
    dataplane.main(["--queues", "4", "--audit", "--json", str(out)])
    doc = json.loads(out.read_text())
    aud = doc["snapshot"]["conservation"]
    assert aud["ok"] and aud["wrong_verdict"] == 0 and doc["continuity"]["ok"]
    assert ff.fused_forward.launches.get("gather/meta16/actions", 0) > 0


def test_dataplane_spans_on_the_card(dev):
    """The runtime's spans on the card, under a profiler of host and device:
    every span of the tree recorded (the wait on the tick's event too), the
    same verdicts as with the recorder off, and no span counted as device
    work (a mirror on the device timeline, if any, is a user annotation)."""
    from repro_torch.core import executor
    from repro_torch.dataplane import DataplaneRuntime
    from repro_torch.spans import SPAN_NAMES

    rng = np.random.default_rng(27)
    bank = executor.init_bank(rng, 16, device=dev)
    bursts = []
    for _ in range(6):
        rows = rng.integers(0, 2**32, (8192, 272), dtype=np.uint32)
        rows[:, 0] = rng.integers(0, 16, 8192)
        rows[:, 15] = np.arange(8192)
        bursts.append(rows)

    def run(spans: bool):
        rt = DataplaneRuntime(bank, num_queues=4, batch=2048, ring_capacity=16384,
                              record=True, device=dev)
        rt.on_retire = lambda *args: None
        if spans:
            rt.spans.start()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for rows in bursts:
                rt.dispatch(rows)
                rt.tick()
            rt.drain()
        rt.spans.stop()
        return rt, prof

    off, _ = run(False)
    on, prof = run(True)
    assert on.completed_verdicts == off.completed_verdicts
    assert on.completed_slots == off.completed_slots
    s = on.spans.summary()
    assert set(s) == set(SPAN_NAMES)
    assert s["dp.tick.stage"]["rows"] == 6 * 8192 and s["dp.retire.wait"]["count"] > 0
    host = [e.name for e in prof.events()
            if e.device_type != torch.autograd.DeviceType.CUDA]
    assert set(SPAN_NAMES) <= set(host)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.name.startswith("dp."):
            assert getattr(e, "is_user_annotation", False), e.name


def test_serve_engine_on_the_card(dev):
    """A reduced smollm-360m (f32) served on the card by ``ServeEngine``
    built without a device: each output is the card's own no-cache greedy
    decode through ``api.apply``; no BNN kernel is launched, and the decode
    attention runs on its f32 kernel."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import api
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = get_config("smollm-360m").reduced(remat="none", dtype="float32")
    params = api.init(0, cfg)
    assert params.embed.embedding.device.type == "cuda"
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (5, 9, 17)]
    ff.fused_forward.launches.clear()
    bm.banked_matmul.launches.clear()
    da.decode_attention.launches.clear()
    eng = ServeEngine(params, cfg, max_batch=4, max_seq=64, prefill_buckets=(8, 32))
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=5))
    outs = {f.rid: f.output for f in eng.run_until_done()}
    assert not ff.fused_forward.launches and not bm.banked_matmul.launches
    assert set(da.decode_attention.launches) == {"float32"}
    with torch.inference_mode():
        for rid, p in enumerate(prompts):
            toks, want = list(p), []
            for _ in range(5):
                logits, _ = api.apply(params, {"tokens": torch.tensor([toks], device=dev)}, cfg)
                want.append(int(torch.argmax(logits[0, -1])))
                toks.append(want[-1])
            assert outs[rid] == want, rid


def test_trainer_on_the_card(dev, tmp_path):
    """A reduced smollm-360m (f32) trained on the card by ``Trainer`` built
    without a device: 4 steps preempted by the flag file and resumed to 8
    equal 8 uninterrupted steps (within 1e-5), the loss is finite, and no
    BNN kernel is launched."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.tokens import SyntheticTokens, TokenPipelineConfig
    from repro_torch.train.loop import Trainer, TrainerConfig
    from repro_torch.train.optimizer import OptimizerConfig

    cfg = get_config("smollm-360m").reduced(n_layers=1, remat="full", dtype="float32")
    flag = tmp_path / "preempt"

    def trainer(name, **kw):
        return Trainer(cfg, OptimizerConfig(warmup_steps=0, learning_rate=1e-3),
                       TrainerConfig(total_steps=8, checkpoint_every=100,
                                     checkpoint_dir=str(tmp_path / name), **kw),
                       SyntheticTokens(TokenPipelineConfig(
                           vocab_size=cfg.vocab_size, seq_len=16, global_batch=4)))
    ff.fused_forward.launches.clear()
    bm.banked_matmul.launches.clear()
    full = trainer("full")
    assert full.state["params"].embed.embedding.device.type == "cuda"
    full.run()
    cut = trainer("cut", preempt_flag_file=str(flag))
    real = cut.step_fn

    def step(state, batch):
        out = real(state, batch)
        if int(state["step"]) == 4:
            flag.write_text("now")
        return out
    cut.step_fn = step
    assert cut.run() == {"status": "preempted", "steps_run": 4}
    resumed = trainer("cut")
    assert resumed.try_restore() and int(resumed.state["step"]) == 4
    resumed.run()
    assert not ff.fused_forward.launches and not bm.banked_matmul.launches
    assert all(np.isfinite(m["loss"]) for m in full.metrics_log)
    for a, b in zip(full.state["params"].parameters(), resumed.state["params"].parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


@pytest.fixture
def nccl_rank(dev):
    """A one-rank NCCL group (address and port given here: nothing tells a
    program of a cluster) and its (1, 1) host mesh; destroyed after."""
    import socket

    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    yield make_host_mesh()
    dist.destroy_process_group()


def test_sharded_step_on_the_card(dev, nccl_rank):
    """A reduced smollm-360m (bf16, master copy) sharded by the dry-run's
    rules over the one-rank NCCL mesh: 2 steps bit-equal to the same steps
    unsharded, no BNN kernel launched."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs.registry import get_config
    from repro_torch.distributed import sharding
    from repro_torch.launch import dryrun
    from repro_torch.train import train_step as ts
    from repro_torch.train.optimizer import OptimizerConfig

    cfg = get_config("smollm-360m").reduced(remat="full")
    opt = OptimizerConfig(warmup_steps=0, learning_rate=1e-3)
    plain = ts.init_train_state(0, cfg, opt, device=dev)
    shard = ts.init_train_state(0, cfg, opt, device=dev)
    rules = dryrun.rules_for(cfg, "train", nccl_rank)
    pspecs, _ = sharding.legalize(sharding.param_specs(shard["params"], rules),
                                  dict(shard["params"].named_parameters()), nccl_rank)
    shard, _ = sharding.distribute_state(
        shard, nccl_rank, {"params": pspecs, "opt": sharding.opt_state_specs(pspecs, shard["opt"])})
    step = ts.make_train_step(cfg, opt)
    rng = np.random.default_rng(0)
    ff.fused_forward.launches.clear()
    bm.banked_matmul.launches.clear()
    for _ in range(2):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32))
        batch = {"tokens": toks.to(dev), "labels": toks.roll(-1, 1).to(dev)}
        _, mp = step(plain, batch)
        bspecs = sharding.batch_specs(batch, rules)
        with implicit_replication():
            _, ms = step(shard, sharding.distribute_tree(batch, nccl_rank, bspecs))
        for k in ("loss", "grad_norm"):
            assert float(ms[k].full_tensor()) == float(mp[k]), k
    whole = sharding.gather_state(shard)
    for x, y in zip(whole["params"].parameters(), plain["params"].parameters()):
        assert torch.equal(x, y)
    assert not ff.fused_forward.launches and not bm.banked_matmul.launches


def test_compressed_psum_on_the_card(dev, nccl_rank):
    """``compressed_psum`` over the one-rank NCCL group: the codec's bits."""
    from repro_torch.distributed import compress

    g = torch.Generator(device=dev).manual_seed(0)
    for shape, dtype in (((960, 2560), torch.bfloat16), ((49152,), torch.float32)):
        x = torch.randn(shape, generator=g, device=dev).to(dtype)
        assert torch.equal(compress.compressed_psum(x, nccl_rank, "data"),
                           compress.quantize_dequantize(x))
