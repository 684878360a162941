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
banked_matmul case checks the variant that ran (``matmul_variant``).
Last, one run of the data-plane CLI on the card, its every tick served by
the fused kernel.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import bank as tbank
from repro_torch.core import packet as pkt
from repro_torch.kernels import banked_matmul as bm
from repro_torch.kernels import bnn_xnor, fused_forward as ff, ref

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


def test_serve_engine_on_the_card(dev):
    """A reduced smollm-360m (f32) served on the card by ``ServeEngine``
    built without a device: each output is the card's own no-cache greedy
    decode through ``api.apply``, and no BNN kernel is launched."""
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
    eng = ServeEngine(params, cfg, max_batch=4, max_seq=64, prefill_buckets=(8, 32))
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=5))
    outs = {f.rid: f.output for f in eng.run_until_done()}
    assert not ff.fused_forward.launches and not bm.banked_matmul.launches
    with torch.inference_mode():
        for rid, p in enumerate(prompts):
            toks, want = list(p), []
            for _ in range(5):
                logits, _ = api.apply(params, {"tokens": torch.tensor([toks], device=dev)}, cfg)
                want.append(int(torch.argmax(logits[0, -1])))
                toks.append(want[-1])
            assert outs[rid] == want, rid
