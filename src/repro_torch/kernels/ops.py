"""Public wrappers over the Hopper kernels, with plain-PyTorch backends.

Backend selection:
  * ``cuda`` — the hand-written kernel (``bnn_xnor``, ``fused_forward``,
               ``banked_matmul``); given CPU tensors, those wrappers run
               their plain version.
  * ``ref``  — plain PyTorch (the oracle; any device).
  * ``mxu``  — unpack bits to +-1 floats and contract with a matrix
               product instead of popcount (the reference's dense path).
  * ``auto`` — ``cuda`` for CUDA tensors, ``ref`` for CPU tensors.
"""

from __future__ import annotations

import torch

from . import banked_matmul as _banked
from . import bnn_xnor as _bnn_xnor
from . import fused_forward as _fused
from . import ref as _ref

BACKENDS = ("auto", "cuda", "ref", "mxu")


def resolve(backend: str, like: torch.Tensor) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "auto":
        return "cuda" if like.is_cuda else "ref"
    return backend


# ---------------------------------------------------------------------------
# binary (XNOR-popcount) matmul
# ---------------------------------------------------------------------------

def xnor_matmul(x_packed, w_packed, *, backend: str = "auto"):
    """(B, W) x (H, W) int32 words -> (B, H) int32 binary dot products."""
    backend = resolve(backend, x_packed)
    if backend == "ref":
        return _ref.xnor_matmul_ref(x_packed, w_packed)
    if backend == "mxu":
        return _ref.xnor_matmul_mxu_ref(x_packed, w_packed)
    return _bnn_xnor.xnor_matmul(x_packed, w_packed)


def bnn_forward(params, x_packed, *, backend: str = "auto"):
    """Single-slot BNN forward (paper Eq. 1): -> (B, C) f32 scores."""
    pre = xnor_matmul(x_packed, params["w1p"], backend=backend).to(torch.float32)
    pre = pre + params["b1"][None, :]
    h = torch.where(pre >= 0, 1.0, -1.0)
    return h @ params["w2"].T + params["b2"][None, :]


# ---------------------------------------------------------------------------
# banked (slot-selected) execution
# ---------------------------------------------------------------------------

def bnn_forward_banked(bank, x_packed, slots, *, backend: str = "auto"):
    """Per-packet slot-selected BNN forward (take/onehot semantics).

    bank leaves are stacked (K, ...).  The grouped kernel path lives in
    ``bnn_forward_fused``.
    """
    if resolve(backend, x_packed) == "mxu":
        # onehot-style contraction: selection becomes a K-contraction.
        d = x_packed.shape[-1] * _ref.PACK
        k = bank["w1p"].shape[0]
        xv = _ref.unpack_bits(x_packed, d).to(torch.float32)       # (B, d)
        wv = _ref.unpack_bits(bank["w1p"], d).to(torch.float32)    # (K, H, d)
        onehot = torch.nn.functional.one_hot(slots.to(torch.int64), k)
        pre_all = torch.einsum("bd,khd->bkh", xv, wv)
        pre = torch.einsum("bkh,bk->bh", pre_all, onehot.to(torch.float32))
        pre = pre + bank["b1"][slots]
        h = torch.where(pre >= 0, 1.0, -1.0)
        return torch.einsum("bh,bch->bc", h, bank["w2"][slots]) + bank["b2"][slots]
    return _ref.banked_xnor_forward_ref(
        bank["w1p"], bank["b1"], bank["w2"], bank["b2"], x_packed, slots)


def bnn_forward_grouped(bank, x_packed, block_slots, *, block_b: int = 256,
                        backend: str = "auto"):
    """Grouped slot-selected BNN forward over pre-grouped rows (each
    ``block_b`` block shares a slot): the contiguous fused kernel."""
    bb = min(block_b, x_packed.shape[0])
    return bnn_forward_fused(bank, x_packed, block_slots, None, block_b=bb,
                             backend=backend)


def bnn_forward_fused(bank, x_packed, block_slots, row_ids=None, *,
                      block_b: int = 256, backend: str = "auto"):
    """Zero-copy fused BNN forward: one kernel launch that reads row
    ``row_ids[r]`` for output row r (``row_ids=None``: rows are already
    grouped).  The ref/mxu backends run the plain version."""
    fwd = _fused.fused_forward if resolve(backend, x_packed) == "cuda" \
        else _fused.fused_forward_ref
    return fwd(x_packed, bank["w1p"], bank["b1"], bank["w2"], bank["b2"],
               block_slots, row_ids, block_b=block_b)


def packet_forward_fused(bank, packets, block_slots, row_ids, *,
                         meta_words: int, block_b: int = 256,
                         backend: str = "auto", tag: str = ""):
    """Whole forwarding path in one launch: parse + select + BNN + Pi.

    ``packets`` are raw (B, meta_words + W) int32 rows in arrival order.
    Returns ``(n_rows, C) f32, (n_rows,) int32``.  A 3-D ``packets`` of
    shape (Q, B, words) (or the megastep's (T, width, words) window slab)
    is flattened: ``row_ids`` index the flattened batch and every row
    shares one launch.  ``tag`` suffixes the kernel's launch-count key.
    """
    packets = packets.reshape(-1, packets.shape[-1])
    kw = dict(block_b=block_b, meta_words=meta_words, with_actions=True)
    if resolve(backend, packets) == "cuda":
        fwd = _fused.fused_forward
        kw["tag"] = tag
    else:
        fwd = _fused.fused_forward_ref
    scores, actions = fwd(
        packets, bank["w1p"], bank["b1"], bank["w2"], bank["b2"],
        block_slots, row_ids, **kw)
    return scores, actions[:, 0]


def banked_matmul(x, w, b, block_slots, *, block_b: int = 128,
                  backend: str = "auto"):
    """Grouped slot-selected float matmul (adapter/head banks): each
    ``block_b`` block of rows runs under its slot ``block_slots[i]``."""
    fn = (_banked.banked_matmul_ref if resolve(backend, x) == "ref"
          else _banked.banked_matmul)
    return fn(x, w, b, block_slots, block_b=block_b)
