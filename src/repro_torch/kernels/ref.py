"""Plain PyTorch oracles for every kernel of this package.

Conventions (as in the reference):

* Bit packing: a {+1,-1} vector is stored as 32-bit words, little-endian
  within the word; bit ``b`` encodes value ``1 - 2b``.  Words travel as
  ``torch.int32`` tensors holding the reference's ``uint32`` bits.
* ``d`` (input bits) must be a multiple of 32.
* The binary dot product of two +-1 vectors of length d packed as words
  x, w is ``d - 2 * popcount(x XOR w)``.

``>>`` on int32 is an arithmetic shift, so the bit arithmetic here widens
to int64 and masks to the low 32 bits first.
"""

from __future__ import annotations

import numpy as np
import torch

PACK = 32
_MASK32 = 0xFFFFFFFF

# Rows per slice of the (rows, H, W) XOR intermediate: keeps the int64
# popcount temporaries of a full-width (H32) oracle near 100 MB at any B.
_ROW_CHUNK = 512


# ---------------------------------------------------------------------------
# packing helpers
# ---------------------------------------------------------------------------

def to_int32_bits(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 with the same low 32 bits."""
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def pack_bits(x_pm1: torch.Tensor) -> torch.Tensor:
    """Pack a (+1/-1) tensor of shape (..., d) into (..., d//32) int32 words."""
    d = x_pm1.shape[-1]
    if d % PACK:
        raise ValueError(f"d={d} must be a multiple of {PACK}")
    bits = (x_pm1 < 0).to(torch.int64)                # bit 1 <=> -1
    bits = bits.reshape(*x_pm1.shape[:-1], d // PACK, PACK)
    shifts = torch.arange(PACK, dtype=torch.int64, device=x_pm1.device)
    return to_int32_bits((bits << shifts).sum(dim=-1))


def unpack_bits(packed: torch.Tensor, d: int) -> torch.Tensor:
    """Inverse of pack_bits -> (+1/-1) int8 of shape (..., d)."""
    if d != packed.shape[-1] * PACK:
        raise ValueError("d mismatch")
    shifts = torch.arange(PACK, dtype=torch.int64, device=packed.device)
    words = packed.to(torch.int64) & _MASK32
    bits = (words[..., None] >> shifts) & 1
    bits = bits.reshape(*packed.shape[:-1], d)
    return (1 - 2 * bits).to(torch.int8)


# ---------------------------------------------------------------------------
# kernel oracles
# ---------------------------------------------------------------------------

def expand_block_slots(block_slots: torch.Tensor, block_b: int,
                       total: int) -> torch.Tensor:
    """Broadcast per-block slot ids to per-row ids: (n_blocks,) -> (total,)."""
    return block_slots.repeat_interleave(block_b)[:total]


def popcount32(v: torch.Tensor) -> torch.Tensor:
    """SWAR popcount over 32-bit words (int32 or int64) -> int64 bit counts."""
    v = v.to(torch.int64) & _MASK32
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & _MASK32) >> 24


def _mismatches(x_packed: torch.Tensor, w_rows) -> torch.Tensor:
    """(B, W) words against per-row weights -> (B, H) int64 mismatch counts.

    ``w_rows(lo, hi)`` returns the (hi-lo, H, W) weights of rows lo..hi.
    """
    b = x_packed.shape[0]
    parts = []
    for lo in range(0, max(b, 1), _ROW_CHUNK):  # one empty slice when B = 0
        hi = min(lo + _ROW_CHUNK, b)
        xor = torch.bitwise_xor(x_packed[lo:hi, None, :], w_rows(lo, hi))
        parts.append(popcount32(xor).sum(dim=-1))
    return torch.cat(parts)


def xnor_matmul_ref(x_packed: torch.Tensor, w_packed: torch.Tensor) -> torch.Tensor:
    """Binary matmul oracle.

    x_packed: (B, W) words, w_packed: (H, W) words -> (B, H) int32 dot
    products of the underlying +-1 vectors of length d = W*32.
    """
    d = x_packed.shape[-1] * PACK
    mism = _mismatches(x_packed, lambda lo, hi: w_packed.expand(hi - lo, -1, -1))
    return (d - 2 * mism).to(torch.int32)


def bnn_forward_ref(
    w1_packed: torch.Tensor,  # (H, W) int32 words
    b1: torch.Tensor,         # (H,) float32
    w2: torch.Tensor,         # (C, H) float32
    b2: torch.Tensor,         # (C,) float32
    x_packed: torch.Tensor,   # (B, W) int32 words
) -> torch.Tensor:
    """h = sign(W1 x + b1); y = W2 h + b2   (paper Eq. 1).  -> (B, C) f32."""
    pre = xnor_matmul_ref(x_packed, w1_packed).to(torch.float32) + b1[None, :]
    h = torch.where(pre >= 0, 1.0, -1.0)
    return h @ w2.T + b2[None, :]


def banked_matmul_ref(
    x: torch.Tensor,      # (B, D)
    w: torch.Tensor,      # (K, D, H)
    b: torch.Tensor | None,  # (K, H) or None
    slots: torch.Tensor,  # (B,) int
) -> torch.Tensor:
    """Slot-selected matmul oracle: y[i] = x[i] @ w[slots[i]] + b[slots[i]]."""
    y = torch.einsum("bd,bdh->bh", x, w[slots])
    if b is not None:
        y = y + b[slots]
    return y.to(x.dtype)


def banked_xnor_forward_ref(
    bank_w1: torch.Tensor,   # (K, H, W) int32 words
    bank_b1: torch.Tensor,   # (K, H) f32
    bank_w2: torch.Tensor,   # (K, C, H) f32
    bank_b2: torch.Tensor,   # (K, C) f32
    x_packed: torch.Tensor,  # (B, W) int32 words
    slots: torch.Tensor,     # (B,) int
) -> torch.Tensor:
    """Per-packet slot-selected BNN forward (gather strategy oracle)."""
    d = x_packed.shape[-1] * PACK
    slots = slots.to(torch.int64)
    mism = _mismatches(x_packed, lambda lo, hi: bank_w1[slots[lo:hi]])
    pre = (d - 2 * mism).to(torch.float32) + bank_b1[slots]
    h = torch.where(pre >= 0, 1.0, -1.0)              # (B, H)
    return torch.einsum("bh,bch->bc", h, bank_w2[slots]) + bank_b2[slots]


# ---------------------------------------------------------------------------
# Dense-path oracle (the reference's ``mxu`` backend): unpack bits to +-1
# floats and contract with a matrix product instead of popcount.  Float32
# keeps every dot product (|v| <= d <= 2**24) exact.
# ---------------------------------------------------------------------------

def xnor_matmul_mxu_ref(x_packed: torch.Tensor, w_packed: torch.Tensor) -> torch.Tensor:
    d = x_packed.shape[-1] * PACK
    xv = unpack_bits(x_packed, d).to(torch.float32)
    wv = unpack_bits(w_packed, d).to(torch.float32)
    return (xv @ wv.T).to(torch.int32)


def random_bnn_params(rng: np.random.Generator, d_bits: int, hidden: int,
                      n_out: int = 1, *, device: torch.device | str) -> dict:
    """Random single-slot BNN parameter set (packed), drawn from ``rng``."""
    w1 = np.where(rng.random((hidden, d_bits)) < 0.5, 1.0, -1.0)
    b1 = rng.standard_normal(hidden) * 8.0
    w2 = rng.standard_normal((n_out, hidden)) / np.sqrt(hidden)
    b2 = rng.standard_normal(n_out) * 0.1
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "w1p": pack_bits(torch.from_numpy(w1).to(device)),
        "b1": torch.as_tensor(b1, **f32),
        "w2": torch.as_tensor(w2, **f32),
        "b2": torch.as_tensor(b2, **f32),
    }
