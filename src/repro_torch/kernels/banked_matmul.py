"""Slot-selected (banked) kernels and the kernel-level double-bank view.

The paper resolves the active model by reading a slot id from reg0 and
chasing one pointer into the resident bank.  Here each kernel block reads
one slot id from ``block_slots`` and fetches only that slot's weights;
rows must be pre-grouped so every block of ``block_b`` consecutive rows
shares one slot (``repro_torch.core.bank.group_by_slot``).

* ``banked_matmul`` — grouped float matmul ``y = x @ W[s] + b[s]``,
  accumulated in f32 and written in x's dtype (f32 or bf16); the Hopper
  kernels are in ``csrc/banked_matmul.cu``, one per variant that
  ``matmul_variant`` picks from the shapes and dtype: ``bf16/wgmma``
  (tensor cores fed by TMA), ``bf16/fma`` (ragged bf16 widths) and
  ``f32/fma`` (exact f32).
* ``banked_xnor_layer1`` — slot-selected BNN layer-1 pre-activations
  ``(float)(d - 2 popcount(x ^ w1[s])) + b1[s]``; the Hopper kernel is
  ``csrc/banked_xnor_layer1.cu``.

Each wrapper launches its kernel on CUDA tensors and runs its plain
version (``banked_matmul_ref``, ``banked_xnor_layer1_ref``) on CPU
tensors; ``<wrapper>.launches`` counts kernel launches (``banked_matmul``
per variant).

Double-buffered bank (zero-copy commit): both bank copies live in ONE
``(2K, ...)`` allocation (``stack_double_bank``) and the slot table is
offset by ``active * K`` (``flip_slots``).  A commit changes the one
scalar ``active``; no weight moves.
"""

from __future__ import annotations

import collections

import torch

from . import _build
from .bnn_xnor import cuda_args
from .ref import PACK, _mismatches, expand_block_slots

__all__ = ["PACK", "stack_double_bank", "flip_slots", "banked_matmul",
           "banked_matmul_ref", "matmul_variant", "banked_xnor_layer1",
           "banked_xnor_layer1_ref"]

# The XNOR kernel covers four n8 tiles of hidden units.
MAX_HIDDEN = 32

# variant codes of banked_matmul_launch
_VARIANT_CODE = {"f32/fma": 0, "bf16/fma": 1, "bf16/wgmma": 2}


# ---------------------------------------------------------------------------
# double-buffered bank view
# ---------------------------------------------------------------------------

def stack_double_bank(front, back):
    """Concatenate two structurally identical (K, ...) bank leaves (or
    dicts of them) into the (2K, ...) layout ``flip_slots`` indexes."""
    if isinstance(front, dict):
        if set(front) != set(back):
            raise ValueError("front and back banks must share one structure")
        return {name: torch.cat([front[name], back[name]]) for name in front}
    return torch.cat([front, back])


def flip_slots(block_slots: torch.Tensor, active, k: int) -> torch.Tensor:
    """Steer a per-block slot table at the ``active`` half (0 or 1) of a
    ``stack_double_bank`` layout.  ``active`` may be an int or a 0-d
    tensor on the device; it is never read back to the host, so a flip
    needs no synchronisation."""
    return (block_slots.to(torch.int32) + active * k).to(torch.int32)


# ---------------------------------------------------------------------------
# float banked matmul: y[i] = x[i] @ W[slot_of_block(i)] + b
# ---------------------------------------------------------------------------

def _check_matmul(x, w, b, block_slots, block_b) -> tuple[int, int]:
    """The reference's argument checks; returns (block_b, n_blocks)."""
    bsz, d = x.shape
    k, dw, h = w.shape
    if dw != d or tuple(b.shape) != (k, h):
        raise ValueError(f"bank shape mismatch: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, b {tuple(b.shape)}")
    block_b = min(block_b, bsz)
    if not block_b or bsz % block_b:
        raise ValueError(f"B={bsz} must divide block_b={block_b}")
    n_blocks = bsz // block_b
    if tuple(block_slots.shape) != (n_blocks,):
        raise ValueError(
            f"block_slots must be ({n_blocks},), got {tuple(block_slots.shape)}")
    return block_b, n_blocks


def banked_matmul_ref(x, w, b, block_slots, *, block_b: int = 128):
    """Plain version of ``banked_matmul``: each slot's rows through one
    f32 matrix product, bias added in f32, then cast to x's dtype."""
    block_b, _ = _check_matmul(x, w, b, block_slots, block_b)
    k = w.shape[0]
    slots = expand_block_slots(block_slots.to(torch.int64).clamp(0, k - 1),
                               block_b, x.shape[0])
    xf = x.to(torch.float32)
    y = torch.zeros((x.shape[0], w.shape[2]), dtype=torch.float32,
                    device=x.device)
    for s in range(k):
        rows = torch.nonzero(slots == s).squeeze(1)
        if rows.numel():
            y[rows] = xf[rows] @ w[s].to(torch.float32) + b[s].to(torch.float32)
    return y.to(x.dtype)


def matmul_variant(dtype: torch.dtype, d: int, h: int, aligned: bool = True) -> str:
    """The kernel ``banked_matmul`` launches for these shapes, decided
    before launch.  The wgmma kernel's TMA loads need 16-byte row strides
    (D and H multiples of 8 bf16 values) and 16-byte aligned bases
    (``aligned``); other bf16 shapes take the FMA tile.  f32 always takes
    the exact FMA kernel (TF32 tensor cores would change its results)."""
    if dtype == torch.float32:
        return "f32/fma"
    if dtype != torch.bfloat16:
        raise TypeError(f"banked_matmul takes float32 or bfloat16, not {dtype}")
    return "bf16/wgmma" if aligned and d % 8 == 0 and h % 8 == 0 else "bf16/fma"


def banked_matmul(
    x: torch.Tensor,            # (B, D) f32 or bf16
    w: torch.Tensor,            # (K, D, H) same dtype
    b: torch.Tensor,            # (K, H) same dtype
    block_slots: torch.Tensor,  # (B // block_b,) int — one slot per block
    *,
    block_b: int = 128,
) -> torch.Tensor:
    """Grouped slot-selected matmul -> (B, H) in x's dtype.  Slot ids out
    of range are clamped."""
    block_b, n_blocks = _check_matmul(x, w, b, block_slots, block_b)
    if not x.is_cuda:
        return banked_matmul_ref(x, w, b, block_slots, block_b=block_b)
    if x.dtype not in (torch.float32, torch.bfloat16) or w.dtype != x.dtype \
            or b.dtype != x.dtype:
        raise TypeError("x, w and b must share one dtype, float32 or bfloat16")
    dev = x.device
    if any(t.device != dev for t in (w, b, block_slots)):
        raise ValueError("x, the bank and block_slots must be on one device")
    bsz, d = x.shape
    k, _, h = w.shape
    xc, wc, bc = x.contiguous(), w.contiguous(), b.contiguous()
    slots = block_slots.to(torch.int32).contiguous()
    out = torch.empty((bsz, h), dtype=x.dtype, device=dev)
    if bsz and h:
        kind = matmul_variant(x.dtype, d, h, all(
            t.data_ptr() % 16 == 0 for t in (xc, wc, bc)))
        with torch.cuda.device(dev):
            ptrs, stream = cuda_args(xc, wc, bc, slots, out)
            _build.launch("banked_matmul", *ptrs, n_blocks, block_b, d, h, k,
                          _VARIANT_CODE[kind], stream)
        banked_matmul.launches[kind] += 1
    return out


banked_matmul.launches = collections.Counter()


# ---------------------------------------------------------------------------
# banked BNN layer 1: slot-selected XNOR-popcount
# ---------------------------------------------------------------------------

def _check_xnor(x_packed, bank_w1, bank_b1, block_slots, block_b,
                chunk) -> tuple[int, int]:
    """The reference's argument checks; returns (block_b, n_blocks)."""
    bsz, w_words = x_packed.shape
    k, h, ww = bank_w1.shape
    if ww != w_words or tuple(bank_b1.shape) != (k, h):
        raise ValueError("bank shape mismatch")
    block_b = min(block_b, bsz)
    chunk = min(chunk, w_words)
    if not block_b or not chunk or bsz % block_b or w_words % chunk:
        raise ValueError("blocking must divide shapes")
    n_blocks = bsz // block_b
    if tuple(block_slots.shape) != (n_blocks,):
        raise ValueError(f"block_slots must be ({n_blocks},)")
    return block_b, n_blocks


def banked_xnor_layer1_ref(x_packed, bank_w1, bank_b1, block_slots, *,
                           block_b: int = 256, chunk: int = 64):
    """Plain version of ``banked_xnor_layer1`` (per-row gathered weights)."""
    block_b, _ = _check_xnor(x_packed, bank_w1, bank_b1, block_slots,
                             block_b, chunk)
    k = bank_w1.shape[0]
    slots = expand_block_slots(block_slots.to(torch.int64).clamp(0, k - 1),
                               block_b, x_packed.shape[0])
    mism = _mismatches(x_packed, lambda lo, hi: bank_w1[slots[lo:hi]])
    d = x_packed.shape[1] * PACK
    return (d - 2 * mism).to(torch.float32) + bank_b1[slots]


def banked_xnor_layer1(
    x_packed: torch.Tensor,     # (B, W) int32 words
    bank_w1: torch.Tensor,      # (K, H, W) int32 words
    bank_b1: torch.Tensor,      # (K, H) f32
    block_slots: torch.Tensor,  # (B // block_b,) int
    *,
    block_b: int = 256,
    chunk: int = 64,
) -> torch.Tensor:
    """Slot-selected layer-1 pre-activations (float32, bias added).

    ``chunk`` is the reference's tiling of the word axis; it is checked
    as the reference checks it and does not change the result."""
    block_b, n_blocks = _check_xnor(x_packed, bank_w1, bank_b1, block_slots,
                                    block_b, chunk)
    if not x_packed.is_cuda:
        return banked_xnor_layer1_ref(x_packed, bank_w1, bank_b1, block_slots,
                                      block_b=block_b, chunk=chunk)
    bsz, w_words = x_packed.shape
    k, h, _ = bank_w1.shape
    if h > MAX_HIDDEN:
        raise ValueError(f"hidden={h} exceeds the kernel's {MAX_HIDDEN} units")
    if x_packed.dtype != torch.int32 or bank_w1.dtype != torch.int32:
        raise TypeError("packed words must be torch.int32")
    if bank_b1.dtype != torch.float32:
        raise TypeError("b1 must be torch.float32")
    if x_packed.stride(1) != 1:
        raise ValueError("x rows must be contiguous within a row")
    dev = x_packed.device
    if any(t.device != dev for t in (bank_w1, bank_b1, block_slots)):
        raise ValueError("x, the bank and block_slots must be on one device")
    w1, b1 = bank_w1.contiguous(), bank_b1.contiguous()
    slots = block_slots.to(torch.int32).contiguous()
    out = torch.empty((bsz, h), dtype=torch.float32, device=dev)
    if bsz and h:
        with torch.cuda.device(dev):
            ptrs, stream = cuda_args(x_packed, w1, b1, slots, out)
            _build.launch("banked_xnor_layer1", *ptrs, n_blocks, block_b,
                          x_packed.stride(0), w_words, h, k, stream)
        banked_xnor_layer1.launches += 1
    return out


banked_xnor_layer1.launches = 0
