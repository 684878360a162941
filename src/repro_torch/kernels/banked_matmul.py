"""Slot-selected (banked) kernels and the kernel-level double-bank view.

The paper resolves the active model by reading a slot id from reg0 and
chasing one pointer into the resident bank.  Here each kernel block reads
one slot id from ``block_slots`` and fetches only that slot's weights;
rows must be pre-grouped so every block of ``block_b`` consecutive rows
shares one slot (``repro_torch.core.bank.group_by_slot``).

* ``banked_matmul`` — grouped float matmul ``y = x @ W[s] + b[s]``,
  accumulated in f32 and written in x's dtype (f32 or bf16), or
  ``y = x @ W[s]`` in f32 from bf16 operands (``out_dtype=torch.float32``,
  ``b`` None: the banked LM head); the Hopper kernels are in ``csrc/banked_matmul.cu``, one
  per variant that ``matmul_variant`` picks from the shapes and dtypes:
  ``bf16/wgmma`` (tensor cores fed by TMA), ``bf16/wgmma.f32out`` (the same
  on the head's few rows, f32 out), ``bf16/fma`` (ragged bf16 widths) and
  ``f32/fma`` (exact f32).
* ``banked_xnor_layer1`` — slot-selected BNN layer-1 pre-activations
  ``(float)(d - 2 popcount(x ^ w1[s])) + b1[s]``; the Hopper kernel is
  ``csrc/banked_xnor_layer1.cu``.

Each wrapper launches its kernel on CUDA tensors and runs its plain
version (``banked_matmul_ref``, ``banked_xnor_layer1_ref``) on CPU
tensors; ``<wrapper>.launches`` counts kernel launches (``banked_matmul``
per variant, followed by the caller's ``tag`` where a caller counts its
launches apart: the banked head passes ``"/head"``).

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
_VARIANT_CODE = {"f32/fma": 0, "bf16/fma": 1, "bf16/wgmma": 2, "bf16/wgmma.f32out": 3}


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

def _check_matmul(x, w, b, block_slots, block_b, out_dtype) -> tuple[int, int]:
    """The reference's argument checks, and the one bias rule: bf16
    operands with an f32 output (the banked head) take no bias, every other
    pair of dtypes one.  Returns (block_b, n_blocks)."""
    bsz, d = x.shape
    k, dw, h = w.shape
    if (b is None) != (x.dtype == torch.bfloat16 and out_dtype == torch.float32):
        raise ValueError("banked_matmul takes b=None exactly where bfloat16 operands give a "
                         f"float32 output, not b={'None' if b is None else 'a bias'} "
                         f"with {x.dtype} to {out_dtype or x.dtype}")
    if dw != d or (b is not None and tuple(b.shape) != (k, h)):
        raise ValueError(f"bank shape mismatch: x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"b {None if b is None else tuple(b.shape)}")
    block_b = min(block_b, bsz)
    if not block_b or bsz % block_b:
        raise ValueError(f"B={bsz} must divide block_b={block_b}")
    n_blocks = bsz // block_b
    if tuple(block_slots.shape) != (n_blocks,):
        raise ValueError(
            f"block_slots must be ({n_blocks},), got {tuple(block_slots.shape)}")
    return block_b, n_blocks


def banked_matmul_ref(x, w, b, block_slots, *, block_b: int = 128, out_dtype=None):
    """Plain version of ``banked_matmul``: each slot's rows through one
    f32 matrix product, bias (if any) added in f32, then cast to
    ``out_dtype`` (x's dtype by default)."""
    block_b, _ = _check_matmul(x, w, b, block_slots, block_b, out_dtype)
    k = w.shape[0]
    slots = expand_block_slots(block_slots.to(torch.int64).clamp(0, k - 1),
                               block_b, x.shape[0])
    xf = x.to(torch.float32)
    y = torch.zeros((x.shape[0], w.shape[2]), dtype=torch.float32,
                    device=x.device)
    for s in range(k):
        rows = torch.nonzero(slots == s).squeeze(1)
        if rows.numel():
            ys = xf[rows] @ w[s].to(torch.float32)
            y[rows] = ys if b is None else ys + b[s].to(torch.float32)
    return y.to(out_dtype or x.dtype)


def matmul_variant(dtype: torch.dtype, d: int, h: int, aligned: bool = True,
                   out_dtype: torch.dtype | None = None) -> str:
    """The kernel ``banked_matmul`` launches for these shapes, decided
    before launch.  The wgmma kernel's TMA loads need 16-byte row strides
    (D and H multiples of 8 bf16 values) and 16-byte aligned bases
    (``aligned``); other bf16 shapes take the FMA tile.  f32 always takes
    the exact FMA kernel (TF32 tensor cores would change its results).
    bf16 operands with an f32 output (``out_dtype``) take the wgmma kernel's
    f32 epilogue, which only the wgmma shapes have."""
    out_dtype = out_dtype or dtype
    if dtype == torch.float32 and out_dtype == torch.float32:
        return "f32/fma"
    if dtype != torch.bfloat16 or out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"banked_matmul takes float32 or bfloat16 in and out, and f32 "
                        f"out from bfloat16 in, not {dtype} to {out_dtype}")
    wgmma = aligned and d % 8 == 0 and h % 8 == 0
    if out_dtype == torch.float32:
        if not wgmma:
            raise ValueError(f"bfloat16 in, float32 out takes the wgmma kernel only: D = {d} "
                             f"and H = {h} multiples of 8, 16-byte aligned bases")
        return "bf16/wgmma.f32out"
    return "bf16/wgmma" if wgmma else "bf16/fma"


def banked_matmul(
    x: torch.Tensor,            # (B, D) f32 or bf16
    w: torch.Tensor,            # (K, D, H) same dtype
    b: torch.Tensor | None,     # (K, H) same dtype; None with an f32 output from bf16
    block_slots: torch.Tensor,  # (B // block_b,) int — one slot per block
    *,
    block_b: int = 128,
    out_dtype: torch.dtype | None = None,  # x's dtype, or f32 from bf16
    tag: str = "",
) -> torch.Tensor:
    """Grouped slot-selected matmul -> (B, H) in ``out_dtype`` (x's dtype by
    default).  Slot ids out of range are clamped."""
    block_b, n_blocks = _check_matmul(x, w, b, block_slots, block_b, out_dtype)
    if not x.is_cuda:
        return banked_matmul_ref(x, w, b, block_slots, block_b=block_b, out_dtype=out_dtype)
    if x.dtype not in (torch.float32, torch.bfloat16) or w.dtype != x.dtype \
            or (b is not None and b.dtype != x.dtype):
        raise TypeError("x, w and b must share one dtype, float32 or bfloat16")
    dev = x.device
    if any(t is not None and t.device != dev for t in (w, b, block_slots)):
        raise ValueError("x, the bank and block_slots must be on one device")
    bsz, d = x.shape
    k, _, h = w.shape
    xc, wc = x.contiguous(), w.contiguous()
    bc = None if b is None else b.contiguous()
    slots = block_slots.to(torch.int32).contiguous()
    out = torch.empty((bsz, h), dtype=out_dtype or x.dtype, device=dev)
    if bsz and h:
        kind = matmul_variant(x.dtype, d, h, all(
            t.data_ptr() % 16 == 0 for t in (xc, wc, bc) if t is not None), out_dtype)
        with torch.cuda.device(dev):
            ptrs, stream = cuda_args(xc, wc, bc, slots, out)
            _build.launch("banked_matmul", *ptrs, n_blocks, block_b, d, h, k,
                          _VARIANT_CODE[kind], stream)
        banked_matmul.launches[kind + tag] += 1
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
