"""Fused packet-forwarding kernel (parse -> select -> XNOR -> verdict).

One launch of ``csrc/fused_forward.cu`` runs the whole executor per block
of ``block_b`` output rows that share one slot: layer 1 (XNOR-popcount),
sign, layer 2 and optionally the Pi action, reading only the selected
slot's weights and writing only the scores (and actions).

Two input modes, as in the reference:

* **contiguous** (``row_ids is None``): rows are already grouped so each
  block shares one slot;
* **gather** (``row_ids`` given): the batch stays in arrival order and the
  kernel reads row ``row_ids[r]`` for output row r, so grouping never
  copies the batch.

``meta_words > 0`` means ``x`` rows are full packets (reg0 metadata
followed by payload words); the kernel slices the payload and reads the
control word for the action.  ``x`` may be any row-major view whose words
are contiguous within a row (a payload view of the packet rows needs no
copy).

``fused_forward`` launches the kernel on CUDA tensors and runs the plain
version ``fused_forward_ref`` on CPU tensors.  ``fused_forward.launches``
counts launches per variant (``variant``), followed by the caller's
``tag`` where a caller counts its launches apart (the megastep's window
passes ``"/window"``).

The reg0 constants mirror ``repro_torch.core.packet`` so the kernels
package stays core-free; ``repro_torch.core.pipeline`` asserts they agree.
"""

from __future__ import annotations

import collections

import torch

from . import _build
from .banked_matmul import flip_slots, stack_double_bank
from .bnn_xnor import cuda_args
from .ref import banked_xnor_forward_ref, expand_block_slots

# reg0 layout + Pi codes, mirrored from repro_torch.core.packet.
CTRL_WORD = 2
CTRL_MONITOR_ONLY = 1
ACTION_FORWARD = 0
ACTION_DROP = 1
ACTION_FLAG = 2

# The kernel's layer 1 covers the hidden units with four 8-wide MMA tiles.
MAX_HIDDEN = 32


def actions_ref(scores: torch.Tensor, ctrl_words: torch.Tensor) -> torch.Tensor:
    """Pi oracle on (B, C) scores + (B,) int32 control words -> (B,) int32."""
    malicious = scores[:, 0] > 0.0
    monitor = (ctrl_words & CTRL_MONITOR_ONLY) != 0
    flag_or_drop = torch.where(monitor, ACTION_FLAG, ACTION_DROP)
    return torch.where(malicious, flag_or_drop, ACTION_FORWARD).to(torch.int32)


def variant(row_ids, meta_words: int, with_actions: bool) -> str:
    """Name of a launch configuration, e.g. ``gather/meta16/actions``."""
    mode = "contiguous" if row_ids is None else "gather"
    return f"{mode}/meta{meta_words}" + ("/actions" if with_actions else "")


def _check(x, bank_w1, bank_b1, bank_w2, bank_b2, block_slots, row_ids,
           block_b, meta_words, with_actions) -> int:
    """The reference's argument checks; returns the output row count."""
    w_words = x.shape[-1] - meta_words
    k, h, ww = bank_w1.shape
    c = bank_w2.shape[1]
    if ww != w_words:
        raise ValueError(f"payload words {w_words} != bank words {ww}")
    if bank_b1.shape != (k, h) or bank_w2.shape != (k, c, h) \
            or bank_b2.shape != (k, c):
        raise ValueError("bank shape mismatch")
    if with_actions and meta_words <= CTRL_WORD:
        raise ValueError("with_actions requires metadata words in x")
    n_rows = block_slots.shape[0] * block_b
    if row_ids is None:
        if x.shape[0] != n_rows:
            raise ValueError(
                f"contiguous mode needs B={n_rows} rows, got {x.shape[0]}")
    elif tuple(row_ids.shape) != (n_rows,):
        raise ValueError(f"row_ids must be ({n_rows},), got {tuple(row_ids.shape)}")
    elif n_rows and not x.shape[0]:
        raise ValueError("gather mode needs input rows")
    return n_rows


def fused_forward_ref(x, bank_w1, bank_b1, bank_w2, bank_b2, block_slots,
                      row_ids=None, *, block_b: int = 256, meta_words: int = 0,
                      with_actions: bool = False):
    """Plain version of ``fused_forward``: gather, expand slots, run the
    per-row banked executor, then Pi."""
    n_rows = _check(x, bank_w1, bank_b1, bank_w2, bank_b2, block_slots,
                    row_ids, block_b, meta_words, with_actions)
    rows = x if row_ids is None else x[row_ids.to(torch.int64)]
    slots = expand_block_slots(block_slots, block_b, n_rows)
    scores = banked_xnor_forward_ref(bank_w1, bank_b1, bank_w2, bank_b2,
                                     rows[:, meta_words:], slots)
    if not with_actions:
        return scores
    return scores, actions_ref(scores, rows[:, CTRL_WORD])[:, None]


def fused_forward(
    x: torch.Tensor,            # (B, meta_words + W) int32 rows
    bank_w1: torch.Tensor,      # (K, H, W) int32 words
    bank_b1: torch.Tensor,      # (K, H) f32
    bank_w2: torch.Tensor,      # (K, C, H) f32
    bank_b2: torch.Tensor,      # (K, C) f32
    block_slots: torch.Tensor,  # (n_blocks,) int — one slot per output block
    row_ids: torch.Tensor | None = None,  # (n_blocks * block_b,) int gather map
    *,
    block_b: int = 256,
    meta_words: int = 0,
    with_actions: bool = False,
    tag: str = "",
):
    """One-launch fused forwarding path.

    Returns ``(n_blocks * block_b, C)`` f32 scores, plus a
    ``(n_blocks * block_b, 1)`` int32 action tile when ``with_actions``.
    Output row r belongs to input row ``row_ids[r]`` (gather mode) or row r
    (contiguous mode).  Slot ids and row ids out of range are clamped.
    """
    n_rows = _check(x, bank_w1, bank_b1, bank_w2, bank_b2, block_slots,
                    row_ids, block_b, meta_words, with_actions)
    if not x.is_cuda:
        return fused_forward_ref(
            x, bank_w1, bank_b1, bank_w2, bank_b2, block_slots, row_ids,
            block_b=block_b, meta_words=meta_words, with_actions=with_actions)

    k, h, w_words = bank_w1.shape
    c = bank_w2.shape[1]
    if h > MAX_HIDDEN:
        raise ValueError(f"hidden={h} exceeds the kernel's {MAX_HIDDEN} units")
    if x.dtype != torch.int32 or bank_w1.dtype != torch.int32:
        raise TypeError("packet rows and packed weights must be torch.int32")
    if x.stride(-1) != 1:
        raise ValueError("x rows must be contiguous within a row")
    dev = x.device
    tensors = (bank_w1, bank_b1, bank_w2, bank_b2, block_slots) + (
        () if row_ids is None else (row_ids,))
    if any(t.device != dev for t in tensors):
        raise ValueError("x, the bank and the index tensors must be on one device")
    if any(t.dtype != torch.float32 for t in (bank_b1, bank_w2, bank_b2)):
        raise TypeError("b1, w2 and b2 must be torch.float32")
    w1, b1, w2, b2 = (t.contiguous() for t in tensors[:4])
    slots = block_slots.to(torch.int32).contiguous()
    rows = None if row_ids is None else row_ids.to(torch.int32).contiguous()
    scores = torch.empty((n_rows, c), dtype=torch.float32, device=dev)
    actions = torch.empty((n_rows, 1), dtype=torch.int32, device=dev) \
        if with_actions else None
    if n_rows:
        with torch.cuda.device(dev):
            ptrs, stream = cuda_args(x, rows, slots, w1, b1, w2, b2, scores,
                                     actions)
            _build.launch("fused_forward", *ptrs, slots.shape[0], block_b,
                          x.shape[0], x.stride(0), meta_words, w_words, h, c,
                          k, stream)
        fused_forward.launches[variant(row_ids, meta_words, with_actions) + tag] += 1
    return (scores, actions) if with_actions else scores


fused_forward.launches = collections.Counter()


def double_buffered_forward(
    x: torch.Tensor,
    front: dict,                # bank A: w1p/b1/w2/b2 (K, ...) leaves
    back: dict,                 # bank B, same structure
    active,                     # 0/1, an int or a 0-d device tensor
    block_slots: torch.Tensor,  # (n_blocks,) slot ids in [0, K)
    row_ids: torch.Tensor | None = None,
    **kwargs,
):
    """``fused_forward`` over a double-buffered bank: the two copies are
    concatenated on the slot axis and the slot table is offset into the
    ``active`` half, so a SwapSlot commit is the change of one scalar.
    ``active`` is not read back to the host.  The concatenation copies
    both banks on every call; a caller that keeps the ``(2K, ...)`` stack
    calls ``fused_forward`` with ``flip_slots`` and moves no weights.
    Accepts every ``fused_forward`` keyword."""
    both = stack_double_bank(front, back)
    k = front["b1"].shape[0]
    return fused_forward(
        x, both["w1p"], both["b1"], both["w2"], both["b2"],
        flip_slots(block_slots, active, k), row_ids, **kwargs)


def fused_forward_qmajor(
    x_qmajor: torch.Tensor,     # (Q, B, meta_words + W) int32 rows
    bank_w1: torch.Tensor,
    bank_b1: torch.Tensor,
    bank_w2: torch.Tensor,
    bank_b2: torch.Tensor,
    block_slots: torch.Tensor,  # (n_blocks,) over the flattened batch
    row_ids: torch.Tensor,      # (n_blocks * block_b,) into Q*B rows
    **kwargs,
):
    """All queues of a host in ONE launch: ``x_qmajor`` stacks every
    queue's batch queue-major and is flattened to ``(Q * B, words)``, so the
    ``row_ids`` gather crosses queue boundaries freely.  Queue identity is
    ``row // B``.  Accepts every ``fused_forward`` keyword."""
    q, b, words = x_qmajor.shape
    return fused_forward(
        x_qmajor.reshape(q * b, words), bank_w1, bank_b1, bank_w2, bank_b2,
        block_slots, row_ids, **kwargs)
