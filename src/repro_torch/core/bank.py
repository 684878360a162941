"""Resident model bank (paper §II-C), torch port.

``M = {f_0 .. f_{K-1}}`` is K structurally identical parameter dicts
stacked on a new leading axis (``w1p`` int32 words, ``b1``, ``w2``, ``b2``
float32).  Switching is slot indexing (data), never weight delivery.

Selection strategies (see ``repro_torch.core.executor``): ``take`` and
``onehot`` gather or contract per row; ``grouped``/``fused`` group rows by
slot so each kernel block serves one slot and run one fused launch that
reads rows by ``row_ids``; ``grouped_staged`` materializes a padded,
slot-sorted copy of the batch first (the fused-vs-staged baseline).

``DoubleBufferedBank`` holds two device copies of the bank, so a SwapSlot
commit is a reference flip (zero-copy switching).  Where the reference
donates the shadow to an XLA update, staging here writes the slot in place
into the shadow (``leaf[slot].copy_``) on the current stream.  That is
safe because nothing in flight reads the shadow: epochs apply only at a
quiescent tick boundary, after every in-flight tick retired, and a holder
that outlives a flip pins the buffer (copy-on-write).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.ref import expand_block_slots

Params = dict  # name -> tensor


def stack_bank(param_sets: list[Params]) -> Params:
    """Stack K structurally identical parameter dicts into (K, ...) leaves."""
    if not param_sets:
        raise ValueError("empty bank")
    if len({tuple(sorted(p)) for p in param_sets}) != 1:
        raise ValueError("bank slots must share one structure")
    return {name: torch.stack([p[name] for p in param_sets])
            for name in param_sets[0]}


def bank_size(bank: Params) -> int:
    return int(next(iter(bank.values())).shape[0])


def select_slot(bank: Params, k) -> Params:
    """f_k: one resident slot (views of the bank's leaves)."""
    return {name: leaf[k] for name, leaf in bank.items()}


def update_slot(bank: Params, k: int, new_params: Params) -> Params:
    """Control-plane style slot replacement (the heavyweight path).  Returns
    a new bank, as the reference does; the input bank is left unchanged."""
    new_params = slot_tensors(new_params, bank)
    out = copy_bank(bank)
    for name, leaf in out.items():
        leaf[k] = new_params[name]
    return out


def slot_tensors(params, bank: Params) -> Params:
    """One slot's params as tensors on the bank's device with its leaf
    dtypes.  Params may arrive as numpy (``uint32`` words become int32 with
    the same bits) or as tensors on any device; names and shapes must
    match a bank slot exactly (raises ``ValueError`` otherwise)."""
    if not isinstance(params, dict) or set(params) != set(bank):
        raise ValueError("params do not match the bank's slot structure")
    out = {}
    for name, leaf in bank.items():
        p = params[name]
        if not isinstance(p, torch.Tensor):
            arr = np.array(p)  # a private, writable, contiguous copy
            p = torch.from_numpy(arr.view(np.int32) if arr.dtype == np.uint32
                                 else arr)
        if tuple(p.shape) != tuple(leaf.shape[1:]):
            raise ValueError(f"{name}: shape {tuple(p.shape)} does not match "
                             f"the bank's slot shape {tuple(leaf.shape[1:])}")
        out[name] = p.to(device=leaf.device, dtype=leaf.dtype)
    return out


def bank_bytes(bank: Params) -> int:
    return sum(leaf.numel() * leaf.element_size() for leaf in bank.values())


def from_jax_bank(arrays: dict[str, np.ndarray], device=None) -> Params:
    """Carry a reference bank or slot across: ``w1p`` uint32 words become
    int32 tensors with the same bits, ``b1``/``w2``/``b2`` float32.
    ``device=None`` means the CUDA device."""
    dev = resolve_device(device)
    out = {}
    for name, arr in arrays.items():
        arr = np.array(arr)  # a private, writable, contiguous copy
        arr = arr.view(np.int32) if arr.dtype == np.uint32 else arr.astype(np.float32)
        out[name] = torch.from_numpy(arr).to(dev)
    return out


# ---------------------------------------------------------------------------
# grouped execution support
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Grouping:
    """Result of sorting a batch by slot for block-wise execution."""
    order: torch.Tensor        # (B,) permutation applied to rows
    inverse: torch.Tensor      # (B,) inverse permutation
    block_slots: torch.Tensor  # (B // block_b,) slot id per block
    valid: torch.Tensor        # (B,) bool — False for rows whose block mixes slots


def group_by_slot(slots: torch.Tensor, block_b: int) -> Grouping:
    """Stable-sort rows by slot and derive per-block slot ids; rows in
    blocks that straddle two slots are flagged invalid."""
    bsz = slots.shape[0]
    if bsz % block_b:
        raise ValueError(f"B={bsz} must be a multiple of block_b={block_b}")
    order = torch.argsort(slots, stable=True)
    blocks = slots[order].reshape(-1, block_b)
    block_slots = blocks[:, 0].to(torch.int32)
    valid_blocks = torch.all(blocks == blocks[:, :1], dim=1)
    valid_sorted = expand_block_slots(valid_blocks, block_b, bsz)
    inverse = torch.argsort(order)
    return Grouping(order=order, inverse=inverse, block_slots=block_slots,
                    valid=valid_sorted[inverse])


@dataclasses.dataclass
class PaddedGrouping:
    """Exact, static-shape grouping: every block is single-slot.

    Each slot's segment is padded up to a multiple of ``block_b`` inside a
    buffer of ``b_pad = roundup(B + K*block_b)`` rows; padding rows run
    under their block's slot.  ``row_ids``/``result_rows`` are what the
    fused kernel's gather consumes; ``order``/``dest`` serve the staged
    path (``scatter_padded``/``gather_padded``).
    """
    order: torch.Tensor        # (B,) stable sort permutation
    dest: torch.Tensor         # (B,) destination of sorted row i in the padded buffer
    block_slots: torch.Tensor  # (b_pad // block_b,) slot id per block
    b_pad: int                 # padded row count
    row_ids: torch.Tensor      # (b_pad,) source row per padded position (pad -> 0)
    result_rows: torch.Tensor  # (B,) padded position holding row i's result


def _exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    """[x0, x1, ...] -> [0, x0, x0+x1, ...] (segment start offsets)."""
    return torch.cumsum(x, 0) - x


def group_by_slot_padded(slots: torch.Tensor, num_slots: int,
                         block_b: int) -> PaddedGrouping:
    """Slot ids must lie in [0, num_slots) (``packet.slot_of`` clamps them).
    Every step stays on the device: the counts come from ``scatter_add_``,
    not ``bincount``, which waits for the device to size its output."""
    b = slots.shape[0]
    dev = slots.device
    slots = slots.to(torch.int64)
    order = torch.argsort(slots, stable=True)
    sorted_slots = slots[order]
    counts = torch.zeros(num_slots, dtype=torch.int64, device=dev).scatter_add_(
        0, slots, torch.ones_like(slots))
    padded = (counts + block_b - 1) // block_b * block_b
    rank = torch.arange(b, device=dev) - _exclusive_cumsum(counts)[sorted_slots]
    dest = (_exclusive_cumsum(padded)[sorted_slots] + rank).to(torch.int32)
    b_pad = (b + num_slots * block_b + block_b - 1) // block_b * block_b
    seg_end = torch.cumsum(padded, 0)
    block_starts = torch.arange(b_pad // block_b, device=dev) * block_b
    block_seg = torch.searchsorted(seg_end, block_starts, right=True)
    block_slots = block_seg.clamp(0, num_slots - 1).to(torch.int32)
    row_ids = torch.zeros(b_pad, dtype=torch.int32, device=dev)
    row_ids[dest.to(torch.int64)] = order.to(torch.int32)
    result_rows = torch.zeros(b, dtype=torch.int32, device=dev)
    result_rows[order] = dest
    return PaddedGrouping(order=order, dest=dest, block_slots=block_slots,
                          b_pad=b_pad, row_ids=row_ids,
                          result_rows=result_rows)


def scatter_padded(x: torch.Tensor, g: PaddedGrouping) -> torch.Tensor:
    """Place rows into the padded, slot-grouped layout (padding rows zero)."""
    out = torch.zeros((g.b_pad,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    out[g.dest.to(torch.int64)] = x[g.order]
    return out


def gather_padded(y_pad: torch.Tensor, g: PaddedGrouping) -> torch.Tensor:
    """Undo ``scatter_padded`` on the kernel output."""
    out = torch.empty((g.order.shape[0],) + tuple(y_pad.shape[1:]),
                      dtype=y_pad.dtype, device=y_pad.device)
    out[g.order] = y_pad[g.dest.to(torch.int64)]
    return out


def pad_group_by_slot(
    slots: np.ndarray, block_b: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side scheduler grouping: pad each slot segment to a block multiple.

    Returns (order, block_slots, row_valid) where ``order`` indexes into the
    original batch with repeats allowed for padding rows (marked invalid).
    """
    slots = np.asarray(slots)
    order_parts: list[np.ndarray] = []
    block_slots: list[int] = []
    valid_parts: list[np.ndarray] = []
    for k in np.unique(slots):
        idx = np.nonzero(slots == k)[0]
        pad = (-len(idx)) % block_b
        padded = np.concatenate([idx, np.repeat(idx[-1:], pad)])
        order_parts.append(padded)
        valid_parts.append(
            np.concatenate([np.ones(len(idx), bool), np.zeros(pad, bool)]))
        block_slots.extend([int(k)] * (len(padded) // block_b))
    return (
        np.concatenate(order_parts),
        np.asarray(block_slots, np.int32),
        np.concatenate(valid_parts),
    )


# ---------------------------------------------------------------------------
# double-buffered bank: zero-copy SwapSlot commit
# ---------------------------------------------------------------------------

def copy_bank(bank: Params) -> Params:
    """Deep device copy of a bank (fresh buffers, same contents)."""
    return {name: leaf.clone() for name, leaf in bank.items()}


def _stage_slot(shadow: Params, params: Params, slot: int) -> None:
    """Write one slot's params into the shadow in place."""
    for name, leaf in shadow.items():
        leaf[slot].copy_(params[name])


def _sync_slot(shadow: Params, active: Params, slot: int) -> None:
    """Catch the shadow up on one slot the active bank has since published
    (dirty-slot resync).  The active bank is read, never written."""
    for name, leaf in shadow.items():
        leaf[slot].copy_(active[name][slot])


class _Buf:
    """One of the two device-resident bank copies, with a pin count.

    A pinned buffer is referenced outside the double buffer (an epoch
    snapshot held for rollback, a caller's handle) and must never be
    written; ``DoubleBufferedBank.stage`` un-aliases it with a fresh copy
    instead (copy-on-write: a lingering pin costs one extra copy, never
    correctness)."""

    __slots__ = ("tree", "pins")

    def __init__(self, tree: Params):
        self.tree = tree
        self.pins = 0


class DoubleBufferedBank:
    """Two device-resident copies of the bank: *active* (serving traffic)
    and *shadow* (staging target).  ``SwapSlot`` staging writes into the
    shadow while ticks keep reading the active copy; the epoch's barrier
    commit is ``commit()``, a Python reference flip, O(1) whatever the
    bank's size.

    Invariants:
      * the active buffer is never written: every holder of the runtime's
        ``bank`` stays valid until the next flip *and* the next staging
        onto that (by then shadow) buffer; holders that span that window
        pin the buffer (``pin_active``/``unpin``).
      * at most ONE epoch's swaps are prestaged at a time; a second
        epoch's prestage is refused and falls back to staging at apply
        time (``force=True``), which still commits by flip.
      * per-buffer dirty-slot sets record how far each buffer lags the
        other; ``stage`` resyncs the shadow's dirty slots from the active
        buffer before writing new params, so a flip always publishes a
        complete bank.
    """

    def __init__(self, bank: Params):
        self.num_slots = bank_size(bank)
        # private copies: staging must never write the caller's tensors
        self._bufs = [_Buf(copy_bank(bank)), _Buf(copy_bank(bank))]
        self._active = 0
        self._dirty: list[set[int]] = [set(), set()]
        self._staged: dict[Any, tuple[int, Params]] = {}
        self._staged_epoch: Any = None
        self._committed: dict[Any, int] = {}
        self.stages = self.syncs = self.flips = 0
        self.discards = self.unalias_copies = 0

    # -- views ------------------------------------------------------------

    @property
    def active(self) -> Params:
        return self._bufs[self._active].tree

    @property
    def shadow(self) -> Params:
        return self._bufs[1 - self._active].tree

    @property
    def has_staged(self) -> bool:
        return bool(self._staged)

    def is_staged(self, token) -> bool:
        return token in self._staged

    def committed(self, token) -> bool:
        return token in self._committed

    # -- pinning ----------------------------------------------------------

    def pin_active(self) -> _Buf:
        """Pin the current active buffer (returns the pin handle)."""
        buf = self._bufs[self._active]
        buf.pins += 1
        return buf

    def unpin(self, buf: _Buf) -> None:
        buf.pins = max(0, buf.pins - 1)

    # -- staging ----------------------------------------------------------

    def stage(self, slot: int, params, *, token, epoch,
              force: bool = False) -> bool:
        """Stage ``params`` into the shadow's ``slot``; True if staged.

        ``token`` identifies the request (a command's ``id()``, or a
        prefetch key); ``epoch`` scopes the one-staged-epoch policy.  A
        same-slot, same-params re-stage (a prefetch promoted to a real
        epoch) adopts the existing staged entry without touching the
        device.  ``force=True`` (apply-time staging) evicts a stale staged
        epoch instead of refusing.  Raises ``ValueError`` for params that
        do not fit a slot, before any buffer is touched.
        """
        if token in self._staged:
            return True
        for t, (s, p) in list(self._staged.items()):
            if s == slot and p is params:  # prefetch promotion: rebind
                del self._staged[t]
                self._staged[token] = (slot, params)
                self._staged_epoch = epoch
                return True
        if self._staged and self._staged_epoch != epoch:
            if not force:
                return False
            self.discard_staged()
        sh = 1 - self._active
        new = slot_tensors(params, self._bufs[sh].tree)
        buf = self._bufs[sh]
        if buf.pins:
            # copy-on-write: the pinned buffer stays with its pinner
            buf = self._bufs[sh] = _Buf(copy_bank(buf.tree))
            self.unalias_copies += 1
        act = self._bufs[self._active].tree
        for k in sorted(self._dirty[sh]):
            if k == slot:
                continue  # about to be overwritten anyway
            _sync_slot(buf.tree, act, k)
            self.syncs += 1
        self._dirty[sh].clear()
        _stage_slot(buf.tree, new, int(slot))
        self._staged[token] = (slot, params)
        self._staged_epoch = epoch
        self.stages += 1
        return True

    def discard_staged(self) -> None:
        """Drop staged-but-uncommitted entries (their slots go dirty)."""
        if not self._staged:
            return
        sh = 1 - self._active
        self._dirty[sh].update(s for s, _ in self._staged.values())
        self._staged.clear()
        self._staged_epoch = None
        self.discards += 1

    # -- commit / rollback -------------------------------------------------

    def commit(self) -> Params:
        """Publish every staged slot by flipping which buffer is active.
        O(1): no weights move.  The demoted buffer becomes the next
        shadow, dirty at exactly the slots just published.  Returns the
        new active bank."""
        if not self._staged:
            return self.active
        old = self._active
        self._active = 1 - old
        for s, _ in self._staged.values():
            self._dirty[old].add(s)
        self._committed.update({t: s for t, (s, _) in self._staged.items()})
        self._staged.clear()
        self._staged_epoch = None
        self.flips += 1
        return self.active

    def mark(self):
        """Snapshot flip/staging bookkeeping for epoch rollback.  The
        previous epoch's committed tokens are dead by then and are purged
        so ``id()`` reuse can never alias a new command onto them."""
        self._committed.clear()
        return (self._active, dict(self._staged), self._staged_epoch,
                dict(self._committed),
                (set(self._dirty[0]), set(self._dirty[1])))

    def restore(self, m) -> None:
        """Roll back to a ``mark()``: un-flip if the epoch flipped, and
        mark every slot staged/committed since the mark dirty (the shadow
        holds rolled-back params there)."""
        active, staged, staged_epoch, committed, dirty = m
        rolled = {s for t, (s, _) in self._staged.items() if t not in staged}
        rolled |= {s for t, s in self._committed.items() if t not in committed}
        self._active = active
        self._staged = dict(staged)
        self._staged_epoch = staged_epoch
        self._committed = dict(committed)
        self._dirty = [set(dirty[0]), set(dirty[1])]
        self._dirty[1 - active].update(rolled)

    def reseed(self, bank: Params) -> None:
        """Adopt externally supplied contents as the new active bank.  The
        shadow is left in place (possibly pinned) and marked fully dirty so
        the next stage resyncs it."""
        self.discard_staged()
        self._bufs[self._active] = _Buf(copy_bank(bank))
        self._dirty[self._active].clear()
        self._dirty[1 - self._active] = set(range(self.num_slots))
        self._committed.clear()


# ---------------------------------------------------------------------------
# generic banked apply
# ---------------------------------------------------------------------------

def apply_banked(
    bank: Params,
    apply_fn: Callable[[Params, torch.Tensor], torch.Tensor],
    x: torch.Tensor,
    slots: torch.Tensor,
    *,
    strategy: str = "take",
) -> torch.Tensor:
    """Run ``apply_fn(f_{slots[i]}, x[i])`` for every row under a strategy.

    ``take`` gathers each row's slot params and maps ``apply_fn`` over the
    rows; ``onehot`` computes all K results per row and contracts with
    ``one_hot(slots, K)`` (exact, K x the work: only for cheap apply_fns
    and small K).  The grouped strategy lives with the kernels
    (`repro_torch.kernels.ops`), since it changes the execution layout.
    """
    slots = slots.to(torch.int64)
    if strategy == "take":
        per_row = {name: leaf[slots] for name, leaf in bank.items()}
        return torch.func.vmap(apply_fn)(per_row, x)
    if strategy == "onehot":
        k = bank_size(bank)
        all_out = torch.stack(
            [torch.func.vmap(lambda xi, s=s: apply_fn(select_slot(bank, s), xi))(x)
             for s in range(k)], dim=1)                       # (B, K, ...)
        onehot = torch.nn.functional.one_hot(slots, k).to(all_out.dtype)
        return torch.einsum("bk,bk...->b...", onehot, all_out)
    raise ValueError(f"unknown strategy {strategy!r}")
