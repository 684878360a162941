"""Resident model bank (paper §II-C), torch port.

``M = {f_0 .. f_{K-1}}`` is K structurally identical parameter dicts
stacked on a new leading axis (``w1p`` int32 words, ``b1``, ``w2``, ``b2``
float32).  Switching is slot indexing (data), never weight delivery.

Selection strategies (see ``repro_torch.core.executor``): ``take`` and
``onehot`` gather or contract per row; ``grouped``/``fused`` group rows by
slot so each kernel block serves one slot and run one fused launch that
reads rows by ``row_ids``; ``grouped_staged`` materializes a padded,
slot-sorted copy of the batch first (the fused-vs-staged baseline).

The double-buffered bank of the reference is not ported yet.
"""

from __future__ import annotations

import dataclasses

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
    out = {name: leaf.clone() for name, leaf in bank.items()}
    for name, leaf in out.items():
        leaf[k] = new_params[name]
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
