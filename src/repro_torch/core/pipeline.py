"""The shared forwarding path (paper Algorithm 1), torch port.

    1. parse slot metadata from reg0
    2. k_p  <- sigma(m_p)          (O(1) slot extraction)
    3. resolve resident slot f_{k_p} in the bank
    4. y_p  <- f_{k_p}(x_p)        (shared BNN executor)
    5. a_p  <- Pi(m_p, y_p)        (forwarding action)

The parser, executor and forwarding logic are the same for every packet
and slot; only the slot index (data) differs.  The "fixed single-model
path" baseline is the same pipeline with sigma replaced by a constant.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import bank as bank_lib, executor, packet as pkt
from repro_torch.kernels import fused_forward as _fused_kernel
from repro_torch.kernels import ops
from repro_torch.kernels import ref as _ref

# The kernel package mirrors the reg0 layout so it stays core-free; make the
# mirror impossible to drift silently.
assert _fused_kernel.CTRL_WORD == pkt.CONTROL_WORD_LO
assert _fused_kernel.CTRL_MONITOR_ONLY == pkt.CTRL_MONITOR_ONLY
assert (_fused_kernel.ACTION_FORWARD, _fused_kernel.ACTION_DROP,
        _fused_kernel.ACTION_FLAG) == (pkt.ACTION_FORWARD, pkt.ACTION_DROP,
                                       pkt.ACTION_FLAG)


class PacketResult(NamedTuple):
    slots: torch.Tensor     # (B,) resolved k_p
    scores: torch.Tensor    # (B,) y_p (first output column)
    verdicts: torch.Tensor  # (B,) bool — malicious?
    actions: torch.Tensor   # (B,) int32 Pi output


def packet_step(
    bank,
    packets: torch.Tensor,  # (B, 272) int32
    *,
    num_slots: int,
    strategy: str = "take",
    backend: str = "auto",
    fixed_slot: int | None = None,
    block_b: int = 256,
) -> PacketResult:
    """Process one batch of packets along the shared forwarding path.

    ``strategy="fused"`` runs steps 2-5 as ONE kernel launch over the raw
    packet rows: the kernel reads each block's packets by ``row_ids``,
    slices the payload, runs the banked BNN and emits verdict + Pi action.
    The other strategies share the staged executor
    (``executor.forward_banked``).
    """
    if fixed_slot is None:
        slots = pkt.slot_of(packets, num_slots)           # sigma(m_p)
    else:  # baseline operating mode: fixed single-model path
        slots = torch.full(packets.shape[:1], fixed_slot, dtype=torch.int32,
                           device=packets.device)
    if strategy == "fused":
        if ops.resolve(backend, packets) in ("ref", "mxu"):
            # No kernel launch to feed: the oracle gathers per-row weights
            # anyway, so run the bank directly on the arrival-order batch.
            scores_d = _ref.banked_xnor_forward_ref(
                bank["w1p"], bank["b1"], bank["w2"], bank["b2"],
                pkt.payload_of(packets), slots)
            actions_d = _fused_kernel.actions_ref(
                scores_d, packets[:, pkt.CONTROL_WORD_LO])
            return PacketResult(slots, scores_d[:, 0], scores_d[:, 0] > 0.0,
                                actions_d)
        bb = min(block_b, packets.shape[0])
        g = bank_lib.group_by_slot_padded(slots, num_slots, bb)
        scores_pad, actions_pad = ops.packet_forward_fused(
            bank, packets, g.block_slots, g.row_ids,
            meta_words=pkt.META_WORDS, block_b=bb, backend=backend,
        )
        rows = g.result_rows.to(torch.int64)
        scores = scores_pad[rows, 0]
        return PacketResult(slots, scores, scores > 0.0, actions_pad[rows])
    payload = pkt.payload_of(packets)                     # x_p
    scores = executor.forward_banked(
        bank, payload, slots, strategy=strategy, backend=backend,
        block_b=block_b,
    )[:, 0]                                               # y_p
    actions = pkt.decide_action(packets, scores)          # Pi(m_p, y_p)
    return PacketResult(slots, scores, scores > 0.0, actions)


def slot_select_only(packets: torch.Tensor, num_slots: int) -> torch.Tensor:
    """Isolated sigma for the slot-selection microbenchmarks."""
    return pkt.slot_of(packets, num_slots)


def inference_only(params, payload_words, *, backend: str = "auto"):
    """Isolated single-slot inference for the latency breakdown."""
    return executor.forward(params, payload_words, backend=backend)
