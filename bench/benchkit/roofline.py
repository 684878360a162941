"""The yardstick's peaks and the fused forward's work, counted from the
packets served.

Peaks of one NVIDIA H100 SXM (80 GB HBM3): 3.35e12 B/s of HBM (NVIDIA's data
sheet) and 4.9495e15 binary multiply-accumulates per second, the rate of
``mma.sync ... b1 ... and.popc`` that ``benchmarks_torch/bmma_rate.cu``
measured on an H100 80GB HBM3 at a 700 W limit.  The rate is frozen here so
that every run and every later change reads the same yardstick.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
BIT_MACS_PER_S = 4.9495e15

PACKET_BYTES = 272 * 4     # the kernel reads the whole row (reg0 + payload)
RESULT_BYTES = 8           # a float32 score and an int32 action per row


def slot_param_bytes(d_bits: int, hidden: int, n_out: int) -> int:
    """Packed W1, b1, W2, b2 of one slot."""
    return hidden * (d_bits // 32) * 4 + hidden * 4 + n_out * hidden * 4 + n_out * 4


def fused_work(served: int, ticks: int, *, d_bits: int, hidden: int,
               n_out: int, num_slots: int) -> tuple[float, float]:
    """(bytes, bit-MACs) the served packets need: each row read once and its
    result written once, each tick reading the resident bank once, and d x H
    binary multiply-accumulates per row (layer 2's H products are noise)."""
    nbytes = served * (PACKET_BYTES + RESULT_BYTES) + ticks * num_slots * \
        slot_param_bytes(d_bits, hidden, n_out)
    return float(nbytes), float(served) * d_bits * hidden


def least_seconds(nbytes: float, bit_macs: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(nbytes / HBM_BYTES_PER_S, bit_macs / BIT_MACS_PER_S)


def packet_mfu_percent(served: int, window_s: float, *, d_bits: int,
                       hidden: int) -> float:
    """The window's binary multiply-accumulates as a share of the peak, %."""
    return 100.0 * served * d_bits * hidden / (window_s * BIT_MACS_PER_S)
