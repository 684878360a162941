"""Plain reference of the paper's H32 binary network and its forwarding rule.

The model (arXiv 2605.10070, Eq. 1) on a packet of 272 32-bit words:

    k   = clamp(int32(word 0), 0, K - 1)               the slot
    x   = the 8192 payload bits of words 16..271, bit b -> 1 - 2b
    h_j = sign(x . W1[k, j] + b1[k, j])                 (+1 where >= 0)
    y   = h . W2[k, 0] + b2[k, 0]                       float32 weights
    verdict = y > 0;  action = forward if not verdict, else flag when the
    monitor-only bit (word 2, bit 0) is set, else drop.

Plain PyTorch: the binary product is a float64 matrix product of the +-1
vectors (exact), and layer 2 is summed in float64.  It imports nothing of the
program and takes nothing the program made: the harness hands it the rows and
the weights it generated itself.

``margin`` bounds how far any float32 evaluation of layer 2 (33 terms, any
order of summation, products exact because h is +-1) can lie from the exact
score: (H + 1) * 2**-24 * (sum |W2| + |b2|).  A served verdict is compared
only where |y| exceeds it; ``control_scores`` is the same network with W2
rounded to TF32 (10 mantissa bits), the precision next below float32.
"""

from __future__ import annotations

import torch

PAYLOAD_LO = 16
ROW_BLOCK = 8192


def tf32(t: torch.Tensor) -> torch.Tensor:
    """Round float32 values to TF32 (10 mantissa bits, nearest even)."""
    bits = t.to(torch.float32).contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def unpack_pm1(words: torch.Tensor) -> torch.Tensor:
    """(n, 256) int32 words -> (n, 8192) float64 +-1 (bit b -> 1 - 2b),
    little-endian within each word."""
    shifts = torch.arange(32, device=words.device, dtype=torch.int64)
    bits = (words.to(torch.int64)[..., None] >> shifts) & 1
    return (1 - 2 * bits).reshape(words.shape[0], -1).to(torch.float64)


def slots_of(rows: torch.Tensor, num_slots: int) -> torch.Tensor:
    """The slot each packet selects: word 0 read as int32, clamped."""
    return rows[:, 0].to(torch.int64).clamp(0, num_slots - 1)


def actions_of(rows: torch.Tensor, verdicts: torch.Tensor) -> torch.Tensor:
    monitor = (rows[:, 2] & 1) != 0
    return torch.where(verdicts, torch.where(monitor, 2, 1), 0).to(torch.int32)


def scores(rows: torch.Tensor, slot_w: dict, *, control: bool = False):
    """Scores of ``rows`` (n, 272) int32 under one slot's weights ``slot_w``
    (``w1p`` (H, 256) int32, ``b1`` (H,), ``w2`` (1, H), ``b2`` (1,)).
    Returns (y float64 (n,), margin float64 scalar)."""
    w1 = unpack_pm1(slot_w["w1p"])                       # (H, 8192)
    b1 = slot_w["b1"].to(torch.float64)
    w2 = slot_w["w2"][0]
    if control:
        w2 = tf32(w2)
    w2 = w2.to(torch.float64)
    b2 = slot_w["b2"].to(torch.float64)[0]
    out = []
    for lo in range(0, rows.shape[0], ROW_BLOCK):
        x = unpack_pm1(rows[lo:lo + ROW_BLOCK, PAYLOAD_LO:])
        pre = x @ w1.T + b1
        h = torch.where(pre >= 0, 1.0, -1.0).to(torch.float64)
        out.append(h @ w2 + b2)
    y = torch.cat(out) if out else torch.zeros(0, dtype=torch.float64,
                                                  device=rows.device)
    margin = (w2.numel() + 1) * 2.0**-24 * (
        slot_w["w2"].to(torch.float64).abs().sum() + b2.abs())
    return y, float(margin)
