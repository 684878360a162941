"""Shared inline BNN executor (paper §II-B, Eq. 1) and its parameter bank.

The executor is invariant across packets: one function, one input format
(256 packed payload words = 1024 B), one output interface (C scores).
Only the referenced weight slot varies, resolved from packet metadata.

``H32`` is the paper's structure: d = 8192 input bits, hidden = 32, C = 1.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import bank as bank_lib
from repro_torch.core import packet as pkt
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref


@dataclasses.dataclass(frozen=True)
class BNNConfig:
    d_bits: int = pkt.PAYLOAD_BITS  # 8192
    hidden: int = 32                # "h32"
    n_out: int = 1

    @property
    def words(self) -> int:
        return self.d_bits // 32

    def param_bytes(self) -> int:
        """Resident footprint of one slot (packed W1 + b1 + W2 + b2)."""
        return (
            self.hidden * self.words * 4
            + self.hidden * 4
            + self.n_out * self.hidden * 4
            + self.n_out * 4
        )


H32 = BNNConfig()


def init_params(rng: np.random.Generator, cfg: BNNConfig = H32, *,
                device=None) -> dict:
    """Random slot parameters drawn from ``rng`` (``device=None``: CUDA)."""
    return kref.random_bnn_params(rng, cfg.d_bits, cfg.hidden, cfg.n_out,
                                  device=resolve_device(device))


def init_bank(rng: np.random.Generator, num_slots: int, cfg: BNNConfig = H32,
              *, device=None) -> dict:
    """Preload K weight sets into a resident bank (paper Eq. 2-3)."""
    dev = resolve_device(device)
    return bank_lib.stack_bank(
        [init_params(rng, cfg, device=dev) for _ in range(num_slots)])


def pack_real_weights(w1_real, b1, w2, b2, *, device=None) -> dict:
    """Binarize + pack a trained real-valued layer-1 (BinaryConnect-style)."""
    dev = resolve_device(device)
    w1 = torch.as_tensor(np.asarray(w1_real), device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "w1p": kref.pack_bits(torch.where(w1 >= 0, 1.0, -1.0)),
        "b1": torch.as_tensor(np.asarray(b1), **f32),
        "w2": torch.as_tensor(np.asarray(w2), **f32),
        "b2": torch.as_tensor(np.asarray(b2), **f32),
    }


def forward(params, payload_words, *, backend: str = "auto"):
    """Single-slot executor: (B, 256) int32 words -> (B, C) f32."""
    return ops.bnn_forward(params, payload_words, backend=backend)


def forward_banked(bank, payload_words, slots, *, strategy: str = "take",
                   backend: str = "auto", block_b: int = 256):
    """Slot-selected executor over the resident bank.

    ``grouped``/``fused`` run the zero-copy fused kernel (one launch that
    reads rows by ``row_ids``, no padded batch materialized);
    ``grouped_staged`` keeps the scatter -> kernel -> gather layout as the
    baseline.
    """
    if strategy in ("take", "onehot"):
        be = "mxu" if strategy == "onehot" else backend
        return ops.bnn_forward_banked(bank, payload_words, slots, backend=be)
    num_slots = bank_lib.bank_size(bank)
    bb = min(block_b, payload_words.shape[0])
    g = bank_lib.group_by_slot_padded(slots, num_slots, bb)
    if strategy in ("grouped", "fused"):
        y_pad = ops.bnn_forward_fused(
            bank, payload_words, g.block_slots, g.row_ids,
            block_b=bb, backend=backend,
        )
        return y_pad[g.result_rows.to(torch.int64)]
    if strategy == "grouped_staged":
        x_pad = bank_lib.scatter_padded(payload_words, g)
        y_pad = ops.bnn_forward_grouped(
            bank, x_pad, g.block_slots, block_b=bb, backend=backend
        )
        return bank_lib.gather_padded(y_pad, g)
    raise ValueError(f"unknown strategy {strategy!r}")
