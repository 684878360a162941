"""BoundSwitch fixed packet representation (paper §II-B), torch port.

A packet is seventeen 64-byte register blocks (1088 B = 272 words):

* ``reg0`` (16 words) carries control metadata: word 0 the model slot id,
  word 1 the format version, words 2..3 control bits for Pi, the rest
  padding;
* ``reg1..reg16`` (256 words = 1024 B) carry the payload presented to the
  BNN executor.

Host-side helpers are NumPy and build ``uint32`` arrays exactly as the
reference does.  Device-side helpers take ``torch.int32`` tensors that hold
the same 32 bits (``torch.from_numpy(a.view(np.int32))``).
"""

from __future__ import annotations

import numpy as np
import torch

REG_BYTES = 64
N_REGS = 17
PACKET_BYTES = REG_BYTES * N_REGS          # 1088
PAYLOAD_BYTES = REG_BYTES * (N_REGS - 1)   # 1024
PAYLOAD_BITS = PAYLOAD_BYTES * 8           # 8192

WORD_BYTES = 4
PACKET_WORDS = PACKET_BYTES // WORD_BYTES    # 272
META_WORDS = REG_BYTES // WORD_BYTES         # 16
PAYLOAD_WORDS = PAYLOAD_BYTES // WORD_BYTES  # 256

SLOT_WORD = 0
VERSION_WORD = 1
CONTROL_WORD_LO = 2
CONTROL_WORD_HI = 3

FORMAT_VERSION = 1

# Pi action codes.
ACTION_FORWARD = 0
ACTION_DROP = 1
ACTION_FLAG = 2  # forward but mark (monitor-only control bit set)

# Control bit 0 of word2: monitor-only (never drop, only flag).
CTRL_MONITOR_ONLY = 1


def make_packets(
    slots: np.ndarray,
    payload_words: np.ndarray,
    *,
    version: int = FORMAT_VERSION,
    control: int = 0,
) -> np.ndarray:
    """Assemble a batch of fixed-format packets.

    slots: (B,) integer slot ids; payload_words: (B, 256) uint32.
    Returns (B, 272) uint32.
    """
    slots = np.asarray(slots, dtype=np.uint32)
    payload_words = np.asarray(payload_words, dtype=np.uint32)
    if payload_words.ndim != 2 or payload_words.shape[1] != PAYLOAD_WORDS:
        raise ValueError(f"payload must be (B, {PAYLOAD_WORDS}) words, got {payload_words.shape}")
    b = payload_words.shape[0]
    if slots.shape != (b,):
        raise ValueError(f"slots must be ({b},), got {slots.shape}")
    pkt = np.zeros((b, PACKET_WORDS), dtype=np.uint32)
    pkt[:, SLOT_WORD] = slots
    pkt[:, VERSION_WORD] = np.uint32(version)
    pkt[:, CONTROL_WORD_LO] = np.uint32(control)
    pkt[:, META_WORDS:] = payload_words
    return pkt


def payload_bytes_to_words(payload: np.ndarray) -> np.ndarray:
    """(B, 1024) uint8 -> (B, 256) uint32, little-endian within each word."""
    payload = np.asarray(payload, dtype=np.uint8)
    if payload.shape[-1] != PAYLOAD_BYTES:
        raise ValueError(f"payload must have {PAYLOAD_BYTES} bytes")
    return payload.view("<u4").reshape(*payload.shape[:-1], PAYLOAD_WORDS)


def to_device(words: np.ndarray, device: torch.device | str) -> torch.Tensor:
    """uint32 words -> int32 tensor with the same bits on ``device``."""
    arr = np.ascontiguousarray(words, dtype=np.uint32)
    return torch.from_numpy(arr.view(np.int32)).to(device)


# ---------------------------------------------------------------------------
# Device-side parsing.  All are O(1) slices of int32 packet rows.
# ---------------------------------------------------------------------------

def slot_of(packets: torch.Tensor, num_slots: int) -> torch.Tensor:
    """sigma(m_p): extract the model slot index from reg0 word 0.

    Out-of-range ids are clamped into the resident bank.  The word is read
    as int32, as the reference's ``uint32 -> int32`` cast does, so
    ``0xFFFFFFFF`` is -1 and clamps to slot 0 (an int64 widening would clamp
    it to K-1 instead).
    """
    return packets[..., SLOT_WORD].clamp(0, num_slots - 1)


def raw_slot_of(packets: torch.Tensor) -> torch.Tensor:
    return packets[..., SLOT_WORD]


def version_ok(packets: torch.Tensor) -> torch.Tensor:
    return packets[..., VERSION_WORD] == FORMAT_VERSION


def control_of(packets: torch.Tensor) -> torch.Tensor:
    return packets[..., CONTROL_WORD_LO]


def payload_of(packets: torch.Tensor) -> torch.Tensor:
    """x_p: the 256 payload words (reg1..reg16), a view of the packet rows."""
    return packets[..., META_WORDS:]


def decide_action(packets: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
    """Pi(m_p, y_p): forwarding action from metadata + inference result.

    Malicious verdict (score > 0) drops, unless the monitor-only control bit
    is set, in which case the packet is forwarded but flagged.  Benign
    packets always forward.
    """
    malicious = scores > 0.0
    monitor = (control_of(packets) & CTRL_MONITOR_ONLY) != 0
    flag_or_drop = torch.where(monitor, ACTION_FLAG, ACTION_DROP)
    return torch.where(malicious, flag_or_drop, ACTION_FORWARD).to(torch.int32)
