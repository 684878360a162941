"""Frozen copy of the packet layout and the RSS flow hash.

These are the program's wire format and NIC-side dispatch as of the
benchmark's definition (``repro_torch.core.packet``,
``repro_torch.dataplane.rss``, ``repro_torch.dataplane.workloads.phases``),
copied so that a later change to the program cannot move the yardstick.
The harness uses the hash only to pin generated flows to queues.
"""

from __future__ import annotations

import functools

import numpy as np

PACKET_WORDS = 272          # 17 registers of 64 bytes, as 32-bit words
META_WORDS = 16             # reg0
PAYLOAD_WORDS = 256         # reg1..reg16 = 1024 bytes = 8192 bits
PAYLOAD_BITS = PAYLOAD_WORDS * 32
SLOT_WORD = 0
VERSION_WORD = 1
CONTROL_WORD = 2
FORMAT_VERSION = 1
FLOW_WORD_LO = 4
FLOW_WORDS = 4
SEQ_WORD = 15               # the harness's packet id

CTRL_MONITOR_ONLY = 1
ACTION_FORWARD = 0
ACTION_DROP = 1
ACTION_FLAG = 2

RETA_SIZE = 128
DEFAULT_KEY = bytes(
    (0x6D, 0x5A, 0x56, 0xDA, 0x25, 0x5B, 0x0E, 0xC2,
     0x41, 0x67, 0x25, 0x3D, 0x43, 0xA3, 0x8F, 0xB0,
     0xD0, 0xCA, 0x2B, 0xCB, 0xAE, 0x7B, 0x30, 0xB4,
     0x77, 0xCB, 0x2D, 0xA3, 0x80, 0x30, 0xF2, 0x0C,
     0x6A, 0x42, 0xB7, 0x3B, 0xBE, 0xAC, 0x01, 0xFA))


@functools.lru_cache(maxsize=4)
def _key_windows(key: bytes, n_bits: int) -> np.ndarray:
    total_bits = len(key) * 8
    acc = int.from_bytes(key, "big")
    return np.array([(acc >> (total_bits - 32 - j)) & 0xFFFFFFFF
                     for j in range(n_bits)], np.uint32)


def toeplitz_hash(flow_words: np.ndarray, key: bytes = DEFAULT_KEY) -> np.ndarray:
    """(B, 4) uint32 flow words -> (B,) uint32 Toeplitz hashes (MSB first)."""
    fw = np.ascontiguousarray(np.asarray(flow_words, np.uint32))
    windows = _key_windows(key, fw.shape[-1] * 32)
    as_bytes = fw.astype(">u4").view(np.uint8).reshape(fw.shape[0], -1)
    bits = np.unpackbits(as_bytes, axis=-1).astype(bool)
    return np.bitwise_xor.reduce(np.where(bits, windows, np.uint32(0)), axis=-1)


def default_queue_of(flow_words: np.ndarray, num_queues: int) -> np.ndarray:
    """Queue of each flow under the default round-robin RETA."""
    bucket = toeplitz_hash(flow_words) & np.uint32(RETA_SIZE - 1)
    return (bucket.astype(np.int64) % RETA_SIZE) % num_queues
