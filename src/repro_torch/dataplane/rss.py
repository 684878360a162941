"""RSS-style deterministic flow dispatch (the NIC front of the data plane),
torch port: the reference's host-side NumPy code.

The paper's 1.894 Mpps AF_XDP stack relies on the NIC's receive-side
scaling: a Toeplitz hash over the flow tuple selects a hardware queue, so
packets of one flow always land on the same queue (per-flow ordering) while
flows spread across queues (aggregate throughput).  This module reproduces
that dispatch stage in software, bit-compatible with the classic Toeplitz
construction:

* the flow tuple lives in reg0 spare words 4..7 (16 B — src/dst address,
  ports, protocol as the traffic engine lays them out);
* ``toeplitz_hash`` runs the standard MSB-first sliding-window XOR over a
  secret key (default: the Microsoft reference RSS key), vectorized over
  the batch;
* the hash indexes a 128-entry indirection table (RETA) mapping hash LSBs
  to queue ids.  Link failover is a RETA rewrite (``failover_table``), not
  a rehash — exactly how real NIC drivers migrate traffic off a dead queue.

Everything here is host-side NumPy: dispatch happens before packets enter
the device rings, mirroring the hardware split.
"""

from __future__ import annotations

import functools

import numpy as np

# reg0 spare words carrying the flow tuple (see repro_torch.core.packet: words
# 4..15 are padding/spare; the dataplane assigns 4..7 to the flow tuple).
FLOW_WORD_LO = 4
FLOW_WORDS = 4  # 16 bytes = 128 hash input bits
FLOW_BITS = FLOW_WORDS * 32

# Indirection table size (power of two, as in mlx5/ixgbe defaults).
RETA_SIZE = 128

# Microsoft reference RSS key (40 bytes); only the first
# ``FLOW_BITS/8 + 4`` bytes feed the 128-bit window sweep.
DEFAULT_KEY = bytes(
    (0x6D, 0x5A, 0x56, 0xDA, 0x25, 0x5B, 0x0E, 0xC2,
     0x41, 0x67, 0x25, 0x3D, 0x43, 0xA3, 0x8F, 0xB0,
     0xD0, 0xCA, 0x2B, 0xCB, 0xAE, 0x7B, 0x30, 0xB4,
     0x77, 0xCB, 0x2D, 0xA3, 0x80, 0x30, 0xF2, 0x0C,
     0x6A, 0x42, 0xB7, 0x3B, 0xBE, 0xAC, 0x01, 0xFA)
)


@functools.lru_cache(maxsize=8)
def _key_windows(key: bytes, n_bits: int) -> np.ndarray:
    """windows[j] = the 32-bit slice of ``key`` starting at bit j (MSB-first).

    Toeplitz is "XOR together the key windows at every set input bit"; the
    window table turns the per-bit shift loop into one vectorized select.
    """
    total_bits = len(key) * 8
    if total_bits < n_bits + 32:
        raise ValueError(
            f"key too short: {total_bits} bits for {n_bits} input bits")
    acc = int.from_bytes(key, "big")
    out = np.empty(n_bits, np.uint32)
    for j in range(n_bits):
        out[j] = (acc >> (total_bits - 32 - j)) & 0xFFFFFFFF
    return out


def toeplitz_hash(flow_words: np.ndarray, key: bytes = DEFAULT_KEY) -> np.ndarray:
    """Vectorized Toeplitz hash: (B, F) uint32 flow words -> (B,) uint32.

    Bit order matches the canonical definition: words are consumed
    big-endian, MSB first, so the result is reproducible against any
    reference implementation fed the same 16 input bytes.
    """
    fw = np.ascontiguousarray(np.asarray(flow_words, np.uint32))
    if fw.ndim == 1:
        fw = fw[None, :]
    n_bits = fw.shape[-1] * 32
    windows = _key_windows(key, n_bits)
    # explicit width: reshape(-1) is ambiguous for empty batches
    as_bytes = fw.astype(">u4").view(np.uint8).reshape(
        *fw.shape[:-1], fw.shape[-1] * 4)
    bits = np.unpackbits(as_bytes, axis=-1).astype(bool)  # (B, n_bits)
    return np.bitwise_xor.reduce(
        np.where(bits, windows, np.uint32(0)), axis=-1)


def flow_words_of(packets: np.ndarray) -> np.ndarray:
    """Extract the (B, 4) flow tuple words from raw packet rows."""
    return np.asarray(packets)[:, FLOW_WORD_LO : FLOW_WORD_LO + FLOW_WORDS]


def indirection_table(num_queues: int, size: int = RETA_SIZE) -> np.ndarray:
    """Default RETA: round-robin hash buckets over the live queues."""
    if num_queues < 1:
        raise ValueError("need at least one queue")
    if num_queues > size:
        raise ValueError(
            f"{num_queues} queues cannot all be reachable through a "
            f"{size}-entry RETA; raise size")
    return (np.arange(size) % num_queues).astype(np.int32)


def failover_table(
    reta: np.ndarray,
    failed_queues: tuple[int, ...],
    *,
    num_queues: int | None = None,
) -> np.ndarray:
    """Remap RETA entries off failed queues onto survivors (round-robin).

    Surviving entries keep their queue (flow affinity is preserved for
    unaffected flows); only buckets that pointed at a dead queue move.
    Survivors are the live queues of ``range(num_queues)`` when given;
    otherwise only queues currently referenced by the RETA are considered
    (a skewed RETA may then hide live-but-unreferenced queues).
    """
    reta = np.asarray(reta, np.int32).copy()
    failed = set(int(q) for q in failed_queues)
    pool = (set(range(num_queues)) if num_queues is not None
            else set(int(q) for q in reta))
    survivors = sorted(pool - failed)
    if not survivors:
        raise ValueError("failover would leave zero live queues")
    moved = np.nonzero(np.isin(reta, list(failed)))[0]
    for i, bucket in enumerate(moved):
        reta[bucket] = survivors[i % len(survivors)]
    return reta


def restore_table(
    num_queues: int,
    size: int = RETA_SIZE,
    failed: tuple[int, ...] | set | frozenset = (),
) -> np.ndarray:
    """The default round-robin RETA minus still-failed queues — the ONE
    RestoreQueues rebuild both the single-host runtime and the mesh use
    (the mesh passes its global queue count)."""
    base = indirection_table(num_queues, size)
    if failed:
        base = failover_table(base, tuple(sorted(failed)),
                              num_queues=num_queues)
    return base


def bucket_index(h: np.ndarray, reta_len: int) -> np.ndarray:
    """Hash -> RETA bucket: mask for the hardware-style power-of-two
    table; modulo keeps every bucket reachable for arbitrary sizes."""
    size = np.uint32(reta_len)
    return h & (size - 1) if reta_len & (reta_len - 1) == 0 else h % size


def queue_of(
    packets: np.ndarray,
    num_queues: int,
    *,
    key: bytes = DEFAULT_KEY,
    reta: np.ndarray | None = None,
) -> np.ndarray:
    """Full dispatch: flow tuple -> Toeplitz hash -> RETA -> queue id."""
    if reta is None:
        reta = indirection_table(num_queues)
    reta = np.asarray(reta, np.int32)
    h = toeplitz_hash(flow_words_of(packets), key)
    return reta[bucket_index(h, len(reta))]
