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
* ``toeplitz_hash`` computes the standard MSB-first sliding-window XOR
  over a secret key (default: the Microsoft reference RSS key) by table
  lookup, vectorized over the batch;
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

    Toeplitz is "XOR together the key windows at every set input bit";
    ``_hash_tables`` folds the windows into per-half-word lookup tables.
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


@functools.lru_cache(maxsize=8)
def _hash_tables(key: bytes, n_words: int) -> np.ndarray:
    """tables[i][v] = the Toeplitz hash of half-word ``v`` at half-word
    position ``i`` of an ``n_words``-word input (all other bits zero).

    Toeplitz is linear over GF(2): the hash of an input is the XOR of the
    key windows at its set bits, so the XOR over the 16 bits of each
    half-word can be tabulated once, and a hash is 2 * ``n_words`` lookups
    XORed together.  Half-word ``i`` covers input bits 16i .. 16i+15, MSB
    first.  Built from byte tables: entry ``hi << 8 | lo`` of a half-word's
    table is the XOR of its two bytes' entries.  (2 * ``n_words``, 65536)
    uint32, 256 KiB a half-word; read-only, since every caller shares it.
    """
    windows = _key_windows(key, n_words * 32).reshape(-1, 8)
    bits = ((np.arange(256)[:, None] >> np.arange(7, -1, -1)) & 1).astype(bool)
    byte_tables = np.bitwise_xor.reduce(
        np.where(bits[None], windows[:, None, :], np.uint32(0)), axis=-1)
    tables = (byte_tables[0::2, :, None] ^ byte_tables[1::2, None, :]
              ).reshape(2 * n_words, 1 << 16)
    tables.flags.writeable = False
    return tables


def toeplitz_hash(flow_words: np.ndarray, key: bytes = DEFAULT_KEY) -> np.ndarray:
    """Vectorized Toeplitz hash: (B, F) uint32 flow words -> (B,) uint32.

    Bit order matches the canonical definition: words are consumed
    big-endian, MSB first, so the result is reproducible against any
    reference implementation fed the same 16 input bytes.  Each word's
    high and low half-words index ``_hash_tables``, and the 2F entries
    are XORed together.
    """
    fw = np.asarray(flow_words, np.uint32)
    if fw.ndim == 1:
        fw = fw[None, :]
    n_words = fw.shape[-1]
    tables = _hash_tables(key, n_words)
    # one gather over the rows, then every step below reads contiguously
    words = np.ascontiguousarray(fw.reshape(-1, n_words).T)
    # row 2i: word i's high half-word, row 2i+1: its low one, each offset
    # into its own table, so that one lookup reads all 2F entries
    idx = np.empty((n_words, 2, words.shape[1]), np.uint32)
    np.right_shift(words, 16, out=idx[:, 0])
    np.bitwise_and(words, 0xFFFF, out=idx[:, 1])
    idx = idx.reshape(2 * n_words, -1)
    idx += np.arange(0, 2 * n_words << 16, 1 << 16, dtype=np.uint32)[:, None]
    return np.bitwise_xor.reduce(tables.reshape(-1).take(idx), axis=0
                                 ).reshape(fw.shape[:-1])


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


# ---------------------------------------------------------------------------
# mesh (multi-host) RETA: buckets resolve to (host, queue) pairs
# ---------------------------------------------------------------------------
#
# A mesh RETA entry is a *global queue id* ``gid = host * Q + queue`` in
# host-major order.  Because the global id space is just a larger queue id
# space, every single-host RETA operation (round-robin default, affinity-
# preserving failover, bucket indexing) applies verbatim — the 1-host mesh
# table IS the single-host table, bit for bit, and cross-host failover
# inherits the exact never-remap-a-survivor guarantee of the single-host
# rewrite.


def global_queue_id(host, queue, num_queues: int):
    """(host, queue) -> global queue id, host-major."""
    return np.asarray(host, np.int64) * int(num_queues) + np.asarray(queue)


def split_host_queue(gids, num_queues: int):
    """Global queue ids -> (host, queue); inverse of ``global_queue_id``."""
    g = np.asarray(gids, np.int64)
    return g // int(num_queues), g % int(num_queues)


def mesh_indirection_table(
    num_hosts: int, num_queues: int, size: int = RETA_SIZE
) -> np.ndarray:
    """Default mesh RETA: round-robin buckets over host-major global ids.

    ``num_hosts=1`` degenerates to ``indirection_table(num_queues)``
    bit-for-bit — single-host is the 1-host mesh, not a special case.
    """
    if num_hosts < 1:
        raise ValueError("need at least one host")
    return indirection_table(num_hosts * num_queues, size)


def mesh_failover_table(
    reta: np.ndarray,
    failed_global: tuple[int, ...],
    *,
    num_hosts: int,
    num_queues: int,
) -> np.ndarray:
    """Remap mesh RETA buckets off dead (host, queue) pairs onto survivors.

    ``failed_global`` names dead pairs by global id (a whole dead host is
    its ``num_queues`` consecutive ids).  Buckets whose pair survives keep
    their exact global id — so a flow whose (host, queue) both survive is
    never remapped, exactly the single-host guarantee lifted to the mesh.
    """
    return failover_table(reta, tuple(failed_global),
                          num_queues=num_hosts * num_queues)


def mesh_queue_of(
    packets: np.ndarray,
    num_hosts: int,
    num_queues: int,
    *,
    key: bytes = DEFAULT_KEY,
    reta: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Full mesh dispatch: flow tuple -> hash -> mesh RETA -> (host, queue)."""
    if reta is None:
        reta = mesh_indirection_table(num_hosts, num_queues)
    gids = queue_of(packets, num_hosts * num_queues, key=key, reta=reta)
    return split_host_queue(gids, num_queues)
