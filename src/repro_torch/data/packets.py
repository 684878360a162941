"""Synthetic IoT-23-like packet workload.

IoT-23 itself is not shipped in this container; we synthesize a labeled
malicious-traffic workload with the same *shape* the paper uses: 1024-byte
payloads mapped to the fixed 1088-byte representation, binary labels, and a
train/validation split keyed by "capture group" ids mirroring the paper's
20-1 / 21-1 / ... group protocol.

Generative model: benign payloads are low-entropy structured bytes
(protocol-header-like prefix + repeated filler); malicious payloads carry
one of several planted high-entropy signature patterns at a random offset,
plus scan-like periodic bytes.  The task is learnable but not trivially
separable (payload noise flips bits), so recall/precision-oriented training
(pos_weight) produces genuinely different operating points — required for
reproducing Fig. 6.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import packet as pkt

TRAIN_GROUPS = ("20-1", "21-1", "33-1", "36-1", "43-1", "48-1")
VAL_GROUPS = ("35-1", "42-1")

_SIGNATURES = [
    bytes([0xDE, 0xAD, 0xBE, 0xEF, 0x13, 0x37]),
    bytes([0x90] * 8),                       # NOP-sled-like
    bytes([0x41, 0x41, 0x41, 0x41, 0x2F, 0x62, 0x69, 0x6E]),  # 'AAAA/bin'
]


@dataclasses.dataclass
class PacketDatasetConfig:
    n_samples: int = 4096
    malicious_frac: float = 0.3
    noise_flip_prob: float = 0.06
    stealth_frac: float = 0.35     # malicious flows w/o periodic scan marker
    benign_burst_frac: float = 0.15  # benign flows with bursty high entropy
    seed: int = 0
    group: str = "20-1"


def _group_seed(cfg: PacketDatasetConfig) -> np.random.Generator:
    gid = sum(ord(c) * (i + 1) for i, c in enumerate(cfg.group))
    return np.random.default_rng(np.random.SeedSequence([cfg.seed, gid]))


def generate(cfg: PacketDatasetConfig) -> tuple[np.ndarray, np.ndarray]:
    """Returns (payload_bytes (N, 1024) uint8, labels (N,) {0,1})."""
    rng = _group_seed(cfg)
    n = cfg.n_samples
    labels = (rng.random(n) < cfg.malicious_frac).astype(np.int64)
    payloads = np.empty((n, pkt.PAYLOAD_BYTES), np.uint8)

    # benign: header-like prefix + low-entropy filler
    header = rng.integers(0, 256, 32, dtype=np.uint8)
    for i in range(n):
        if labels[i]:
            body = rng.integers(0, 256, pkt.PAYLOAD_BYTES, dtype=np.uint8)
            sig = _SIGNATURES[int(rng.integers(len(_SIGNATURES)))]
            off = int(rng.integers(0, pkt.PAYLOAD_BYTES - len(sig)))
            body[off : off + len(sig)] = np.frombuffer(sig, np.uint8)
            if rng.random() > cfg.stealth_frac:
                body[::16] = 0xFF  # scan-like periodic marker (non-stealth)
            payloads[i] = body
        else:
            filler = np.tile(
                rng.integers(0, 64, 16, dtype=np.uint8),
                pkt.PAYLOAD_BYTES // 16,
            )
            payloads[i] = filler
            payloads[i, :32] = header + rng.integers(0, 4, 32, dtype=np.uint8)
            if rng.random() < cfg.benign_burst_frac:
                # bursty benign traffic: a high-entropy media segment that
                # superficially resembles malicious payloads
                seg = int(rng.integers(128, 512))
                off = int(rng.integers(0, pkt.PAYLOAD_BYTES - seg))
                payloads[i, off:off + seg] = rng.integers(
                    0, 256, seg, dtype=np.uint8)
    # channel noise: flip random bits on everything
    flips = rng.random((n, pkt.PAYLOAD_BYTES)) < cfg.noise_flip_prob
    bitpos = rng.integers(0, 8, (n, pkt.PAYLOAD_BYTES), dtype=np.uint8)
    payloads ^= (flips.astype(np.uint8) << bitpos).astype(np.uint8)
    return payloads, labels


def load_split(split: str = "train", samples_per_group: int = 2048,
               seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Concatenate the paper's capture groups for a split."""
    groups = TRAIN_GROUPS if split == "train" else VAL_GROUPS
    xs, ys = [], []
    for g in groups:
        x, y = generate(PacketDatasetConfig(
            n_samples=samples_per_group, seed=seed, group=g))
        xs.append(x)
        ys.append(y)
    return np.concatenate(xs), np.concatenate(ys)


def to_payload_words(payload_bytes: np.ndarray) -> np.ndarray:
    return pkt.payload_bytes_to_words(payload_bytes)


def to_pm1_bits(payload_bytes: np.ndarray) -> np.ndarray:
    """(N, 1024) bytes -> (N, 8192) float32 in {+1, -1} (bit 1 -> -1)."""
    bits = np.unpackbits(payload_bytes, axis=-1, bitorder="little")
    return (1.0 - 2.0 * bits).astype(np.float32)
