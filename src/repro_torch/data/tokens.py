"""Synthetic token pipeline with exact-resume cursor semantics (the
reference's ``SyntheticTokens``, NumPy only, carried over as the port's own).

Deterministic: batch ``i`` is a pure function of (seed, i, host id), so
restoring a checkpoint at step N reproduces the identical remaining stream
on any host count (batches are sharded by host below the global index).
For the same configuration the batches are bit-equal to the reference's.

The generator plants learnable n-gram structure (a random bigram transition
table) so example training runs show decreasing loss rather than noise.
Batches are NumPy arrays; the trainer moves them to its device.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TokenPipelineConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    structured: bool = True     # bigram-structured (learnable) vs uniform
    n_hosts: int = 1
    host_id: int = 0


class SyntheticTokens:
    def __init__(self, cfg: TokenPipelineConfig):
        self.cfg = cfg
        self._step = 0
        if cfg.structured:
            rng = np.random.default_rng(cfg.seed)
            # sparse-ish bigram table: each token has ~8 likely successors
            self._succ = rng.integers(0, cfg.vocab_size, size=(cfg.vocab_size, 8))

    # ------------------------------------------------------------------
    @property
    def cursor(self) -> int:
        return self._step

    def restore(self, cursor: int):
        self._step = int(cursor)

    # ------------------------------------------------------------------
    def _gen(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, cfg.host_id]))
        b, s, v = cfg.global_batch // cfg.n_hosts, cfg.seq_len, cfg.vocab_size
        if cfg.structured:
            toks = np.empty((b, s + 1), np.int32)
            toks[:, 0] = rng.integers(0, v, b)
            choice = rng.integers(0, 8, (b, s))
            noise = rng.random((b, s)) < 0.1
            rand = rng.integers(0, v, (b, s))
            for t in range(s):
                nxt = self._succ[toks[:, t], choice[:, t]]
                toks[:, t + 1] = np.where(noise[:, t], rand[:, t], nxt)
        else:
            toks = rng.integers(0, v, (b, s + 1), dtype=np.int32)
        return {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:].astype(np.int32),
            "loss_mask": np.ones((b, s), np.float32),
        }

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        batch = self._gen(self._step)
        self._step += 1
        return batch
