"""Online fine-tuning of BNN slot models on live-sampled packets (torch port).

``OnlineTrainer`` takes a sampled labeled batch (payload words from a
``PacketSampler``), runs a bounded number of STE-SGD steps through the
port's training step (``train.bnn._sgd_step``) on its device, packs the
latents into resident-slot format with ``executor.pack_real_weights`` (via
``bnn.pack_trained``), evaluates on a held-out slice (``bnn.evaluate``:
``executor.forward``, so ``xnor_matmul`` on the card), and commits every
fine-tune as an atomic checkpoint step (``checkpoint.store.save``) so a
rollout decision is always traceable to restorable weights.

The holdout split and the minibatch indices come from
``np.random.default_rng(seed + step)``, as in the reference, so from a
shared ``warm_latent`` both packages take the same steps.  A cold start
draws its latent with ``bnn.init_latent`` from a ``torch.Generator``
seeded ``seed + step``, where the reference draws from
``jax.random.PRNGKey(seed + step)``: a cold fine-tune starts from other
weights in each package, by design.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.checkpoint import store
from repro_torch.core import executor
from repro_torch.data import packets as pk
from repro_torch.device import resolve_device
from repro_torch.train import bnn


def words_to_pm1(payload_words: np.ndarray) -> np.ndarray:
    """(N, 256) uint32 payload words -> (N, 8192) +-1 float32 bits."""
    words = np.ascontiguousarray(np.asarray(payload_words, dtype="<u4"))
    return pk.to_pm1_bits(words.view(np.uint8).reshape(words.shape[0], -1))


@dataclasses.dataclass
class TrainResult:
    params: dict                  # packed resident-slot weights
    latent: dict                  # real-valued latents (warm-start source)
    step: int                     # checkpoint step id
    metrics: dict                 # holdout precision/recall/f1/err + losses
    checkpoint_path: str | None
    train_us: float


class OnlineTrainer:
    """Bounded-step STE fine-tuner with atomic checkpoint commits, on
    ``device`` (``None``: CUDA)."""

    def __init__(self, *, checkpoint_dir: str | None = None, steps: int = 48,
                 batch: int = 128, lr: float = 0.05, pos_weight: float = 2.0,
                 holdout_frac: float = 0.25, seed: int = 0,
                 keep_last: int | None = 4,
                 cfg: executor.BNNConfig = executor.H32, device=None):
        self.device = resolve_device(device)
        self.checkpoint_dir = checkpoint_dir
        self.steps = int(steps)
        self.batch = int(batch)
        self.lr = float(lr)
        self.pos_weight = float(pos_weight)
        self.holdout_frac = float(holdout_frac)
        self.seed = int(seed)
        self.keep_last = keep_last
        self.cfg = cfg
        self._step = 0

    def fine_tune(self, payload_words: np.ndarray, labels: np.ndarray, *,
                  warm_latent: dict | None = None,
                  extra: dict | None = None) -> TrainResult:
        t0 = time.perf_counter()
        dev = self.device
        payload_words = np.asarray(payload_words, np.uint32)
        labels = np.asarray(labels).astype(np.float32)
        n = payload_words.shape[0]
        if n < 2:
            raise ValueError(f"need >= 2 labeled samples, got {n}")
        rng = np.random.default_rng(self.seed + self._step)
        order = rng.permutation(n)
        n_hold = max(1, int(n * self.holdout_frac))
        hold, train = order[:n_hold], order[n_hold:]
        if train.size == 0:
            train = order

        x = torch.from_numpy(words_to_pm1(payload_words[train])).to(dev)
        y = torch.from_numpy(labels[train]).to(dev)
        if warm_latent is not None:
            latent = {k: (v if isinstance(v, torch.Tensor) else
                          torch.from_numpy(np.array(v, np.float32))).to(
                              dev, torch.float32)
                      for k, v in warm_latent.items()}
        else:
            latent = bnn.init_latent(
                torch.Generator().manual_seed(self.seed + self._step),
                self.cfg, device=dev)
        losses = []
        bsz = min(self.batch, train.size)
        for _ in range(self.steps):
            idx = torch.from_numpy(rng.integers(0, train.size, size=bsz)).to(dev)
            latent, loss = bnn._sgd_step(
                latent, x[idx], y[idx],
                pos_weight=self.pos_weight, lr=self.lr)
            losses.append(loss)
        losses = torch.stack(losses).tolist()  # one device-to-host copy

        params = bnn.pack_trained(latent, self.cfg)
        hold_labels = labels[hold].astype(np.int64)
        metrics = bnn.evaluate(params, payload_words[hold], hold_labels)
        metrics["err"] = (metrics["fp"] + metrics["fn"]) / max(n_hold, 1)
        metrics.update(samples=int(n), holdout=int(n_hold),
                       steps=self.steps, loss_first=losses[0],
                       loss_last=losses[-1])

        step, path = self._step, None
        if self.checkpoint_dir is not None:
            path = store.save(
                self.checkpoint_dir, step, latent,
                extra={"metrics": {k: float(v) for k, v in metrics.items()},
                       **(extra or {})},
                keep_last=self.keep_last)
        self._step += 1
        return TrainResult(params=params, latent=latent, step=step,
                           metrics=metrics, checkpoint_path=path,
                           train_us=(time.perf_counter() - t0) * 1e6)
