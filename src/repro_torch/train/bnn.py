"""BNN training with straight-through estimation (BinaryConnect-style),
torch port.

Trains the paper's h32 classifier on the synthetic IoT-23-like workload.
Latent weights are real-valued; the forward pass binarizes layer 1 with a
straight-through ``sign``; ``pos_weight`` reproduces the recall-oriented
(4.0) vs precision-oriented (0.5) slot pair of Fig. 6.  The trained latents
are packed into the resident-bank format via ``executor.pack_real_weights``.

The two matrix products of ``latent_forward`` are plain ``torch.matmul``
under autograd: the reference computes them outside any Pallas kernel too.
``evaluate`` runs the packed slot through ``executor.forward``, so on a
CUDA slot it launches ``xnor_matmul``.

Initial latents come from a seeded ``torch.Generator`` (drawn on the CPU,
so a seed gives the same latent on every device), not from the
reference's ``jax.random`` keys: the two packages start from different
weights for the same seed.  The batch order is the reference's
``np.random.default_rng(0)`` permutation, so both see the same batches.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import executor
from repro_torch.core import packet as pkt
from repro_torch.data import packets as pk
from repro_torch.device import resolve_device
from repro_torch.train.losses import weighted_bce_with_logits


class _Clip(torch.autograd.Function):
    """``clip(x, -1, 1)`` with the reference's gradient: 1 inside, 0
    outside, and 0.5 at exactly +-1, where ``jnp.clip``'s min/max split
    the tie (``torch.clamp`` gives 1 there)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x.clamp(-1.0, 1.0)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        a = x.abs()
        return grad * torch.where(a < 1.0, 1.0, torch.where(a == 1.0, 0.5, 0.0))


def ste_sign(x):
    """sign with identity gradient inside [-1, 1] (STE)."""
    s = torch.where(x >= 0, 1.0, -1.0).to(x.dtype)
    clipped = _Clip.apply(x)
    return (s - clipped).detach() + clipped


def init_latent(generator: torch.Generator, cfg: executor.BNNConfig = executor.H32,
                *, device=None) -> dict:
    """Latent weights drawn from ``generator`` (a CPU generator) and placed
    on ``device`` (``None``: CUDA)."""
    dev = resolve_device(device)
    d, h, c = cfg.d_bits, cfg.hidden, cfg.n_out
    return {
        "w1": (torch.randn((h, d), generator=generator) * 0.01).to(dev),
        "b1": torch.zeros((h,), device=dev),
        "w2": (torch.randn((c, h), generator=generator) * (1.0 / np.sqrt(h))).to(dev),
        "b2": torch.zeros((c,), device=dev),
    }


def latent_forward(latent, x_pm1):
    """x_pm1: (B, d) in {+-1}.  Binary weights + binary activations w/ STE."""
    w1b = ste_sign(latent["w1"])
    pre = x_pm1 @ w1b.T + latent["b1"]
    h = ste_sign(pre / math.sqrt(x_pm1.shape[-1]))  # normalized pre-activation
    return h @ latent["w2"].T + latent["b2"]


def _sgd_step(latent, x, y, *, pos_weight: float, lr: float):
    """One plain SGD step on the weighted BCE; returns the new latent and
    the step's loss (a 0-d tensor, left on the device)."""
    params = {k: v.detach().requires_grad_(True) for k, v in latent.items()}
    scores = latent_forward(params, x)[:, 0]
    loss = weighted_bce_with_logits(scores, y, pos_weight)
    grads = torch.autograd.grad(loss, list(params.values()))
    new = {k: (p - lr * g).detach() for (k, p), g in zip(params.items(), grads)}
    return new, loss.detach()


def train_bnn(
    latent: dict,
    x_train,                 # (N, 8192) +-1 float, numpy or a tensor
    y_train,                 # (N,) {0,1}
    *,
    pos_weight: float,
    epochs: int = 5,
    batch: int = 256,
    lr: float = 0.05,
):
    """SGD from the initial ``latent`` (``init_latent``) on the latent's
    device.  The data goes to that device once and the batches are indexed
    there, in the reference's order.  Returns the trained latent and the
    per-step losses."""
    dev = latent["w1"].device
    x = torch.as_tensor(x_train, dtype=torch.float32, device=dev)
    y = torch.as_tensor(y_train, device=dev)
    n = x.shape[0]
    rng = np.random.default_rng(0)
    losses = []
    for _ in range(epochs):
        order = torch.from_numpy(rng.permutation(n)).to(dev)
        for i in range(0, n - batch + 1, batch):
            idx = order[i : i + batch]
            latent, loss = _sgd_step(latent, x[idx], y[idx],
                                     pos_weight=pos_weight, lr=lr)
            losses.append(loss)
    return latent, (torch.stack(losses).tolist() if losses else [])


def pack_trained(latent, cfg: executor.BNNConfig = executor.H32) -> dict:
    """Latent -> packed resident-slot params (bit-exact executor semantics),
    on the latent's device.

    The packed executor computes ``sign(W1b x + b1)``; training used the
    sqrt(d)-normalized pre-activation, so b1 is rescaled accordingly (in
    float64, rounded to float32 once, as the reference does).
    """
    host = {k: v.detach().cpu().numpy() for k, v in latent.items()}
    scale = np.sqrt(cfg.d_bits)
    return executor.pack_real_weights(
        host["w1"], host["b1"] * scale, host["w2"], host["b2"],
        device=latent["w1"].device)


def evaluate(params, payload_words: np.ndarray, labels: np.ndarray) -> dict:
    """Precision / recall / F1 of a packed slot on payload words (uint32),
    computed on the slot's device."""
    x = pkt.to_device(np.asarray(payload_words), params["w1p"].device)
    scores = executor.forward(params, x)[:, 0].cpu().numpy()
    pred = scores > 0
    tp = int((pred & (labels == 1)).sum())
    fp = int((pred & (labels == 0)).sum())
    fn = int((~pred & (labels == 1)).sum())
    precision = tp / max(tp + fp, 1)
    recall = tp / max(tp + fn, 1)
    f1 = 2 * precision * recall / max(precision + recall, 1e-9)
    return {"precision": precision, "recall": recall, "f1": f1,
            "tp": tp, "fp": fp, "fn": fn}


def train_slot_pair(seed: int = 0, epochs: int = 4, samples_per_group: int = 1024,
                    *, device=None):
    """Train the paper's two slots (recall- and precision-oriented) on
    ``device`` (``None``: CUDA).  The training split goes to the device
    once and serves both slots."""
    dev = resolve_device(device)
    xb, yb = pk.load_split("train", samples_per_group, seed)
    x = torch.from_numpy(pk.to_pm1_bits(xb)).to(dev)
    gen = torch.Generator().manual_seed(seed)
    slots = []
    for pos_weight in (4.0, 0.5):
        latent, _ = train_bnn(init_latent(gen, device=dev), x, yb,
                              pos_weight=pos_weight, epochs=epochs)
        slots.append(pack_trained(latent))
    return tuple(slots)
