"""AdamW (+ warmup-cosine schedule, global-norm clip), the reference's
``repro.train.optimizer`` over the port's tensors.

Mixed-precision policy, as in the reference:
  * params live in the model dtype (bf16 by default),
  * ``master_weights=True`` keeps an f32 master copy in the optimizer state
    (updates apply to the master, params are re-cast from it each step),
  * ``moments_dtype`` lets enormous models (arctic-480b) hold m/v in bf16.

Params, grads and the moment and master lists are sequences of tensors in
one order (``list(model.parameters())``); the update writes them in place
and returns them.  A gradient of ``None`` (a parameter the loss does not
reach) is a zero gradient: it counts as zero in the norm, and the
parameter still decays, as the reference's zero leaf does.  The step
counter is a 0-d int32 tensor on the CPU, so the schedule and the bias
corrections are host scalars and the update never waits for the device.
Not ``torch.optim.AdamW``: its master copy, bf16 moments and decay round
otherwise, and its state has no reference leaf names.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moments_dtype: str = "float32"
    master_weights: bool = True


def lr_schedule(cfg: OptimizerConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (f32, on ``step``'s device)."""
    step = torch.as_tensor(step).to(F32)
    warm = cfg.learning_rate * step / max(cfg.warmup_steps, 1)
    decay_steps = max(cfg.total_steps - cfg.warmup_steps, 1)
    frac = torch.clamp((step - cfg.warmup_steps) / decay_steps, 0.0, 1.0)
    cosine = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * frac))
    return torch.where(step < cfg.warmup_steps, warm, cfg.learning_rate * cosine)


def adamw_init(params: Sequence[torch.Tensor], cfg: OptimizerConfig) -> dict:
    mdt = getattr(torch, cfg.moments_dtype)
    state = {
        "m": [torch.zeros(p.shape, dtype=mdt, device=p.device) for p in params],
        "v": [torch.zeros(p.shape, dtype=mdt, device=p.device) for p in params],
        "step": torch.zeros((), dtype=torch.int32),
    }
    if cfg.master_weights:
        state["master"] = [p.detach().to(F32, copy=True) for p in params]
    return state


def _f32(xs) -> list:
    return [x.to(F32) for x in xs]


def global_norm(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares."""
    sq = torch.stack([torch.sum(torch.square(x)) for x in _f32(xs)])
    return torch.sqrt(torch.sum(sq))


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float):
    """(grads scaled to ``max_norm`` at most, their global norm); the scale
    is cast to each grad's dtype before the product, as the reference's."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    cast = {dt: scale.to(dt) for dt in {g.dtype for g in grads}}
    return [g * cast[g.dtype] for g in grads], norm


@torch.no_grad()
def adamw_update(grads: Sequence, state: dict, params: Sequence[torch.Tensor],
                 cfg: OptimizerConfig):
    """One AdamW step, written in place.  Returns (params, state, metrics)."""
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]
    step = state["step"] + 1
    lr = lr_schedule(cfg, step)
    grads, grad_norm = clip_by_global_norm(grads, cfg.clip_norm)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = float(1 - torch.pow(torch.tensor(b1, dtype=F32), step.to(F32)))
    bc2 = float(1 - torch.pow(torch.tensor(b2, dtype=F32), step.to(F32)))
    ref = state.get("master", params)

    # f32 working lists: aliases of f32 leaves (updated in place), copies of
    # others; each temporary is dropped as soon as it is used
    gf = _f32(grads)
    m, v, pf = _f32(state["m"]), _f32(state["v"]), _f32(ref)
    torch._foreach_mul_(m, b1)
    torch._foreach_add_(m, torch._foreach_mul(gf, 1 - b1))
    sq = torch._foreach_mul(gf, gf)
    del gf
    torch._foreach_mul_(sq, 1 - b2)
    torch._foreach_mul_(v, b2)
    torch._foreach_add_(v, sq)
    del sq
    den = torch._foreach_div(v, bc2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, cfg.eps)
    delta = torch._foreach_div(m, bc1)
    torch._foreach_div_(delta, den)
    del den
    torch._foreach_add_(delta, torch._foreach_mul(pf, cfg.weight_decay))
    torch._foreach_mul_(delta, float(lr))
    torch._foreach_sub_(pf, delta)  # pf - lr * delta
    del delta

    for dst, src in ((state["m"], m), (state["v"], v), (ref, pf)):
        for d, s in zip(dst, src):
            if d is not s:
                d.copy_(s)
    if cfg.master_weights:
        for p, s in zip(params, pf):
            p.copy_(s)
    state["step"] = step
    return params, state, {"lr": lr, "grad_norm": grad_norm}
