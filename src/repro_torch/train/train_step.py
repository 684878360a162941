"""Train / prefill / decode step builders (torch port of the reference's
``repro.train.train_step``).

* microbatched gradient accumulation: each microbatch's gradients are added
  into f32 zeros and divided by the count, so with more than one
  microbatch the grads reaching the clip are f32 even for a bf16 model,
  and the reported loss is the mean of the microbatches' totals (loss plus
  the weighted aux) with ``aux`` reported as 0, as the reference's;
* an optional int8 gradient codec stage, leaf by leaf before the update;
* f32 loss, AdamW from ``repro_torch.train.optimizer``.

State: ``{"params": model, "opt": adamw state, "step": 0-d int32 (CPU)}``.
A step updates it in place and returns it.  ``state_tree`` /
``load_state`` carry it to and from the reference's pytree
(``{"params", "opt": {"m", "v", "step"[, "master"]}, "step"}``, layer axes
stacked), which is what the trainer checkpoints.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import compress as compress_lib
from repro_torch.models import api
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.losses import cross_entropy

AUX_LOSS_WEIGHT = 0.01


def make_loss_fn(cfg: ModelConfig) -> Callable:
    def loss_fn(params, batch):
        logits, aux = api.apply(params, batch, cfg)
        labels = batch["labels"]
        mask = batch.get("loss_mask")
        if cfg.frontend == "patch":
            # logits cover [patches; text] — score text positions only
            logits = logits[:, -labels.shape[1]:]
        loss = cross_entropy(logits, labels, mask)
        return loss + AUX_LOSS_WEIGHT * aux, {"loss": loss, "aux": aux}

    return loss_fn


def _grads(loss_fn, model, params, batch):
    """(total, metrics, grads): one backward; a parameter the loss does not
    reach has grad ``None``."""
    for p in params:
        p.grad = None
    total, metrics = loss_fn(model, batch)
    total.backward()
    grads = [p.grad for p in params]
    for p in params:
        p.grad = None
    return total.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def _placed_like(grads: list, params: list) -> list:
    """Each DTensor gradient reduced once to its parameter's placements:
    a pending sum (``Partial``) would otherwise be reduced again by every
    optimizer op that reads it.  Plain tensors pass as they are."""
    return [g.redistribute(p.device_mesh, p.placements)
            if isinstance(g, DTensor) else g for g, p in zip(grads, params)]


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: opt_lib.OptimizerConfig,
    *,
    num_microbatches: int = 1,
    compress_gradients: bool = False,
) -> Callable:
    loss_fn = make_loss_fn(cfg)

    def train_step(state, batch):
        model = state["params"]
        params = list(model.parameters())
        if num_microbatches <= 1:
            _, metrics, grads = _grads(loss_fn, model, params, batch)
        else:
            grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for p in params]
            losses = []
            for i in range(num_microbatches):
                mb = {k: v.reshape(num_microbatches, v.shape[0] // num_microbatches,
                                   *v.shape[1:])[i] for k, v in batch.items()}
                total, _, g = _grads(loss_fn, model, params, mb)
                losses.append(total)
                for acc, gi in zip(grads, g):
                    if gi is not None:
                        acc.add_(gi)
            grads = [g / num_microbatches for g in grads]
            metrics = {"loss": torch.stack(losses).mean(),
                       "aux": torch.zeros((), dtype=torch.float32, device=losses[0].device)}

        grads = _placed_like(grads, params)
        if compress_gradients:
            grads = compress_lib.compress_grads(grads)

        _, state["opt"], opt_metrics = opt_lib.adamw_update(
            grads, state["opt"], params, opt_cfg)
        state["step"] = state["step"] + 1
        return state, dict(metrics, **opt_metrics)

    return train_step


def init_train_state(key, cfg: ModelConfig, opt_cfg: opt_lib.OptimizerConfig,
                     device=None) -> dict:
    """Random weights from ``key`` (``api.init``; ``device=None`` means the
    card), zero moments, the master copy and step 0."""
    params = api.init(key, cfg, device=device)
    return {
        "params": params,
        "opt": opt_lib.adamw_init(list(params.parameters()), opt_cfg),
        "step": torch.zeros((), dtype=torch.int32),
    }


# ---------------------------------------------------------------------------
# the state in the reference's layout (what the trainer checkpoints)
# ---------------------------------------------------------------------------

_OPT_LISTS = ("m", "v", "master")


def _by_param(state) -> dict:
    """Each optimizer list ("m", "v", "master") as a parameter -> tensor map."""
    params = list(state["params"].parameters())
    return {name: dict(zip(params, state["opt"][name]))
            for name in _OPT_LISTS if name in state["opt"]}


def _bf16(tree):
    """uint16 leaves (``to_numpy_params``' bf16 bits) as bf16 tensors, which
    ``store.save`` records under the reference's dtype name."""
    if isinstance(tree, dict):
        return {k: _bf16(v) for k, v in tree.items()}
    if tree.dtype == np.uint16:
        return torch.from_numpy(tree.view(np.int16)).view(torch.bfloat16)
    return tree


def state_tree(state) -> dict:
    """The state as the reference's pytree on the host (NumPy arrays, bf16
    leaves as bf16 tensors), layer axes stacked: ``store.save`` writes it
    under the reference's leaf names, so either package's trainer resumes
    it."""
    model = state["params"]
    opt = {name: api.to_numpy_params(model, of=m.__getitem__)
           for name, m in _by_param(state).items()}
    opt["step"] = np.asarray(state["opt"]["step"], np.int32)
    return _bf16({"params": api.to_numpy_params(model), "opt": opt,
                  "step": np.asarray(state["step"], np.int32)})


def load_state(state, tree) -> dict:
    """Copy ``tree`` (``state_tree``'s layout: NumPy arrays, or the tensors
    ``store.restore`` gives) into ``state`` in place; returns it."""
    model = state["params"]
    api.load_params(model, tree["params"])
    for name, m in _by_param(state).items():
        api.load_params(model, tree["opt"][name], into=m.__getitem__)
    state["opt"]["step"] = torch.as_tensor(tree["opt"]["step"]).to("cpu", torch.int32)
    state["step"] = torch.as_tensor(tree["step"]).to("cpu", torch.int32)
    return state


# ---------------------------------------------------------------------------
# serving-side steps
# ---------------------------------------------------------------------------

def _last_logits(logits):
    """The last position's logits, (B, 1, V); a DTensor's replicated first
    (DTensor's argmax over a dim sharded on several mesh dims fails on some
    PyTorch releases)."""
    last = logits[:, -1:]
    if isinstance(last, DTensor):
        last = last.redistribute(last.device_mesh, [Replicate()] * last.device_mesh.ndim)
    return last


# ``no_grad``, not ``inference_mode``: a DTensor view cannot be made in
# inference mode, and the dry-run runs these steps on DTensors.

def make_prefill_step(cfg: ModelConfig) -> Callable:
    @torch.no_grad()
    def prefill_step(params, batch):
        logits, aux, cache = api.apply(params, batch, cfg, return_cache=True)
        next_token = torch.argmax(_last_logits(logits), dim=-1).to(torch.int32)
        return next_token, cache

    return prefill_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    @torch.no_grad()
    def serve_step(params, tokens, cache, cache_len, slot_ids=None):
        logits, new_cache = api.decode_step(params, tokens, cache, cache_len, cfg,
                                            slot_ids)
        next_token = torch.argmax(_last_logits(logits), dim=-1)[..., 0].to(torch.int32)
        return next_token, new_cache

    return serve_step
