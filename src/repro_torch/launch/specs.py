"""Meta-tensor stand-ins for every (arch x shape) dry-run cell (torch port
of the reference's ``launch/specs.py``).

No byte is allocated here: batches, caches, parameters and the train state
are tensors on the ``meta`` device, with the reference's shapes and dtypes.
Parameters are built without drawing (``meta`` has no generator).  The
optimizer's step counters stay real CPU tensors: ``adamw_update`` reads
them on the host.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import api
from repro_torch.train import optimizer as opt_lib

META = torch.device("meta")


def _meta(shape, dtype) -> torch.Tensor:
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    return torch.empty(shape, dtype=dt, device=META)


def _text_batch(cfg: ModelConfig, shape: ShapeConfig, with_labels: bool) -> dict:
    b, s = shape.global_batch, shape.seq_len
    if cfg.family == "encdec":
        # split the position budget between encoder frames and decoder tokens
        s_half = s // 2
        batch = {"frames": _meta((b, s_half, cfg.d_model), cfg.dtype),
                 "tokens": _meta((b, s_half), torch.int32)}
        if with_labels:
            batch["labels"] = _meta((b, s_half), torch.int32)
            batch["loss_mask"] = _meta((b, s_half), torch.float32)
        return batch
    batch = {}
    s_text = s
    if cfg.frontend == "patch":
        s_text = s - cfg.frontend_len
        batch["patch_embeds"] = _meta((b, cfg.frontend_len, cfg.d_model), cfg.dtype)
    batch["tokens"] = _meta((b, s_text), torch.int32)
    if with_labels:
        batch["labels"] = _meta((b, s_text), torch.int32)
        batch["loss_mask"] = _meta((b, s_text), torch.float32)
    return batch


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    return _text_batch(cfg, shape, with_labels=True)


def prefill_batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    batch = _text_batch(cfg, shape, with_labels=False)
    if cfg.family != "encdec" and cfg.bank_mode in ("adapter", "head"):
        batch["slot_ids"] = _meta((shape.global_batch,), torch.int32)
    return batch


def decode_input_specs(cfg: ModelConfig, shape: ShapeConfig):
    """(tokens, cache, cache_len, slot_ids) as meta tensors."""
    b, s = shape.global_batch, shape.seq_len
    cache = api.init_cache(cfg, b, s, device=META)
    tokens = _meta((b, 1), torch.int32)
    slot_ids = (_meta((b,), torch.int32)
                if cfg.bank_mode in ("adapter", "head") else None)
    return tokens, cache, _meta((), torch.int32), slot_ids


def param_shape_specs(cfg: ModelConfig):
    """The model's module tree on ``meta``, nothing drawn."""
    return api._build(None, cfg, META)


def train_state_specs(cfg: ModelConfig, opt_cfg: opt_lib.OptimizerConfig) -> dict:
    params = param_shape_specs(cfg)
    return {"params": params,
            "opt": opt_lib.adamw_init(list(params.parameters()), opt_cfg),
            "step": torch.zeros((), dtype=torch.int32)}


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                opt_cfg: opt_lib.OptimizerConfig | None = None) -> dict:
    """Everything the dry-run needs for one cell, keyed by step kind."""
    opt_cfg = opt_cfg or opt_lib.OptimizerConfig(
        moments_dtype=cfg.moments_dtype,
        master_weights=cfg.master_weights,
    )
    if shape.kind == "train":
        return {
            "kind": "train",
            "state": train_state_specs(cfg, opt_cfg),
            "batch": train_batch_specs(cfg, shape),
            "opt_cfg": opt_cfg,
        }
    if shape.kind == "prefill":
        return {
            "kind": "prefill",
            "params": param_shape_specs(cfg),
            "batch": prefill_batch_specs(cfg, shape),
        }
    if shape.kind == "decode":
        tokens, cache, cache_len, slot_ids = decode_input_specs(cfg, shape)
        return {
            "kind": "decode",
            "params": param_shape_specs(cfg),
            "tokens": tokens,
            "cache": cache,
            "cache_len": cache_len,
            "slot_ids": slot_ids,
        }
    raise ValueError(shape.kind)
