"""Unified model API: one entry point per step kind, family-dispatched.

``init`` builds the model (an ``nn.Module`` tree named as the reference's
param pytree) on the card unless the caller asks for another device;
``from_jax_params`` carries the reference's params across and
``to_numpy_params`` gives them back in the reference's layout.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn as tnn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import encdec as _encdec
from repro_torch.models import lm as _lm


def _generator(key, device: torch.device) -> torch.Generator:
    if isinstance(key, torch.Generator):
        return key
    return torch.Generator(device=device).manual_seed(int(key))


def _build(gen, cfg: ModelConfig, device: torch.device) -> tnn.Module:
    if cfg.family == "encdec":
        return _encdec.EncDec(cfg, gen, device)
    return _lm.LM(cfg, gen, device)


def init(key, cfg: ModelConfig, device=None) -> tnn.Module:
    """Random weights from ``key``: a seed, or a ``torch.Generator`` (its
    draws are made on its own device).  ``device=None`` means the card."""
    dev = resolve_device(device)
    return _build(_generator(key, dev), cfg, dev)


def apply(params, batch, cfg: ModelConfig, *, return_cache: bool = False):
    """Full-sequence forward -> (logits, aux[, cache])."""
    if cfg.family == "encdec":
        return _encdec.encdec_apply(params, batch, cfg, return_cache=return_cache)
    return _lm.lm_apply(params, batch, cfg, return_cache=return_cache)


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype=None, device=None):
    """The decode cache (``device=None`` means the card)."""
    dev = resolve_device(device)
    if cfg.family == "encdec":
        return _encdec.init_cache(cfg, batch, seq_len, dtype, device=dev)
    return _lm.init_cache(cfg, batch, seq_len, dtype, device=dev)


def decode_step(params, tokens, cache, cache_len, cfg: ModelConfig, slot_ids=None):
    """One token per row; the cache is written in place and returned."""
    if cfg.family == "encdec":
        return _encdec.encdec_decode_step(params, tokens, cache, cache_len, cfg,
                                          slot_ids)
    return _lm.lm_decode_step(params, tokens, cache, cache_len, cfg, slot_ids)


# ---------------------------------------------------------------------------
# weights across the packages
# ---------------------------------------------------------------------------

def _leaf_tensor(arr, like: torch.Tensor, path: str) -> torch.Tensor:
    """One reference leaf as a tensor of ``like``'s dtype.  bf16 leaves are
    taken as ``ml_dtypes.bfloat16`` arrays or as their uint16 bits."""
    arr = np.array(arr)  # a writable contiguous copy
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"{path}: shape {arr.shape}, the model has {tuple(like.shape)}")
    if like.dtype == torch.bfloat16:
        if arr.dtype.name not in ("bfloat16", "uint16"):
            raise ValueError(f"{path}: bf16 leaf given as {arr.dtype}")
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    t = torch.from_numpy(arr)
    if t.dtype != like.dtype:
        raise ValueError(f"{path}: dtype {arr.dtype}, the model has {like.dtype}")
    return t


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _load(obj, tree, path: str) -> None:
    if isinstance(obj, tnn.ModuleList):
        for i, sub in enumerate(obj):
            _load(sub, _index(tree, i), f"{path}[{i}]")
        return
    names = set(obj._parameters) | set(obj._modules)
    if set(tree) != names:
        raise ValueError(f"{path or 'params'}: keys {sorted(tree)}, the model "
                         f"has {sorted(names)}")
    for name, value in tree.items():
        if name in obj._parameters:
            param = obj._parameters[name]
            with torch.no_grad():
                param.copy_(_leaf_tensor(value, param, f"{path}/{name}"))
        else:
            _load(obj._modules[name], value, f"{path}/{name}")


def load_params(module: tnn.Module, params_np: dict) -> tnn.Module:
    """Copy the reference's params of one block (or of the whole model)
    into ``module``, on its device; the keys must match exactly."""
    _load(module, params_np, "")
    return module


def from_jax_params(params_np: dict, cfg: ModelConfig, device=None) -> tnn.Module:
    """The port's model holding the reference's params: nested dicts of
    NumPy arrays (bf16 as ``ml_dtypes.bfloat16`` or uint16 bits), with the
    leading layer axis (the hybrid's ``(n_groups, attn_every, ...)`` axes)
    unstacked into the ``ModuleList``s.  ``device=None`` means the card."""
    dev = resolve_device(device)
    return load_params(_build(None, cfg, dev), params_np)


def _stack(dumps: list):
    if isinstance(dumps[0], dict):
        return {k: _stack([d[k] for d in dumps]) for k in dumps[0]}
    return np.stack(dumps)


def _dump(obj):
    if isinstance(obj, tnn.ModuleList):
        return _stack([_dump(sub) for sub in obj])
    out = {}
    for name, param in obj._parameters.items():
        t = param.detach().cpu()
        arr = (t.view(torch.int16).numpy().view(np.uint16)
               if t.dtype == torch.bfloat16 else t.numpy())
        out[name] = arr.copy()
    for name, sub in obj._modules.items():
        out[name] = _dump(sub)
    return out


def to_numpy_params(model: tnn.Module) -> dict:
    """The model's weights in the reference's pytree layout, as NumPy
    arrays (bf16 as uint16 bits); ``from_jax_params`` takes them back."""
    return _dump(model)
