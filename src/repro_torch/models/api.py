"""Unified model API: one entry point per step kind, family-dispatched.

``init`` builds the model (an ``nn.Module`` tree named as the reference's
param pytree) on the card unless the caller asks for another device;
``from_jax_params`` carries the reference's params across and
``to_numpy_params`` gives them back in the reference's layout.  The same
walk carries any per-parameter state laid out like the params (the
optimizer's moments and master copy): ``to_numpy_params(model, of=...)``
and ``load_params(model, tree, into=...)``, with ``of`` / ``into`` mapping
each parameter to the tensor that stands in its place.
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


def _layout(cfg: ModelConfig, batch: int, seq_len: int, dtype=None) -> dict:
    """The decode cache's leaves, as the module that builds it states them."""
    return (_encdec if cfg.family == "encdec" else _lm).cache_layout(cfg, batch, seq_len, dtype)


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype=None, device=None):
    """The decode cache (``device=None`` means the card)."""
    return _lm.alloc_cache(_layout(cfg, batch, seq_len, dtype), resolve_device(device))


def write_cache_row(cfg: ModelConfig, cache, row: int, row_cache) -> None:
    """A one-row prefill cache (``apply(..., return_cache=True)``'s)
    written into batch row ``row`` of the decode cache ``cache``: each KV
    leaf's first ``min(S, Lc)`` positions, SSM and conv state whole."""
    _lm.write_cache_row(_layout(cfg, 1, 1), cache, row, row_cache)


def kv_positions(cfg: ModelConfig, seq_len: int) -> int:
    """Positions a KV row of a cache for ``seq_len`` tokens holds; 0 where
    ``cfg``'s family holds no KV."""
    return _lm.kv_positions(_layout(cfg, 1, seq_len))


def decode_step(params, tokens, cache, cache_len, cfg: ModelConfig, slot_ids=None,
                spans=None):
    """One token per row; the cache is written in place and returned.
    ``spans`` (a ``SpanRecorder``) times the mamba layers, the ``zamba2``
    sites and the banked head inside the step."""
    if cfg.family == "encdec":
        return _encdec.encdec_decode_step(params, tokens, cache, cache_len, cfg,
                                          slot_ids)
    return _lm.lm_decode_step(params, tokens, cache, cache_len, cfg, slot_ids, spans)


# ---------------------------------------------------------------------------
# weights across the packages
# ---------------------------------------------------------------------------

def _leaf_tensor(arr, like: torch.Tensor, path: str) -> torch.Tensor:
    """One reference leaf as a tensor of ``like``'s dtype.  bf16 leaves are
    taken as ``ml_dtypes.bfloat16`` arrays or as their uint16 bits; a
    tensor (a restored checkpoint's leaf) is taken as it is."""
    if isinstance(arr, torch.Tensor):
        if tuple(arr.shape) != tuple(like.shape) or arr.dtype != like.dtype:
            raise ValueError(f"{path}: {arr.dtype} {tuple(arr.shape)}, the model "
                             f"has {like.dtype} {tuple(like.shape)}")
        return arr
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


def _load(obj, tree, path: str, into) -> None:
    if isinstance(obj, tnn.ModuleList):
        for i, sub in enumerate(obj):
            _load(sub, _index(tree, i), f"{path}[{i}]", into)
        return
    names = set(obj._parameters) | set(obj._modules)
    if set(tree) != names:
        raise ValueError(f"{path or 'params'}: keys {sorted(tree)}, the model "
                         f"has {sorted(names)}")
    for name, value in tree.items():
        if name in obj._parameters:
            dst = into(obj._parameters[name])
            with torch.no_grad():
                dst.copy_(_leaf_tensor(value, dst, f"{path}/{name}"))
        else:
            _load(obj._modules[name], value, f"{path}/{name}", into)


def load_params(module: tnn.Module, params_np: dict, into=None) -> tnn.Module:
    """Copy the reference's params of one block (or of the whole model)
    into ``module``, on its device; the keys must match exactly.  With
    ``into`` (parameter -> tensor), each leaf goes into ``into(param)``
    instead: per-parameter state laid out like the params."""
    _load(module, params_np, "", into or (lambda p: p))
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


def _dump(obj, of):
    if isinstance(obj, tnn.ModuleList):
        return _stack([_dump(sub, of) for sub in obj])
    out = {}
    for name, param in obj._parameters.items():
        t = of(param).detach().cpu()
        arr = (t.view(torch.int16).numpy().view(np.uint16)
               if t.dtype == torch.bfloat16 else t.numpy())
        out[name] = arr.copy()
    for name, sub in obj._modules.items():
        out[name] = _dump(sub, of)
    return out


def to_numpy_params(model: tnn.Module, of=None) -> dict:
    """The model's weights in the reference's pytree layout, as NumPy
    arrays (bf16 as uint16 bits); ``from_jax_params`` takes them back.
    With ``of`` (parameter -> tensor), each leaf is ``of(param)`` instead:
    per-parameter state laid out like the params."""
    return _dump(model, of or (lambda p: p))
