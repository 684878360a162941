"""Decoder-LM family: dense (llama-style), MoE, SSM (mamba2), hybrid (zamba2),
with the VLM patch-embedding frontend stub and the model-bank technique
(adapter / head / full residency) integrated as a first-class feature.

One module tree serves all families; ``cfg.family`` selects the layer
stack.  The reference scans stacked params; here each stack is an
``nn.ModuleList`` looped in Python, and ``models.api.from_jax_params``
unstacks the reference's leading layer axis into it.

Hybrid structure (zamba2): ``n_groups = L // attn_every`` groups, each =
``attn_every`` mamba layers followed by ONE application of a *shared*
attention block (one module called from every group — itself a resident
shared executor in the BoundSwitch sense), plus trailing mamba layers.

Caches keep the reference's leaf names and layouts, stacked over layers:
KV ``(L, B, G, Lc, hd)``, SSM state ``(..., n, B, H, P, N)``, conv state
``(..., n, B, W-1, C)``; decode writes them in place.  ``cfg.remat`` is a
training knob: serving runs under ``torch.inference_mode()`` and ignores it.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn as tnn

from repro_torch.configs.base import ModelConfig
from repro_torch.nn import modules as nn
from repro_torch.nn import moe as moe_lib
from repro_torch.nn import ssd as ssd_lib


# ---------------------------------------------------------------------------
# adapters (the banked technique at LM scale)
# ---------------------------------------------------------------------------

class Adapter(tnn.Module):
    """Banked low-rank delta: K resident (d->r->out) adapters."""

    def __init__(self, cfg: ModelConfig, out_dim: int, gen, device):
        super().__init__()
        k, r, d, dt = cfg.bank_slots, cfg.adapter_rank, cfg.d_model, nn.cdtype(cfg)
        self.a = nn._dense_init(gen, (k, d, r), dt, device)
        self.b = nn._const(0.0, (k, r, out_dim), dt, device)  # zero-init: no-op at start


def adapter_apply(p: Adapter, x: torch.Tensor, slot_ids: torch.Tensor) -> torch.Tensor:
    """x: (B, S, d); slot_ids: (B,) -> (B, S, out).  Per-request gather is
    cheap because adapters are low-rank (the 'take' strategy)."""
    return torch.bmm(torch.bmm(x, p.a[slot_ids]), p.b[slot_ids])


# ---------------------------------------------------------------------------
# layer definitions
# ---------------------------------------------------------------------------

class DenseLayer(tnn.Module):
    """Attention + SwiGLU (dense) or attention + MoE (moe family)."""

    def __init__(self, cfg: ModelConfig, gen, device, moe: bool = False):
        super().__init__()
        dt = nn.cdtype(cfg)
        self.ln1 = nn.RMSNorm(cfg.d_model, dt, device)
        self.attn = nn.Attention(cfg, gen, device)
        self.ln2 = nn.RMSNorm(cfg.d_model, dt, device)
        if moe:
            self.moe = moe_lib.MoE(cfg, gen, device)
            if cfg.moe_dense_residual:
                self.dense_mlp = nn.MLP(cfg, gen, device)
        else:
            self.mlp = nn.MLP(cfg, gen, device)
        if cfg.bank_mode == "adapter":
            self.adapter = Adapter(cfg, cfg.d_model, gen, device)


class SSMLayer(tnn.Module):
    def __init__(self, cfg: ModelConfig, gen, device):
        super().__init__()
        self.ln1 = nn.RMSNorm(cfg.d_model, nn.cdtype(cfg), device)
        self.mamba = ssd_lib.Mamba(cfg, gen, device)
        if cfg.bank_mode == "adapter":
            self.adapter = Adapter(cfg, cfg.d_model, gen, device)


def _dense_layer_apply(lp: DenseLayer, x, cfg, *, positions, kv_cache=None,
                       cache_len=None, slot_ids=None, moe_capacity=None, pad_mask=None):
    h, new_kv = nn.attention_apply(
        lp.attn, nn.rmsnorm(lp.ln1, x, cfg.norm_eps), cfg,
        positions=positions, kv_cache=kv_cache, cache_len=cache_len,
    )
    x = x + h
    xn = nn.rmsnorm(lp.ln2, x, cfg.norm_eps)
    aux = torch.zeros((), dtype=nn.F32, device=x.device)
    if cfg.family == "moe" and hasattr(lp, "moe"):
        m, aux = moe_lib.moe_apply(lp.moe, xn, cfg, capacity=moe_capacity,
                                   token_mask=pad_mask)
        if cfg.moe_dense_residual:
            m = m + nn.mlp_apply(lp.dense_mlp, xn)
    else:
        m = nn.mlp_apply(lp.mlp, xn)
    if hasattr(lp, "adapter") and slot_ids is not None:
        m = m + adapter_apply(lp.adapter, xn, slot_ids)
    return x + m, new_kv, aux


def _ssm_layer_apply(lp: SSMLayer, x, cfg, *, ssm_state=None, conv_state=None,
                     slot_ids=None, pad_mask=None, last_valid=None):
    xn = nn.rmsnorm(lp.ln1, x, cfg.norm_eps)
    h, new_ssm, new_conv = ssd_lib.mamba_apply(
        lp.mamba, xn, cfg, ssm_state=ssm_state, conv_state=conv_state,
        pad_mask=pad_mask, last_valid=last_valid,
    )
    if hasattr(lp, "adapter") and slot_ids is not None:
        h = h + adapter_apply(lp.adapter, xn, slot_ids)
    return x + h, new_ssm, new_conv


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _ssm_stack(cfg, n, gen, device) -> tnn.ModuleList:
    return tnn.ModuleList(SSMLayer(cfg, gen, device) for _ in range(n))


class LM(tnn.Module):
    """The decoder LM's parameters, named as the reference's pytree."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator], device):
        super().__init__()
        dt = nn.cdtype(cfg)
        self.embed = nn.Embed(cfg, gen, device)
        if cfg.family in ("dense", "moe"):
            self.layers = tnn.ModuleList(
                DenseLayer(cfg, gen, device, moe=cfg.family == "moe")
                for _ in range(cfg.n_layers))
        elif cfg.family == "ssm":
            self.layers = _ssm_stack(cfg, cfg.n_layers, gen, device)
        elif cfg.family == "hybrid":
            n_groups = cfg.n_layers // cfg.attn_every
            trailing = cfg.n_layers - n_groups * cfg.attn_every
            self.groups = tnn.ModuleList(
                _ssm_stack(cfg, cfg.attn_every, gen, device) for _ in range(n_groups))
            if trailing:
                self.trailing = _ssm_stack(cfg, trailing, gen, device)
            self.shared_attn = DenseLayer(cfg, gen, device)  # ONE shared block
        else:
            raise ValueError(f"LM does not handle family {cfg.family!r}")

        self.final_norm = nn.RMSNorm(cfg.d_model, dt, device)
        self.head = nn.head_init(cfg, gen, device)
        if cfg.frontend == "patch":
            self.frontend_proj = nn.Weight((cfg.d_model, cfg.d_model), dt, gen, device)
        if cfg.bank_mode == "head":
            self.bank_head = nn.Weight(
                (cfg.bank_slots, cfg.d_model, cfg.padded_vocab), dt, gen, device)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype=None, *,
               device) -> dict:
    """Decode cache for a context of ``seq_len`` tokens."""
    quant = cfg.cache_dtype == "int8" and dtype is None
    dt = dtype or (torch.int8 if quant else nn.cdtype(cfg))
    lc = cfg.kv_cache_len(seq_len)
    g, hd = cfg.n_kv_heads, cfg.head_dim or 0

    def zeros(shape, t):
        return torch.zeros(shape, dtype=t, device=device)

    def kv(n_layers):
        c = {"k": zeros((n_layers, batch, g, lc, hd), dt),
             "v": zeros((n_layers, batch, g, lc, hd), dt)}
        if quant:
            c["k_scale"] = zeros((n_layers, batch, g, lc), nn.F32)
            c["v_scale"] = zeros((n_layers, batch, g, lc), nn.F32)
        return c

    def mamba_states(n, extra=()):
        di, h, nst, conv_dim = ssd_lib.ssm_dims(cfg)
        return {
            "ssm": zeros((*extra, n, batch, h, cfg.ssm_head_dim, nst), nn.F32),
            "conv": zeros((*extra, n, batch, cfg.ssm_conv_width - 1, conv_dim), dt),
        }

    if cfg.family in ("dense", "moe"):
        return kv(cfg.n_layers)
    if cfg.family == "ssm":
        return mamba_states(cfg.n_layers)
    if cfg.family == "hybrid":
        n_groups = cfg.n_layers // cfg.attn_every
        trailing = cfg.n_layers - n_groups * cfg.attn_every
        cache = {"groups": mamba_states(cfg.attn_every, extra=(n_groups,)),
                 "attn": kv(n_groups)}
        if trailing:
            cache["trailing"] = mamba_states(trailing)
        return cache
    raise ValueError(cfg.family)


def _layer_view(cache: dict, i: int) -> dict:
    """Layer ``i`` of a stacked cache: views, so writes land in the stack."""
    return {k: v[i] for k, v in cache.items()}


def stack_caches(per_layer: list[dict]) -> dict:
    """Per-layer cache dicts stacked into one, leaf by leaf."""
    return {k: torch.stack([c[k] for c in per_layer]) for k in per_layer[0]}


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

def _embed_inputs(params: LM, batch, cfg: ModelConfig):
    x = nn.embed_apply(params.embed, batch["tokens"])
    if cfg.frontend == "patch" and "patch_embeds" in batch:
        pe = batch["patch_embeds"].to(x.dtype) @ params.frontend_proj.w
        x = torch.cat([pe, x], dim=1)
    return x


def banked_logits(bank_head: nn.Weight, x, cfg: ModelConfig, slot_ids):
    """The banked head: each row's (d, V) slot of the bank, f32 logits."""
    w = bank_head.w[slot_ids]  # (B, d, V)
    return nn.mask_padded_vocab(torch.bmm(x.to(nn.F32), w.to(nn.F32)), cfg)


def _final_logits(params, x, cfg, slot_ids=None):
    x = nn.rmsnorm(params.final_norm, x, cfg.norm_eps)
    if cfg.bank_mode == "head" and slot_ids is not None and hasattr(params, "bank_head"):
        return banked_logits(params.bank_head, x, cfg, slot_ids)
    return nn.logits_apply(params.embed, params.head, x, cfg)


def _ssm_stack_apply(layers, x, cfg, *, slot_ids, pad_mask, last_valid):
    states = []
    for lp in layers:
        x, ssm, conv = _ssm_layer_apply(lp, x, cfg, slot_ids=slot_ids,
                                        pad_mask=pad_mask, last_valid=last_valid)
        states.append({"ssm": ssm, "conv": conv})
    return x, stack_caches(states)


def lm_apply(params: LM, batch, cfg: ModelConfig, *, return_cache: bool = False):
    """Full-sequence forward (train / prefill).

    batch: tokens (B, S) [+ patch_embeds (B, F, d)] [+ slot_ids (B,)]
    [+ pad_mask (B, S)].  Returns (logits (B, S_total, V), aux_loss) and
    optionally the cache holding the full-sequence keys/values and states.
    """
    slot_ids = batch.get("slot_ids")
    pad_mask = batch.get("pad_mask")  # (B, S): 1=real token, 0=right pad
    last_valid = pad_mask.sum(dim=1).long() if pad_mask is not None else None
    x = _embed_inputs(params, batch, cfg)
    bsz, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(bsz, s)
    moe_capacity = None
    if cfg.family == "moe":
        moe_capacity = int(
            cfg.moe_capacity_factor * bsz * s * cfg.experts_per_token / cfg.n_experts)
        moe_capacity = max(8, -(-moe_capacity // 8) * 8)

    aux_total = torch.zeros((), dtype=nn.F32, device=x.device)
    if cfg.family in ("dense", "moe"):
        kvs = []
        for lp in params.layers:
            x, kv, aux = _dense_layer_apply(
                lp, x, cfg, positions=positions, slot_ids=slot_ids,
                moe_capacity=moe_capacity, pad_mask=pad_mask)
            kvs.append(kv)
            aux_total = aux_total + aux
        caches = stack_caches(kvs)
    elif cfg.family == "ssm":
        x, caches = _ssm_stack_apply(params.layers, x, cfg, slot_ids=slot_ids,
                                     pad_mask=pad_mask, last_valid=last_valid)
    elif cfg.family == "hybrid":
        gstates, kvs = [], []
        for glp in params.groups:
            x, states = _ssm_stack_apply(glp, x, cfg, slot_ids=slot_ids,
                                         pad_mask=pad_mask, last_valid=last_valid)
            x, kv, _ = _dense_layer_apply(params.shared_attn, x, cfg,
                                          positions=positions, slot_ids=slot_ids)
            gstates.append(states)
            kvs.append(kv)
        caches = {"groups": stack_caches(gstates), "attn": stack_caches(kvs)}
        if hasattr(params, "trailing"):
            x, caches["trailing"] = _ssm_stack_apply(
                params.trailing, x, cfg, slot_ids=slot_ids,
                pad_mask=pad_mask, last_valid=last_valid)
    else:
        raise ValueError(cfg.family)

    logits = _final_logits(params, x, cfg, slot_ids)
    if return_cache:
        return logits, aux_total, caches
    return logits, aux_total


def _ssm_stack_decode(layers, x, cfg, cache, slot_ids):
    """One token through a stack of mamba layers, each layer's states
    written back in place into the stacked ``cache``."""
    for i, lp in enumerate(layers):
        x, ssm, conv = _ssm_layer_apply(lp, x, cfg, ssm_state=cache["ssm"][i],
                                        conv_state=cache["conv"][i], slot_ids=slot_ids)
        cache["ssm"][i] = ssm
        cache["conv"][i] = conv
    return x


def lm_decode_step(params: LM, tokens, cache, cache_len, cfg: ModelConfig,
                   slot_ids=None):
    """One decode step.  tokens: (B, 1); cache from ``init_cache``, written
    in place and returned; cache_len: a scalar or a (B,) tensor — the
    number of valid context tokens of each row.  Returns (logits (B, 1, V),
    cache)."""
    x = nn.embed_apply(params.embed, tokens)
    bsz = x.shape[0]
    positions = torch.as_tensor(cache_len, device=x.device).reshape(-1, 1).expand(bsz, 1)
    moe_capacity = None
    if cfg.family == "moe":
        # decode must never drop: worst case all rows route to one expert
        moe_capacity = max(8, -(-bsz // 8) * 8)

    if cfg.family in ("dense", "moe"):
        for i, lp in enumerate(params.layers):
            x, _, _ = _dense_layer_apply(
                lp, x, cfg, positions=positions, kv_cache=_layer_view(cache, i),
                cache_len=cache_len, slot_ids=slot_ids, moe_capacity=moe_capacity)
    elif cfg.family == "ssm":
        x = _ssm_stack_decode(params.layers, x, cfg, cache, slot_ids)
    elif cfg.family == "hybrid":
        for gi, glp in enumerate(params.groups):
            x = _ssm_stack_decode(glp, x, cfg, _layer_view(cache["groups"], gi), slot_ids)
            x, _, _ = _dense_layer_apply(
                params.shared_attn, x, cfg, positions=positions,
                kv_cache=_layer_view(cache["attn"], gi), cache_len=cache_len,
                slot_ids=slot_ids)
        if hasattr(params, "trailing"):
            x = _ssm_stack_decode(params.trailing, x, cfg, cache["trailing"], slot_ids)
    else:
        raise ValueError(cfg.family)

    return _final_logits(params, x, cfg, slot_ids), cache
