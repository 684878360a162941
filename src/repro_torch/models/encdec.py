"""Encoder-decoder backbone (seamless-m4t-medium).

The audio frontend is a STUB: the encoder consumes precomputed frame
embeddings (B, S_enc, d).  Decoder layers carry causal self-attention plus
cross-attention into the encoder memory; at decode time the per-layer
cross K/V are computed once (prefill) and read-only.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn as tnn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.lm import banked_logits, stack_caches
from repro_torch.nn import modules as nn


def _cross_attention_apply(p: nn.Attention, x, memory_kv, cfg: ModelConfig):
    """x: (B, Sq, d); memory_kv: precomputed {"k","v"}: (B, G, Sm, D)."""
    bsz, sq, _ = x.shape
    hq, g, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    gq = hq // g
    q = (x @ p.wq).reshape(bsz, sq, g, gq, hd).permute(0, 2, 3, 1, 4)
    scores = nn._qk(q, memory_kv["k"]) * (hd ** -0.5)
    out = nn._pv(torch.softmax(scores, dim=-1), memory_kv["v"]).to(x.dtype)
    out = out.permute(0, 3, 1, 2, 4).reshape(bsz, sq, hq * hd)
    return out @ p.wo


def cross_kv(p: nn.Attention, memory, cfg: ModelConfig) -> dict:
    """Precompute cross-attention K/V from encoder memory: (B, Sm, d)."""
    bsz, sm, _ = memory.shape
    g, hd = cfg.n_kv_heads, cfg.head_dim
    k = (memory @ p.wk).reshape(bsz, sm, g, hd).transpose(1, 2)
    v = (memory @ p.wv).reshape(bsz, sm, g, hd).transpose(1, 2)
    return {"k": k, "v": v}


class EncLayer(tnn.Module):
    def __init__(self, cfg: ModelConfig, gen, device):
        super().__init__()
        dt = nn.cdtype(cfg)
        self.ln1 = nn.RMSNorm(cfg.d_model, dt, device)
        self.attn = nn.Attention(cfg, gen, device)
        self.ln2 = nn.RMSNorm(cfg.d_model, dt, device)
        self.mlp = nn.MLP(cfg, gen, device)


class DecLayer(tnn.Module):
    def __init__(self, cfg: ModelConfig, gen, device):
        super().__init__()
        dt = nn.cdtype(cfg)
        self.ln1 = nn.RMSNorm(cfg.d_model, dt, device)
        self.self_attn = nn.Attention(cfg, gen, device)
        self.ln2 = nn.RMSNorm(cfg.d_model, dt, device)
        self.cross_attn = nn.Attention(cfg, gen, device)  # same shapes; no RoPE
        self.ln3 = nn.RMSNorm(cfg.d_model, dt, device)
        self.mlp = nn.MLP(cfg, gen, device)


class EncDec(tnn.Module):
    """The encoder-decoder's parameters, named as the reference's pytree."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator], device):
        super().__init__()
        dt = nn.cdtype(cfg)
        self.frame_proj = nn.Weight((cfg.d_model, cfg.d_model), dt, gen, device)
        self.enc_layers = tnn.ModuleList(
            EncLayer(cfg, gen, device) for _ in range(cfg.n_enc_layers))
        self.enc_norm = nn.RMSNorm(cfg.d_model, dt, device)
        self.embed = nn.Embed(cfg, gen, device)
        self.dec_layers = tnn.ModuleList(
            DecLayer(cfg, gen, device) for _ in range(cfg.n_dec_layers))
        self.final_norm = nn.RMSNorm(cfg.d_model, dt, device)
        self.head = nn.head_init(cfg, gen, device)
        if cfg.bank_mode == "head":
            self.bank_head = nn.Weight(
                (cfg.bank_slots, cfg.d_model, cfg.padded_vocab), dt, gen, device)


def encode(params: EncDec, frames, cfg: ModelConfig):
    """frames: (B, S_enc, d) stub frame embeddings -> encoder memory."""
    x = frames.to(nn.cdtype(cfg)) @ params.frame_proj.w
    bsz, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(bsz, s)
    for lp in params.enc_layers:
        h, _ = nn.attention_apply(
            lp.attn, nn.rmsnorm(lp.ln1, x, cfg.norm_eps), cfg,
            positions=positions, causal=False)
        x = x + h
        x = x + nn.mlp_apply(lp.mlp, nn.rmsnorm(lp.ln2, x, cfg.norm_eps))
    return nn.rmsnorm(params.enc_norm, x, cfg.norm_eps)


def _final_logits(params, x, cfg, slot_ids=None):
    x = nn.rmsnorm(params.final_norm, x, cfg.norm_eps)
    if cfg.bank_mode == "head" and slot_ids is not None and hasattr(params, "bank_head"):
        return banked_logits(params.bank_head, x, cfg, slot_ids)
    return nn.logits_apply(params.embed, params.head, x, cfg)


def encdec_apply(params: EncDec, batch, cfg: ModelConfig, *, return_cache=False):
    """Training / prefill forward.

    batch: frames (B, S_enc, d), tokens (B, S_dec) [+ slot_ids].
    Returns (decoder logits, aux=0) [+ cache {self, cross}].
    """
    if "frames" not in batch:
        # the reference fails here too (KeyError), e.g. behind ServeEngine,
        # whose prefill feeds tokens only
        raise KeyError("frames: the encoder-decoder needs batch['frames'] "
                       "(B, S_enc, d_model), the stub frontend's frame embeddings")
    slot_ids = batch.get("slot_ids")
    memory = encode(params, batch["frames"], cfg)
    x = nn.embed_apply(params.embed, batch["tokens"])
    bsz, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(bsz, s)

    kvs, ckvs = [], []
    for lp in params.dec_layers:
        h, kv = nn.attention_apply(
            lp.self_attn, nn.rmsnorm(lp.ln1, x, cfg.norm_eps), cfg, positions=positions)
        x = x + h
        ckv = cross_kv(lp.cross_attn, memory, cfg)
        x = x + _cross_attention_apply(
            lp.cross_attn, nn.rmsnorm(lp.ln2, x, cfg.norm_eps), ckv, cfg)
        x = x + nn.mlp_apply(lp.mlp, nn.rmsnorm(lp.ln3, x, cfg.norm_eps))
        kvs.append(kv)
        ckvs.append(ckv)
    logits = _final_logits(params, x, cfg, slot_ids)
    aux = torch.zeros((), dtype=nn.F32, device=x.device)
    if return_cache:
        return logits, aux, {"self": stack_caches(kvs), "cross": stack_caches(ckvs)}
    return logits, aux


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype=None, *,
               device) -> dict:
    """Decoder cache: self-attn cache of seq_len + cross K/V of cross_len."""
    dt = dtype or nn.cdtype(cfg)
    g, hd = cfg.n_kv_heads, cfg.head_dim

    def zeros(length):
        return torch.zeros((cfg.n_dec_layers, batch, g, length, hd), dtype=dt,
                           device=device)

    return {"self": {"k": zeros(seq_len), "v": zeros(seq_len)},
            "cross": {"k": zeros(cfg.cross_len), "v": zeros(cfg.cross_len)}}


def encdec_decode_step(params: EncDec, tokens, cache, cache_len, cfg: ModelConfig,
                       slot_ids=None):
    """One decoder step against resident self/cross caches (the self cache
    written in place)."""
    x = nn.embed_apply(params.embed, tokens)
    bsz = x.shape[0]
    positions = torch.as_tensor(cache_len, device=x.device).reshape(-1, 1).expand(bsz, 1)
    for i, lp in enumerate(params.dec_layers):
        h, _ = nn.attention_apply(
            lp.self_attn, nn.rmsnorm(lp.ln1, x, cfg.norm_eps), cfg,
            positions=positions, cache_len=cache_len,
            kv_cache={k: v[i] for k, v in cache["self"].items()})
        x = x + h
        ckv = {k: v[i] for k, v in cache["cross"].items()}
        x = x + _cross_attention_apply(
            lp.cross_attn, nn.rmsnorm(lp.ln2, x, cfg.norm_eps), ckv, cfg)
        x = x + nn.mlp_apply(lp.mlp, nn.rmsnorm(lp.ln3, x, cfg.norm_eps))
    return _final_logits(params, x, cfg, slot_ids), cache
