"""NN building blocks: parameter containers and plain functions on tensors.

Conventions
-----------
* every block is an ``nn.Module`` that only holds parameters, named as the
  JAX reference's dict keys (``wq``, ``wk``, ``wv``, ``wo``, ``scale``,
  ``wg``, ``wu``, ``wd``, ``embedding``, ``w``), and a plain function
  ``*_apply(module, x, ...)`` computes with them, so the reference's param
  pytree maps onto the module tree key for key (``models.api``),
* a block built with a ``torch.Generator`` draws its weights from it; built
  with ``gen=None`` its tensors are left empty, to be loaded,
* weights live in ``cfg.dtype``; norms, softmax and every product the
  reference asks in f32 (``preferred_element_type=jnp.float32``) run in
  f32: the bf16 operands are upcast, which leaves each product exact and
  accumulates in f32,
* attention is the reference's flash formulation (q-block loop with online
  softmax over a kv-block loop), not ``scaled_dot_product_attention``:
  parity is held against that formulation.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig

F32 = torch.float32
NEG = torch.finfo(torch.float32).min


def cdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

def _dense_init(gen: Optional[torch.Generator], shape, dtype, device,
                scale: float | None = None) -> nn.Parameter:
    """N(0, 1) * scale (default fan_in ** -0.5) drawn in f32 from ``gen``
    on the generator's device; empty when ``gen`` is None."""
    if gen is None:
        return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else fan_in ** -0.5
    x = torch.randn(shape, generator=gen, dtype=F32, device=gen.device) * scale
    return nn.Parameter(x.to(device=device, dtype=dtype))


def _const(value: float, shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.full(shape, value, dtype=dtype, device=device))


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

class RMSNorm(nn.Module):
    def __init__(self, dim: int, dtype, device):
        super().__init__()
        self.scale = _const(1.0, (dim,), dtype, device)


def rmsnorm(p: RMSNorm, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(F32)
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p.scale.to(F32)).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S).  Halves, not
    interleaved pairs, rotate together."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=F32, device=x.device) / half)
    angles = positions[..., :, None].to(F32) * freqs        # (..., S, half)
    sin = torch.sin(angles)[..., :, None, :]
    cos = torch.cos(angles)[..., :, None, :]
    xf1, xf2 = x[..., :half].to(F32), x[..., half:].to(F32)
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA, optional sliding window) — flash formulation
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, gen, device):
        super().__init__()
        d, hd, dt = cfg.d_model, cfg.head_dim, cdtype(cfg)
        self.wq = _dense_init(gen, (d, cfg.n_heads * hd), dt, device)
        self.wk = _dense_init(gen, (d, cfg.n_kv_heads * hd), dt, device)
        self.wv = _dense_init(gen, (d, cfg.n_kv_heads * hd), dt, device)
        self.wo = _dense_init(gen, (cfg.n_heads * hd, d), dt, device,
                              scale=(cfg.n_heads * hd) ** -0.5)


def _qk(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(B, G, gq, Sq, D) x (B, G, Sk, D) -> (B, G, gq, Sq, Sk) in f32."""
    return torch.matmul(q.to(F32), k.to(F32).transpose(-1, -2)[:, :, None])


def _pv(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, G, gq, Sq, Sk) x (B, G, Sk, D) -> (B, G, gq, Sq, D) in f32, the
    probabilities first cast to the values' dtype as the reference does."""
    return torch.matmul(p.to(v.dtype).to(F32), v.to(F32)[:, :, None])


def _flash_body(q, k, v, *, causal: bool, window: Optional[int],
                q_offset: int, k_offset: int, q_block: int, k_block: int):
    """Online-softmax attention.

    q: (B, G, gq, Sq, D); k, v: (B, G, Skv, D).  Offsets give absolute
    positions.  Returns (B, G, gq, Sq, D) in q.dtype.
    """
    bsz, g, gq, sq, d = q.shape
    skv = k.shape[2]
    scale = d ** -0.5
    dev = q.device
    blocks = []
    for iq in range(sq // q_block):
        qs = q[:, :, :, iq * q_block:(iq + 1) * q_block]
        qpos = q_offset + iq * q_block + torch.arange(q_block, device=dev)
        m = torch.full((bsz, g, gq, q_block), NEG, dtype=F32, device=dev)
        l = torch.zeros((bsz, g, gq, q_block), dtype=F32, device=dev)
        acc = torch.zeros((bsz, g, gq, q_block, d), dtype=F32, device=dev)
        for jk in range(skv // k_block):
            ks = k[:, :, jk * k_block:(jk + 1) * k_block]
            vs = v[:, :, jk * k_block:(jk + 1) * k_block]
            kpos = k_offset + jk * k_block + torch.arange(k_block, device=dev)
            s = _qk(qs, ks) * scale
            mask = torch.ones((q_block, k_block), dtype=torch.bool, device=dev)
            if causal:
                mask &= kpos[None, :] <= qpos[:, None]
            if window is not None:
                mask &= qpos[:, None] - kpos[None, :] < window
            s = torch.where(mask, s, NEG)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + _pv(p, vs)
            m = m_new
        out = acc / torch.clamp(l, min=1e-37)[..., None]
        blocks.append(out.to(q.dtype))
    return torch.cat(blocks, dim=3)


def _quantize_rows(x: torch.Tensor):
    """Symmetric int8 quantization with a per-row scale over the last axis
    (``torch.round`` rounds half to even, as ``jnp.round`` does)."""
    xf = x.to(F32)
    scale = xf.abs().amax(dim=-1) / 127.0
    q = torch.clamp(torch.round(xf / torch.clamp(scale, min=1e-8)[..., None]),
                    -127, 127).to(torch.int8)
    return q, scale


def _int_dot(a: torch.Tensor, b: torch.Tensor, n: int) -> torch.Tensor:
    """The integer dot products of int8 ``a @ b`` over ``n`` terms, exact,
    as int32.  CUDA has no int8 batched ``matmul``: every partial sum is an
    integer of magnitude at most n * 127**2, exact in f32 while that stays
    under 2**24 (the QK product over the head dimension, and PV over a
    cache of up to 1040 positions) and exact in f64 beyond it."""
    wide = F32 if n * 127 * 127 < 2 ** 24 else torch.float64
    return torch.matmul(a.to(wide), b.to(wide)).to(torch.int32)


def _write_rows(cache: torch.Tensor, new: torch.Tensor, slot: torch.Tensor) -> None:
    """cache (B, G, L, ...) [b, :, slot[b]] = new[b, :, 0]: each row's
    write at its own position, in place (the counterpart of the reference's
    vmapped ``dynamic_update_slice``, whose start is clamped into range)."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, :, slot.clamp(0, cache.shape[2] - 1)] = new[:, :, 0].to(cache.dtype)


def _decode_attention_int8(q, k, v, kv_cache, slot, valid, hd):
    """Single-token attention over an int8-quantized KV cache.

    Cache: k/v int8 (B, G, L, D) + k_scale/v_scale f32 (B, G, L).  Both
    contractions are exact integer dots (``_int_dot``); the per-position v
    scale is folded into the probabilities before they are requantized.
    """
    kq_new, ks_new = _quantize_rows(k)            # (B,G,1,D)i8, (B,G,1)f32
    vq_new, vs_new = _quantize_rows(v)
    ck, cv = kv_cache["k"], kv_cache["v"]
    cks, cvs = kv_cache["k_scale"], kv_cache["v_scale"]
    _write_rows(ck, kq_new, slot)
    _write_rows(cv, vq_new, slot)
    _write_rows(cks, ks_new, slot)
    _write_rows(cvs, vs_new, slot)

    qq, qs = _quantize_rows(q)                    # (B,G,gq,1,D)i8, (B,G,gq,1)
    scores_i = _int_dot(qq, ck.transpose(-1, -2)[:, :, None], hd)
    scores = scores_i.to(F32) * qs[..., None] \
        * cks[:, :, None, None, :] * (hd ** -0.5)
    scores = torch.where(valid[:, None, None, None], scores, NEG)
    p = torch.softmax(scores, dim=-1)
    w = p * cvs[:, :, None, None, :]              # fold per-token v scale in
    wq, ws = _quantize_rows(w)
    out_i = _int_dot(wq, cv[:, :, None], ck.shape[2])
    out = out_i.to(F32) * ws[..., None]
    return out, kv_cache


def _pick_block(s: int, target: int) -> int:
    b = min(target, s)
    while s % b:
        b //= 2
    return max(b, 1)


def attention_apply(p: Attention, x: torch.Tensor, cfg: ModelConfig, *,
                    positions: torch.Tensor, kv_cache: Optional[dict] = None,
                    cache_len=None, causal: bool = True,
                    q_block: int = 512, k_block: int = 1024):
    """Self-attention over x: (B, S, d).

    Training / prefill: ``kv_cache is None`` -> flash over the sequence;
    returns (out, new_kv) where new_kv holds the full k/v (prefill cache).
    Decode: ``kv_cache = {"k","v"}`` (B, G, L, D) with ``cache_len`` (a
    scalar or a (B,) tensor) tokens valid per row -> writes each row's new
    token at its ``cache_len`` in place and attends over the cache; the
    returned cache is ``kv_cache`` itself.
    """
    bsz, s, _ = x.shape
    hq, g, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    gq = hq // g
    q = (x @ p.wq).reshape(bsz, s, hq, hd)
    k = (x @ p.wk).reshape(bsz, s, g, hd)
    v = (x @ p.wv).reshape(bsz, s, g, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    # (B, G, gq, S, D) / (B, G, S, D)
    q = q.reshape(bsz, s, g, gq, hd).permute(0, 2, 3, 1, 4)
    k = k.transpose(1, 2)
    v = v.transpose(1, 2)

    if kv_cache is None:
        out = _flash_body(
            q, k, v, causal=causal, window=cfg.sliding_window,
            q_offset=0, k_offset=0, q_block=_pick_block(s, q_block),
            k_block=_pick_block(s, k_block))
        new_cache = {"k": k, "v": v}
    else:
        lcache = kv_cache["k"].shape[2]
        cl = torch.as_tensor(cache_len, device=x.device).reshape(-1).expand(bsz).long()
        slot = cl % lcache if cfg.sliding_window is not None else cl
        kpos = torch.arange(lcache, device=x.device)
        if cfg.sliding_window is None:
            valid = kpos[None, :] <= cl[:, None]
        else:  # ring buffer: everything resident is in-window
            valid = kpos[None, :] < torch.clamp(cl + 1, max=lcache)[:, None]

        if "k_scale" in kv_cache:
            out, new_cache = _decode_attention_int8(q, k, v, kv_cache, slot, valid, hd)
        else:
            ck, cv = kv_cache["k"], kv_cache["v"]
            _write_rows(ck, k, slot)
            _write_rows(cv, v, slot)
            scores = _qk(q, ck) * (hd ** -0.5)
            scores = torch.where(valid[:, None, None, None], scores, NEG)
            out = _pv(torch.softmax(scores, dim=-1), cv)
            new_cache = kv_cache
        out = out.to(x.dtype)

    out = out.permute(0, 3, 1, 2, 4).reshape(bsz, s, hq * hd)
    return out @ p.wo, new_cache


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, gen, device, d_ff: Optional[int] = None):
        super().__init__()
        d, f, dt = cfg.d_model, d_ff or cfg.d_ff, cdtype(cfg)
        self.wg = _dense_init(gen, (d, f), dt, device)
        self.wu = _dense_init(gen, (d, f), dt, device)
        self.wd = _dense_init(gen, (f, d), dt, device, scale=f ** -0.5)


def mlp_apply(p: MLP, x: torch.Tensor) -> torch.Tensor:
    h = F.silu((x @ p.wg).to(F32)).to(x.dtype)
    return (h * (x @ p.wu)) @ p.wd


# ---------------------------------------------------------------------------
# embeddings / head
# ---------------------------------------------------------------------------

class Embed(nn.Module):
    def __init__(self, cfg: ModelConfig, gen, device):
        super().__init__()
        self.embedding = _dense_init(gen, (cfg.padded_vocab, cfg.d_model),
                                     cdtype(cfg), device, scale=1.0)
        # zero the padded rows so they never contribute
        if gen is not None and cfg.padded_vocab != cfg.vocab_size:
            with torch.no_grad():
                self.embedding[cfg.vocab_size:] = 0


class Weight(nn.Module):
    """One matrix ``w`` (the untied head, a projection, the banked head);
    with ``shape=None`` no parameter at all (the tied head: ``{}``)."""

    def __init__(self, shape, dtype, gen, device):
        super().__init__()
        if shape is not None:
            self.w = _dense_init(gen, shape, dtype, device)


def embed_apply(p: Embed, tokens: torch.Tensor) -> torch.Tensor:
    return p.embedding[tokens]


def mask_padded_vocab(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    pad = torch.arange(cfg.padded_vocab, device=logits.device) >= cfg.vocab_size
    return torch.where(pad, NEG, logits)


def logits_apply(embed: Embed, head: Weight, x: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """Project to the (padded) vocab in f32; padded rows masked to f32's min."""
    if cfg.tie_embeddings:
        logits = x.to(F32) @ embed.embedding.to(F32).t()
    else:
        logits = x.to(F32) @ head.w.to(F32)
    return mask_padded_vocab(logits, cfg)


def head_init(cfg: ModelConfig, gen, device) -> Weight:
    shape = None if cfg.tie_embeddings else (cfg.d_model, cfg.padded_vocab)
    return Weight(shape, cdtype(cfg), gen, device)
