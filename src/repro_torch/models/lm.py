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

The published Zamba2 (family ``zamba2``, ``configs.zamba2_7b_instruct``):
per layer i, ``x = x + mamba_i(norm_i(x + t_i))``, where ``t_i`` is zero
except at the hybrid sites; at site j (layer ``hybrid_layer_ids[j]``)
``t_i = linear_j(block_{j mod M}(x, e, j))``, e the token embeddings, M
the shared blocks.  A block: ``a = RMSNorm([x, e])``, attention over
``a`` (scale (head_dim / 2) ** -0.5), RMSNorm, then a GELU-gated MLP whose
gate_up adds site j's low-rank delta.  Its cache holds KV for the sites
(``kv``: ``(sites, B, G, Lc, hd)``) beside SSM and conv state for every
layer.

Caches keep the reference's leaf names and layouts, stacked over layers:
KV ``(L, B, G, Lc, hd)``, SSM state ``(..., n, B, H, P, N)``, conv state
``(..., n, B, W-1, C)``; decode writes them in place.  ``cache_layout``
states each leaf's batch and (KV) position axes, which ``alloc_cache``,
``write_cache_row`` and ``kv_positions`` read.  Every family's mamba
layers (and ``zamba2``'s sites) run in ``_ssm_stack_apply`` / ``_decode``.

``cfg.remat == "full"`` recomputes each layer (each hybrid group, and each
mamba layer inside it) in the backward pass through
``torch.utils.checkpoint``, as the reference's ``_maybe_remat`` does with
``jax.checkpoint``; it acts only where autograd records a graph, so serving
(under ``torch.inference_mode()``) never recomputes.  Training calls
``lm_apply`` without a cache: no in-place cache write runs in a graph that
needs gradients.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
from torch import nn as tnn
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import bank as bank_lib
from repro_torch.kernels.banked_matmul import banked_matmul
from repro_torch.nn import modules as nn
from repro_torch.nn import moe as moe_lib
from repro_torch.nn import ssd as ssd_lib
from repro_torch.spans import SpanRecorder

# The recorder of a step handed none: never started, so its spans are no-ops.
_NO_SPANS = SpanRecorder()


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
    down = nn.reduce_pending(torch.bmm(x, nn.take_rows(p.a, slot_ids)))
    return torch.bmm(down, nn.take_rows(p.b, slot_ids))


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


class SharedBlock(tnn.Module):
    """One of the published hybrid's shared blocks (family ``zamba2``):
    attention over [hidden, embeddings], then a GELU-gated MLP."""

    def __init__(self, cfg: ModelConfig, gen, device):
        super().__init__()
        dt = nn.cdtype(cfg)
        self.ln_attn = nn.RMSNorm(cfg.attn_width, dt, device)
        self.attn = nn.Attention(cfg, gen, device, d_in=cfg.attn_width)
        self.ln_mlp = nn.RMSNorm(cfg.d_model, dt, device)
        self.mlp = nn.GeluMLP(cfg, gen, device)


class Site(tnn.Module):
    """What a hybrid site holds of its own: the rank-r delta on its
    block's gate_up (``lora_a`` (d, r), ``lora_b`` (r, 2 d_ff)) and the
    linear that maps the block's output (``linear`` (d, d))."""

    def __init__(self, cfg: ModelConfig, gen, device):
        super().__init__()
        d, r, dt = cfg.d_model, cfg.shared_adapter_rank, nn.cdtype(cfg)
        self.lora_a = nn._dense_init(gen, (d, r), dt, device)
        self.lora_b = nn._const(0.0, (r, 2 * cfg.d_ff), dt, device)
        self.linear = nn._dense_init(gen, (d, d), dt, device)


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
    out = x + m
    if (cfg.seq_shard_activations and isinstance(out, DTensor) and out.ndim == 3
            and out.shape[1] % 16 == 0):
        # Megatron-SP: pin the residual's token dim to the TP axis
        mesh = out.device_mesh
        out = out.redistribute(mesh, [Shard(1) if n == "model" else Replicate()
                                      for n in mesh.mesh_dim_names])
    return out, new_kv, aux


def _ssm_layer_apply(lp: SSMLayer, x, cfg, *, ssm_state=None, conv_state=None,
                     slot_ids=None, pad_mask=None, last_valid=None, t=None):
    """``x + mamba(norm(x))``; ``t`` (a hybrid site's output) joins the
    mamba's input only: ``x + mamba(norm(x + t))``."""
    xn = nn.rmsnorm(lp.ln1, x if t is None else x + t, cfg.norm_eps)
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

def maybe_remat(fn, cfg: ModelConfig):
    """``fn``, or under ``cfg.remat == "full"`` with a graph being recorded,
    ``fn`` whose activations are recomputed in the backward pass instead
    of kept (the reference's ``_maybe_remat``)."""
    if cfg.remat == "full" and torch.is_grad_enabled():
        return functools.partial(checkpoint, fn, use_reentrant=False)
    return fn


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
        elif cfg.family == "zamba2":
            self.layers = _ssm_stack(cfg, cfg.n_layers, gen, device)
            self.blocks = tnn.ModuleList(
                SharedBlock(cfg, gen, device) for _ in range(cfg.num_mem_blocks))
            self.sites = tnn.ModuleList(
                Site(cfg, gen, device) for _ in cfg.hybrid_layer_ids)
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

class CacheLeaf(NamedTuple):
    """A decode cache's leaf: shape, dtype, batch axis, KV position axis."""
    shape: tuple
    dtype: torch.dtype
    row_axis: int
    pos_axis: Optional[int] = None


def cache_layout(cfg: ModelConfig, batch: int, seq_len: int, dtype=None) -> dict:
    """The decode cache's leaves (``CacheLeaf``) for a context of
    ``seq_len`` tokens, named as the reference's."""
    quant = cfg.cache_dtype == "int8" and dtype is None
    dt = dtype or (torch.int8 if quant else nn.cdtype(cfg))
    lc = cfg.kv_cache_len(seq_len)
    g, hd = cfg.n_kv_heads, cfg.head_dim or 0

    def kv(n_layers):
        leaf, scale = (CacheLeaf((n_layers, batch, g, lc, hd), dt, 1, 3),
                       CacheLeaf((n_layers, batch, g, lc), nn.F32, 1, 3))
        return dict(k=leaf, v=leaf, **(dict(k_scale=scale, v_scale=scale) if quant else {}))

    def mamba_states(n, extra=()):
        di, h, nst, conv_dim = ssd_lib.ssm_dims(cfg)
        row = len(extra) + 1
        return {
            "ssm": CacheLeaf((*extra, n, batch, h, cfg.ssm_head_dim, nst), nn.F32, row),
            "conv": CacheLeaf((*extra, n, batch, cfg.ssm_conv_width - 1, conv_dim), dt, row),
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
    if cfg.family == "zamba2":
        return dict(mamba_states(cfg.n_layers), kv=kv(len(cfg.hybrid_layer_ids)))
    raise ValueError(cfg.family)


def alloc_cache(layout, device) -> dict:
    """The decode cache ``layout`` states, zeroed."""
    if isinstance(layout, dict):
        return {k: alloc_cache(v, device) for k, v in layout.items()}
    return torch.zeros(layout.shape, dtype=layout.dtype, device=device)


def write_cache_row(layout, cache, row: int, row_cache) -> None:
    """The one-row ``row_cache`` written into batch row ``row`` of
    ``cache``: a KV leaf's first ``min(S, Lc)`` positions (the rest kept,
    as the reference's splice keeps it), any other leaf's row whole."""
    if isinstance(layout, dict):
        for k in cache:
            write_cache_row(layout[k], cache[k], row, row_cache[k])
        return
    if layout.pos_axis is not None:
        n = min(row_cache.shape[layout.pos_axis], cache.shape[layout.pos_axis])
        cache, row_cache = (t.narrow(layout.pos_axis, 0, n) for t in (cache, row_cache))
    cache.select(layout.row_axis, row).copy_(row_cache.select(layout.row_axis, 0))


def kv_positions(layout) -> int:
    """Positions a row of the first KV leaf holds (0: no KV)."""
    if isinstance(layout, dict):
        return next((n for n in map(kv_positions, layout.values()) if n), 0)
    return 0 if layout.pos_axis is None else layout.shape[layout.pos_axis]


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
        pe = nn.project(batch["patch_embeds"].to(x.dtype), params.frontend_proj.w)
        x = torch.cat([pe, x], dim=1)
    return x


# Rows a block of the grouped head: a slot's rows are padded to a multiple
# of it, and one CTA of the kernel takes one block (PERF.md, kernel table).
HEAD_BLOCK_B = 64


def group_head_rows(slots, num_slots: int):
    """The grouping of the head's rows by slot in blocks of ``HEAD_BLOCK_B``
    (``bank.group_by_slot_padded``) and the slot each block reads: the
    blocks past the last slot's rows hold padding only and take that slot,
    so that they read no other slot's weights."""
    g = bank_lib.group_by_slot_padded(slots, num_slots, HEAD_BLOCK_B)
    return g, torch.minimum(g.block_slots, slots.max().to(torch.int32))


def banked_logits(bank_head: nn.Weight, x, cfg: ModelConfig, slot_ids, spans=None):
    """The banked head: each row's (d, V) slot of the bank, f32 logits of
    bf16 (or f32) products summed in f32, as the reference's einsum.

    Where autograd records nothing, on plain tensors and a bf16 bank
    (serving), the rows are grouped by slot and ``banked_matmul`` reads each
    slot they use once, its f32 sums written as they are; under
    ``serve.decode.head`` (``spans``: a ``SpanRecorder``, or None) with the
    rows and the padding of their grouping.  Otherwise (training, a sharded
    or an f32 bank) each row's slot is gathered and multiplied in f32."""
    w = bank_head.w
    if torch.is_grad_enabled() or w.dtype != torch.bfloat16 or x.dtype != w.dtype \
            or any(isinstance(t, DTensor) for t in (w, x, slot_ids)):
        w = nn.take_rows(w, slot_ids)  # (B, d, V), V as the bank shards it
        x = nn.whole_features(x)
        return nn.mask_padded_vocab(torch.bmm(x.to(nn.F32), w.to(nn.F32)), cfg)
    bsz, t, d = x.shape
    spans = spans or _NO_SPANS
    with spans.span("serve.decode.head") as s:
        slots = slot_ids[:, None].expand(bsz, t).reshape(-1)
        g, block_slots = group_head_rows(slots, w.shape[0])
        if spans.on:
            s.count(rows=bsz * t, padded=g.b_pad - bsz * t)
        y = banked_matmul(bank_lib.scatter_padded(x.reshape(-1, d), g), w, None,
                          block_slots, block_b=HEAD_BLOCK_B, out_dtype=nn.F32,
                          tag="/head")
        return nn.mask_padded_vocab(bank_lib.gather_padded(y, g).reshape(bsz, t, -1), cfg)


def _final_logits(params, x, cfg, slot_ids=None, spans=None):
    x = nn.rmsnorm(params.final_norm, x, cfg.norm_eps)
    if cfg.bank_mode == "head" and slot_ids is not None and hasattr(params, "bank_head"):
        return banked_logits(params.bank_head, x, cfg, slot_ids, spans)
    return nn.logits_apply(params.embed, params.head, x, cfg)


def _site_apply(params: LM, j: int, x, e, cfg, *, positions, kv_cache=None,
                cache_len=None):
    """Hybrid site j (family ``zamba2``): block j mod M over [x, e] with
    site j's delta on its gate_up, then site j's linear.  Returns (its
    output, the block's KV: the prompt's, or ``kv_cache`` written)."""
    blk, site = params.blocks[j % len(params.blocks)], params.sites[j]
    a = nn.rmsnorm(blk.ln_attn, torch.cat([x, e], dim=-1), cfg.norm_eps)
    h, kv = nn.attention_apply(blk.attn, a, cfg, positions=positions, kv_cache=kv_cache,
                               cache_len=cache_len, scale=(cfg.head_dim / 2) ** -0.5)
    h = nn.rmsnorm(blk.ln_mlp, h, cfg.norm_eps)
    delta = nn.project(nn.project(h, site.lora_a), site.lora_b)
    return nn.project(nn.gelu_mlp_apply(blk.mlp, h, delta), site.linear), kv


def _sites(cfg: ModelConfig) -> dict:
    """Layer ``hybrid_layer_ids[j]`` -> site j (family ``zamba2``; none
    elsewhere)."""
    return {layer: j for j, layer in enumerate(getattr(cfg, "hybrid_layer_ids", ()))}


def _ssm_stack_apply(params: LM, layers, x, cfg, *, positions=None, slot_ids=None,
                     pad_mask=None, last_valid=None):
    """A stack of mamba layers over a full sequence: (x, its cache).  Before
    layer ``hybrid_layer_ids[j]`` (``zamba2``) site j's output over [x, e],
    e the stack's input, joins the layer's mamba input, and the site's KV
    goes into the cache as ``kv``."""
    sites, e, states, kvs = _sites(cfg), x, [], []
    for i, lp in enumerate(layers):
        t = None
        if i in sites:
            t, kv = _site_apply(params, sites[i], x, e, cfg, positions=positions)
            kvs.append(kv)
        x, ssm, conv = maybe_remat(_ssm_layer_apply, cfg)(
            lp, x, cfg, slot_ids=slot_ids, pad_mask=pad_mask, last_valid=last_valid, t=t)
        states.append({"ssm": ssm, "conv": conv})
    cache = stack_caches(states)
    if kvs:
        cache["kv"] = stack_caches(kvs)
    return x, cache


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
            x, kv, aux = maybe_remat(_dense_layer_apply, cfg)(
                lp, x, cfg, positions=positions, slot_ids=slot_ids,
                moe_capacity=moe_capacity, pad_mask=pad_mask)
            kvs.append(kv)
            aux_total = aux_total + aux
        caches = stack_caches(kvs) if return_cache else None
    elif cfg.family in ("ssm", "zamba2"):
        x, caches = _ssm_stack_apply(params, params.layers, x, cfg, positions=positions,
                                     slot_ids=slot_ids, pad_mask=pad_mask,
                                     last_valid=last_valid)
    elif cfg.family == "hybrid":
        def group(glp, x):
            x, states = _ssm_stack_apply(params, glp, x, cfg, slot_ids=slot_ids,
                                         pad_mask=pad_mask, last_valid=last_valid)
            x, kv, _ = _dense_layer_apply(params.shared_attn, x, cfg,
                                          positions=positions, slot_ids=slot_ids)
            return x, states, kv

        gstates, kvs = [], []
        for glp in params.groups:
            x, states, kv = maybe_remat(group, cfg)(glp, x)
            gstates.append(states)
            kvs.append(kv)
        caches = {"groups": stack_caches(gstates), "attn": stack_caches(kvs)}
        if hasattr(params, "trailing"):
            x, caches["trailing"] = _ssm_stack_apply(
                params, params.trailing, x, cfg, slot_ids=slot_ids,
                pad_mask=pad_mask, last_valid=last_valid)
    else:
        raise ValueError(cfg.family)

    logits = _final_logits(params, x, cfg, slot_ids)
    if return_cache:
        return logits, aux_total, caches
    return logits, aux_total


def _ssm_stack_decode(params: LM, layers, x, cfg, cache, *, positions=None,
                      cache_len=None, slot_ids=None, spans=_NO_SPANS):
    """One token through a stack of mamba layers, each layer's states and
    each site's KV (``cache["kv"][j]``) written back in place into the
    stacked ``cache``; each layer under ``serve.decode.mamba``, each site
    under ``serve.decode.shared`` (``spans``: a ``SpanRecorder``)."""
    sites, e = _sites(cfg), x
    for i, lp in enumerate(layers):
        t = None
        if i in sites:
            with spans.span("serve.decode.shared"):
                t, _ = _site_apply(params, sites[i], x, e, cfg, positions=positions,
                                   kv_cache=_layer_view(cache["kv"], sites[i]),
                                   cache_len=cache_len)
        with spans.span("serve.decode.mamba"):
            x, ssm, conv = _ssm_layer_apply(lp, x, cfg, ssm_state=cache["ssm"][i],
                                            conv_state=cache["conv"][i],
                                            slot_ids=slot_ids, t=t)
            cache["ssm"][i] = ssm
            cache["conv"][i] = conv
    return x


def lm_decode_step(params: LM, tokens, cache, cache_len, cfg: ModelConfig,
                   slot_ids=None, spans=None):
    """One decode step.  tokens: (B, 1); cache from ``api.init_cache``, written
    in place and returned; cache_len: a scalar or a (B,) tensor — the
    number of valid context tokens of each row.  ``spans``: a
    ``SpanRecorder`` for the mamba layers' and sites' spans and the banked
    head's (None: none recorded).  Returns (logits (B, 1, V), cache)."""
    spans = spans or _NO_SPANS
    x = nn.embed_apply(params.embed, tokens)
    bsz = x.shape[0]
    positions = None
    if cfg.family != "ssm":  # the mamba layers read no position
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
    elif cfg.family in ("ssm", "zamba2"):
        x = _ssm_stack_decode(params, params.layers, x, cfg, cache, positions=positions,
                              cache_len=cache_len, slot_ids=slot_ids, spans=spans)
    elif cfg.family == "hybrid":
        for gi, glp in enumerate(params.groups):
            x = _ssm_stack_decode(params, glp, x, cfg, _layer_view(cache["groups"], gi),
                                  slot_ids=slot_ids, spans=spans)
            x, _, _ = _dense_layer_apply(
                params.shared_attn, x, cfg, positions=positions,
                kv_cache=_layer_view(cache["attn"], gi), cache_len=cache_len,
                slot_ids=slot_ids)
        if hasattr(params, "trailing"):
            x = _ssm_stack_decode(params, params.trailing, x, cfg, cache["trailing"],
                                  slot_ids=slot_ids, spans=spans)
    else:
        raise ValueError(cfg.family)

    return _final_logits(params, x, cfg, slot_ids, spans), cache
