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

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention import decode_attention

F32 = torch.float32
NEG = torch.finfo(torch.float32).min


def cdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _whole_reshape(t, shape):
    try:
        return t.reshape(*shape)
    except RuntimeError:
        k = 0
        while k < min(t.ndim, len(shape)) and t.shape[k] == shape[k]:
            k += 1
        whole = [Replicate() if p.is_shard() and p.dim >= k else p
                 for p in t.placements]
        if whole == list(t.placements):
            raise
        return t.redistribute(t.device_mesh, whole).reshape(*shape)


class _DTensorReshape(torch.autograd.Function):
    """``_whole_reshape`` forward, and backward on the gradient."""

    @staticmethod
    def forward(ctx, t, shape):
        ctx.in_shape = tuple(t.shape)
        return _whole_reshape(t, shape)

    @staticmethod
    def backward(ctx, grad):
        return _whole_reshape(grad, ctx.in_shape), None


def reshape(t: torch.Tensor, *shape: int) -> torch.Tensor:
    """``t.reshape(*shape)``.  DTensor refuses to split or merge a sharded
    dim whose shard boundaries do not fall on the new dims' (smollm's 960
    q columns over 16 ranks are 60 each, which no 64-wide head holds), in
    the forward pass or in the gradient's: such a DTensor is first
    replicated on the dims after its unchanged leading ones.  The gather
    stays because no rank holds whole rows of the new dims; GSPMD reshards
    there too.  Even splits (32 heads of 128 over 16 ranks) stay sharded:
    DTensor reshapes them itself.  The mamba block (``nn.ssd``) and the
    attention (``_flash_shards``) pick their own layouts after it."""
    if not isinstance(t, DTensor):
        return t.reshape(*shape)
    return _DTensorReshape.apply(t, shape)


def reduce_pending(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's pending sums (``Partial``: a row-parallel product's
    output) all-reduced, as GSPMD reduces them before the residual add.
    Left pending, they would reach the next layer's products, where DTensor
    gathers the weight rather than reduce the activations, and every rank
    multiplies by the whole weight.  Other tensors as they are."""
    if not isinstance(t, DTensor) or not any(p.is_partial() for p in t.placements):
        return t
    return t.redistribute(t.device_mesh,
                          [Replicate() if p.is_partial() else p for p in t.placements])


def project(x: torch.Tensor, w: torch.Tensor, *, split_idle: bool = True) -> torch.Tensor:
    """``x @ w`` for a weight ``w``: (K, N), or (E, K, N) with ``x`` (E, C,
    K) (the experts' batched products).  Plain tensors multiply as they
    are.  DTensors multiply their local shards, laid out per mesh dim as
    GSPMD partitions the product (the reference's layout), with every
    gradient's placement stated, so that the backward pass's products are
    the local ones on every PyTorch release:

    * ``x``'s pending sums are reduced first;
    * ``w`` shards N (column-parallel): ``x``'s K made whole there; the
      output shards N, ``x``'s gradient is a partial sum;
    * ``w`` shards E: ``x`` takes its experts; the output shards E;
    * ``x`` shards a batch or token dim: ``w`` is gathered there (FSDP's
      ZeRO-3), its gradient a partial sum; the output keeps the shard;
    * ``w`` shards K (row-parallel; FSDP's d of the experts, whose tokens
      every rank holds whole), ``x`` shards K, or both hold a 2-D product
      whole on the "data" dim when it divides K (a decode batch of one
      leaves "data" idle; "model" holds a weight whose shards were dropped
      whole, as GSPMD does), or the "pod" dim of such a batch where ``x``'s
      features are scattered over a dim that ``w`` does not shard (the
      residual that such a product left): the contraction is split, each
      rank multiplying its
      K slices (local, no collective), and the partial products are
      all-reduced;
      ``split_idle=False`` keeps an idle dim's product whole (the
      vocabulary head: GSPMD keeps mamba2-130m's whole on the idle "data"
      dim of a decode batch of one), and so does a batched product (GSPMD
      keeps the experts' whole over "data" when serving);
    * otherwise the product is whole there."""
    if not isinstance(x, DTensor):
        return x @ w
    x = reduce_pending(x)
    mesh, last, batched = x.device_mesh, x.ndim - 1, w.ndim == 3
    k_dim = w.ndim - 2
    # a K shard on a dim where w shards columns (an adapter's output in the
    # residual) moves to an idle dim of that size, as GSPMD moves it
    moved = list(x.placements)
    for i, (a, b) in enumerate(zip(x.placements, w.placements)):
        if a.is_shard(last) and b.is_shard(w.ndim - 1):
            for j, (c, e) in enumerate(zip(moved, w.placements)):
                if c.is_replicate() and e.is_replicate() and mesh.size(j) == mesh.size(i):
                    moved[i], moved[j] = Replicate(), Shard(last)
                    break
    if moved != list(x.placements):
        x = x.redistribute(mesh, moved)
    # features scattered over a dim that w does not shard (a residual on a
    # decode batch of one, as GSPMD leaves it): the idle pods split such a
    # product's contraction further, as GSPMD splits it
    scatter = 1
    for a, b, n in zip(x.placements, w.placements, mesh.shape):
        scatter *= n if a.is_shard(last) and b.is_replicate() else 1
    xp, wp, out = list(x.placements), list(w.placements), []
    x_grad, w_grad, idle = [], [], []
    k_ways = 1
    for i, (a, b) in enumerate(zip(x.placements, w.placements)):
        n = mesh.size(i)
        if batched and b.is_shard(0):                     # experts
            xp[i], x_grad_i, w_grad_i, o = Shard(0), Shard(0), b, Shard(0)
        elif a.is_shard() and a.dim < last and not batched:   # batch, tokens
            wp[i], x_grad_i, w_grad_i, o = Replicate(), a, Partial(), a
        elif b.is_shard(w.ndim - 1):                       # columns
            xp[i], x_grad_i, w_grad_i, o = Replicate(), Partial(), b, Shard(last)
        elif b.is_shard(k_dim) or a.is_shard(last) or (
                split_idle and not batched and n > 1 and mesh.mesh_dim_names[i] == "data"
                and x.shape[-1] % (k_ways * n) == 0 and a.is_replicate()) or (
                scatter > 1 and not batched and n > 1 and mesh.mesh_dim_names[i] == "pod"
                and x.shape[-1] % (scatter * n) == 0 and a.is_replicate()):
            k_ways *= n                                    # contraction
            if not b.is_shard(k_dim):
                idle.append(i)
            xp[i], wp[i] = Shard(last), Shard(k_dim)
            x_grad_i, w_grad_i, o = Shard(last), Shard(k_dim), Partial()
        else:                                              # whole
            xp[i], wp[i], x_grad_i, w_grad_i, o = Replicate(), Replicate(), \
                Replicate(), Replicate(), Replicate()
        x_grad.append(x_grad_i), w_grad.append(w_grad_i), out.append(o)
    xl = x.redistribute(mesh, xp).to_local(grad_placements=x_grad)
    wl = w.redistribute(mesh, wp).to_local(grad_placements=w_grad)
    shape = (*x.shape[:-1], w.shape[-1])
    y = DTensor.from_local(xl @ wl, mesh, out, run_check=False, shape=torch.Size(shape),
                           stride=torch.empty(shape, device="meta").stride())
    ways = 1
    for i in idle:
        ways *= mesh.size(i)
    if idle and not any(o.is_shard(last) for o in out) and shape[-1] % ways == 0:
        # an output no dim shards by columns (a residual branch) leaves an
        # idle dim's sums scattered over its features, as GSPMD leaves them:
        # the next products split their contraction there again
        return y.redistribute(mesh, [Shard(last) if i in idle else
                                     (Replicate() if o.is_partial() else o)
                                     for i, o in enumerate(out)])
    return reduce_pending(y)


def whole_features(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's pending sums reduced and its last dim whole (the batch
    and token shards kept); other tensors as they are.  The head reads
    whole feature rows, so that its vocabulary stays sharded."""
    if not isinstance(x, DTensor):
        return x
    last = x.ndim - 1
    want = [Replicate() if p.is_partial() or p.is_shard(last) else p for p in x.placements]
    return x if want == list(x.placements) else x.redistribute(x.device_mesh, want)


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
    """q, k, v from inputs ``d_in`` wide (default ``d_model``), o back to
    ``d_model``."""

    def __init__(self, cfg: ModelConfig, gen, device, d_in: Optional[int] = None):
        super().__init__()
        d, hd, dt = cfg.d_model, cfg.head_dim, cdtype(cfg)
        d_in = d_in or d
        self.wq = _dense_init(gen, (d_in, cfg.n_heads * hd), dt, device)
        self.wk = _dense_init(gen, (d_in, cfg.n_kv_heads * hd), dt, device)
        self.wv = _dense_init(gen, (d_in, cfg.n_kv_heads * hd), dt, device)
        self.wo = _dense_init(gen, (cfg.n_heads * hd, d), dt, device,
                              scale=(cfg.n_heads * hd) ** -0.5)


def _group_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, G, gq, M, K) @ (B, G, 1, K, N) -> (B, G, gq, M, N).

    On DTensors it runs on each rank's shards: ``matmul`` flattens (B, G,
    gq), which DTensor refuses with G sharded (on some PyTorch releases).
    Per mesh dim: a batch or group shard is shared by both operands and
    kept; an N shard of ``b`` or an M or gq shard of ``a`` is kept with the
    other operand whole; a K shard becomes a pending sum where no gradient
    is needed, and is gathered where one is."""
    if not isinstance(a, DTensor):
        return torch.matmul(a, b)
    mesh = a.device_mesh
    a = a.redistribute(mesh, [Replicate() if p.is_partial() else p for p in a.placements])
    b = b.redistribute(mesh, [Replicate() if p.is_partial() else p for p in b.placements])
    pending = not (torch.is_grad_enabled() and (a.requires_grad or b.requires_grad))
    pa, pb, po = [], [], []
    for x, y in zip(a.placements, b.placements):
        if x.is_shard(0) or y.is_shard(0) or x.is_shard(1) or y.is_shard(1):
            d = 0 if x.is_shard(0) or y.is_shard(0) else 1
            pa.append(Shard(d)), pb.append(Shard(d)), po.append(Shard(d))
        elif y.is_shard(4):
            pa.append(Replicate()), pb.append(y), po.append(Shard(4))
        elif x.is_shard(3) or x.is_shard(2):
            pa.append(x), pb.append(Replicate()), po.append(x)
        elif pending and (x.is_shard(4) or y.is_shard(3)):
            pa.append(Shard(4)), pb.append(Shard(3)), po.append(Partial())
        else:
            pa.append(Replicate()), pb.append(Replicate()), po.append(Replicate())
    out = torch.matmul(a.redistribute(mesh, pa).to_local(), b.redistribute(mesh, pb).to_local())
    return DTensor.from_local(out, mesh, po, run_check=False)


def softmax_rows(scores: torch.Tensor) -> torch.Tensor:
    """``torch.softmax`` over the last dim.  A DTensor whose last dim is
    whole runs it on each rank's rows: DTensor's rule for the backward
    (``_softmax_backward_data``) fails with its heads sharded on some
    PyTorch releases."""
    if not isinstance(scores, DTensor) or any(
            p.is_shard(scores.ndim - 1) or p.is_partial() for p in scores.placements):
        return torch.softmax(scores, dim=-1)
    out = torch.softmax(scores.to_local(), dim=-1)
    return DTensor.from_local(out, scores.device_mesh, scores.placements, run_check=False,
                              shape=scores.shape, stride=scores.stride())


def _qk(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(B, G, gq, Sq, D) x (B, G, Sk, D) -> (B, G, gq, Sq, Sk) in f32."""
    return _group_matmul(q.to(F32), k.to(F32).transpose(-1, -2)[:, :, None])


def _pv(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, G, gq, Sq, Sk) x (B, G, Sk, D) -> (B, G, gq, Sq, D) in f32, the
    probabilities first cast to the values' dtype as the reference does."""
    return _group_matmul(p.to(v.dtype).to(F32), v.to(F32)[:, :, None])


def _tiling(heads: int, g: int, gq: int, sq: int, n: int):
    """How GSPMD tiles attention over a mesh dim of size ``n`` that splits
    neither the ``g`` kv groups nor the ``heads`` (``g`` x ``gq``): the
    heads ``gcd(heads, n)`` ways, whole groups or heads within one group,
    and the rest of the dim over the ``sq`` query tokens.  (head ways,
    token ways), or None where no such tiling exists."""
    hw = math.gcd(heads, n)
    hp = heads // hw
    if hw == 1 or (g % hw and gq % hp) or sq % (n // hw):
        return None
    return hw, n // hw


def _flash_shards(q, k, v, *, q_offset: int, q_block: int,
                  seq_shard_axis: Optional[str], tile: bool = False, **kw):
    """``_flash_body`` of DTensors, run on each rank's shards with no
    collective inside the block loops.  Per mesh dim: a dim sharding q's
    batch keeps it (k and v follow); ``seq_shard_axis`` shards q's tokens
    (k and v whole) for the attention only, which collapses the q-block
    loop to one block, and each rank's k and v gradients are its tokens'
    partial sums; a dim whose size divides the kv-head groups left shards
    them; a dim that divides the G x gq heads so that each rank's heads lie
    in one group shards the heads: each rank takes its heads of q and their
    group of k and v (gradients partial), and the output is (B, ways,
    G·gq / ways, Sq, D) sharded on dim 1, the heads in their order, as
    GSPMD shards the q heads.  With ``tile``, a dim that splits neither is
    tiled as GSPMD tiles it (``_tiling``: llava-next-34b's 56 heads in 8
    groups over 16 ranks, the groups 8 ways and the tokens 2), each rank
    taking its heads' tile of q's tokens (gradients partial), and the
    output gathered there, the projection after it reading whole heads.
    Any other dim holds q, k and v whole, as GSPMD keeps them
    (smollm-360m's 15 heads over 16 ranks share no factor)."""
    mesh = q.device_mesh
    bsz, g, gq, sq, d = q.shape
    heads = g * gq
    qp, kvp, head_dims = [], [], []
    b_ways = g_ways = h_ways = s_ways = 1
    head_rank = 0
    tile_dim = None
    offset = q_offset
    for i, (name, p) in enumerate(zip(mesh.mesh_dim_names, q.placements)):
        n = mesh.size(i)
        if p.is_shard(0) and bsz % (b_ways * n) == 0:
            b_ways *= n
            qp.append(Shard(0))
            kvp.append(Shard(0))
        elif name == seq_shard_axis and tile_dim is None and sq % (s_ways * n) == 0:
            s_ways *= n
            offset += mesh.get_local_rank(i) * (sq // s_ways)
            qp.append(Shard(3))
            kvp.append(Replicate())
        elif tile_dim is None and h_ways == 1 and g % (g_ways * n) == 0:
            g_ways *= n
            qp.append(Shard(1))
            kvp.append(Shard(1))
        elif (tile_dim is None and g_ways == 1 and heads % (h_ways * n) == 0
              and gq % (heads // (h_ways * n)) == 0):
            h_ways *= n
            head_rank = head_rank * n + mesh.get_local_rank(i)
            head_dims.append(i)
            qp.append(Shard(1))
            kvp.append(Replicate())
        elif (tile and n > 1 and tile_dim is None and g_ways == h_ways == s_ways == 1
              and _tiling(heads, g, gq, sq, n)):
            tile_dim = i
            head_dims.append(i)
            qp.append(Replicate())
            kvp.append(Replicate())
        else:
            qp.append(Replicate())
            kvp.append(Replicate())
    if s_ways > 1:
        q_block = sq // s_ways
    q_in = [Replicate() if i in head_dims else p for i, p in enumerate(qp)]
    q_grad = [Partial() if i in head_dims else p for i, p in enumerate(qp)]
    kv_grad = [Partial() if p.is_shard(3) or i in head_dims else r
               for i, (p, r) in enumerate(zip(qp, kvp))]
    ql = q.redistribute(mesh, q_in).to_local(grad_placements=q_grad)
    kl = k.redistribute(mesh, kvp).to_local(grad_placements=kv_grad)
    vl = v.redistribute(mesh, kvp).to_local(grad_placements=kv_grad)
    if h_ways > 1:
        hp = heads // h_ways
        grp, j = divmod(head_rank * hp, gq)
        ql, kl, vl = ql[:, grp:grp + 1, j:j + hp], kl[:, grp:grp + 1], vl[:, grp:grp + 1]
    if tile_dim is None:
        out = _flash_body(ql, kl, vl, q_offset=offset, q_block=q_block, **kw)
        out = DTensor.from_local(out, mesh, qp, run_check=False)
        if s_ways > 1:
            # the tokens are sharded for attention only: the projection after
            # it flattens (B, S), which DTensor refuses with S sharded
            out = out.redistribute(mesh, [Replicate() if p.is_shard(3) else p for p in qp])
        return out
    n = mesh.size(tile_dim)
    hw, tw = _tiling(heads, g, gq, sq, n)
    hp, st = heads // hw, sq // tw
    ht, tt = divmod(mesh.get_local_rank(tile_dim), tw)
    if g % hw == 0:                                   # whole groups
        gl = g // hw
        ql, kl, vl = ql[:, ht * gl:(ht + 1) * gl], kl[:, ht * gl:(ht + 1) * gl], \
            vl[:, ht * gl:(ht + 1) * gl]
    else:                                             # heads within one group
        grp, j = divmod(ht * hp, gq)
        ql, kl, vl = ql[:, grp:grp + 1, j:j + hp], kl[:, grp:grp + 1], vl[:, grp:grp + 1]
    out = _flash_body(ql[:, :, :, tt * st:(tt + 1) * st], kl, vl, q_offset=offset + tt * st,
                      q_block=math.gcd(q_block, st), **kw)
    shape = (bsz, n, hp, st, d)
    tiles = DTensor.from_local(out.reshape(out.shape[0], 1, hp, st, d), mesh,
                               [Shard(1) if i == tile_dim else p for i, p in enumerate(qp)],
                               run_check=False, shape=torch.Size(shape),
                               stride=torch.empty(shape, device="meta").stride())
    # gathered: each rank holds a tile of heads x tokens, which no placement
    # of the (B, S, G·gq·D) output that the projection reads describes
    whole = tiles.redistribute(mesh, qp)
    whole = reshape(whole, bsz, hw, tw, hp, st, d).permute(0, 1, 3, 2, 4, 5)
    return reshape(whole, bsz, g, gq, sq, d)


def _flash_body(q, k, v, *, causal: bool, window: Optional[int],
                q_offset: int, k_offset: int, q_block: int, k_block: int,
                remat: bool = False, seq_shard_axis: Optional[str] = None,
                tile: bool = False, scale: Optional[float] = None):
    """Online-softmax attention.

    q: (B, G, gq, Sq, D); k, v: (B, G, Skv, D).  Offsets give absolute
    positions.  Returns (B, G, gq, Sq, D) in q.dtype; on DTensors whose
    heads ``_flash_shards`` shards, the same heads in the same order as
    (B, ways, G·gq / ways, Sq, D).

    ``remat``: recompute each q block's kv loop in the backward pass instead
    of saving its per-iteration softmax residuals (flash-style backward).
    ``seq_shard_axis``: on DTensors, shard q's tokens over this mesh axis
    (``_flash_shards``) — recovers TP parallelism for archs whose head
    count does not divide the TP degree.  ``tile``: on DTensors, tile a
    mesh dim that splits neither the groups nor the heads as GSPMD does
    (``_flash_shards``).  Plain tensors have no mesh, and neither changes
    anything.  ``scale`` multiplies the scores (default D ** -0.5).
    """
    if isinstance(q, DTensor):
        return _flash_shards(q, k, v, causal=causal, window=window,
                             q_offset=q_offset, k_offset=k_offset, q_block=q_block,
                             k_block=k_block, remat=remat,
                             seq_shard_axis=seq_shard_axis, tile=tile, scale=scale)
    bsz, g, gq, sq, d = q.shape
    scale = d ** -0.5 if scale is None else scale
    dev = q.device

    def q_step(qs, k, v, iq):
        qpos = q_offset + iq * q_block + torch.arange(q_block, device=dev)
        m = torch.full((bsz, g, gq, q_block), NEG, dtype=F32, device=dev)
        l = torch.zeros((bsz, g, gq, q_block), dtype=F32, device=dev)
        acc = torch.zeros((bsz, g, gq, q_block, d), dtype=F32, device=dev)
        # blocks as views from one split: every block's ops have one shape
        for jk, (ks, vs) in enumerate(zip(k.split(k_block, dim=2),
                                          v.split(k_block, dim=2))):
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
        return out.to(q.dtype)

    if remat and torch.is_grad_enabled():
        step = functools.partial(checkpoint, q_step, use_reentrant=False)
    else:
        step = q_step
    blocks = [step(qs, k, v, iq) for iq, qs in enumerate(q.split(q_block, dim=3))]
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
    return _group_matmul(a.to(wide), b.to(wide)).to(torch.int32)


def _write_rows(cache: torch.Tensor, new: torch.Tensor, slot: torch.Tensor) -> None:
    """cache (B, G, L, ...) [b, :, slot[b]] = new[b, :, 0]: each row's
    write at its own position, in place (the counterpart of the reference's
    vmapped ``dynamic_update_slice``, whose start is clamped into range)."""
    slot = slot.clamp(0, cache.shape[2] - 1)
    if isinstance(cache, DTensor):
        # DTensor has no in-place index_put on a sharded cache: a masked
        # select keeps every shard local (and rewrites the whole cache)
        hit = torch.arange(cache.shape[2], device=cache.device)[None, :] == slot[:, None]
        hit = hit.reshape(cache.shape[0], 1, cache.shape[2], *([1] * (cache.ndim - 3)))
        cache.copy_(torch.where(hit, new.to(cache.dtype), cache))
        return
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, :, slot] = new[:, :, 0].to(cache.dtype)


def _decode_attention_int8(q, k, v, kv_cache, slot, valid, scale):
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
    scores_i = _int_dot(qq, ck.transpose(-1, -2)[:, :, None], q.shape[-1])
    scores = scores_i.to(F32) * qs[..., None] \
        * cks[:, :, None, None, :] * scale
    scores = torch.where(valid[:, None, None, None], scores, NEG)
    p = torch.softmax(scores, dim=-1)
    w = p * cvs[:, :, None, None, :]              # fold per-token v scale in
    wq, ws = _quantize_rows(w)
    out_i = _int_dot(wq, cv[:, :, None], ck.shape[2])
    out = out_i.to(F32) * ws[..., None]
    return out, kv_cache


def _idle_heads(probs, cv):
    """Decode attention's probabilities and values for the value product,
    and the mesh dims it splits the q heads over.  The "data" dim, when it
    holds both whole (a decode batch of one leaves it idle; the pods of a
    multi-pod mesh each keep their own, as GSPMD keeps them) and divides
    the G x gq q heads, splits them for the value product only, as GSPMD
    does (it repeats the scores on every "data" rank): the probabilities
    as (B, G·gq, 1, 1, L), each head with its group's values (B, G·gq, L,
    D), sharded on dim 1.  Otherwise (plain tensors, no such dim) both as
    they are and no dim."""
    if not isinstance(probs, DTensor):
        return probs, cv, []
    mesh = probs.device_mesh
    bsz, g, gq, s, length = probs.shape
    idle = []
    ways = 1  # the q heads' shards already: the groups' (dim 1) and gq's (dim 2)
    for i, a in enumerate(probs.placements):
        ways *= mesh.size(i) if a.is_shard(1) or a.is_shard(2) else 1
    for i, (a, b) in enumerate(zip(probs.placements, cv.placements)):
        n = mesh.size(i)
        if (a.is_replicate() and b.is_replicate() and n > 1 and mesh.mesh_dim_names[i] == "data"
                and (g * gq) % (ways * n) == 0):
            idle.append(i)
            ways *= n
    if not idle:
        return probs, cv, []

    def split(t):
        return t.redistribute(mesh, [Shard(1) if i in idle else p
                                     for i, p in enumerate(t.placements)])

    # (B, G, L, D) -> (B, G·gq, L, D), each head its group's rows
    heads = cv[:, :, None].expand(bsz, g, gq, *cv.shape[2:]).reshape(bsz, g * gq, *cv.shape[2:])
    return split(reshape(probs, bsz, g * gq, 1, s, length)), split(heads), idle


def _pick_block(s: int, target: int) -> int:
    b = min(target, s)
    while s % b:
        b //= 2
    return max(b, 1)


def attention_apply(p: Attention, x: torch.Tensor, cfg: ModelConfig, *,
                    positions: torch.Tensor, kv_cache: Optional[dict] = None,
                    cache_len=None, causal: bool = True,
                    q_block: int = 512, k_block: int = 1024,
                    scale: Optional[float] = None):
    """Self-attention over x: (B, S, d_in), the scores scaled by ``scale``
    (default head_dim ** -0.5).

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
    scale = hd ** -0.5 if scale is None else scale
    # under FSDP (q's weight sharded over its rows) the reference runs
    # attention on the whole batch on every FSDP rank with its heads tiled;
    # the port keeps its batch split there and tiles no heads (arctic-480b:
    # the same work per rank)
    tile = not (isinstance(p.wq, DTensor) and any(pl.is_shard(0) for pl in p.wq.placements))
    q = reshape(project(x, p.wq), bsz, s, hq, hd)
    k = reshape(project(x, p.wk), bsz, s, g, hd)
    v = reshape(project(x, p.wv), bsz, s, g, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    # (B, G, gq, S, D) / (B, G, S, D)
    q = reshape(q, bsz, s, g, gq, hd).permute(0, 2, 3, 1, 4)
    k = k.transpose(1, 2)
    v = v.transpose(1, 2)

    if kv_cache is None:
        out = _flash_body(
            q, k, v, causal=causal, window=cfg.sliding_window,
            q_offset=0, k_offset=0, q_block=_pick_block(s, q_block),
            k_block=_pick_block(s, k_block), remat=cfg.flash_remat,
            seq_shard_axis="model" if cfg.seq_shard_attention else None, tile=tile,
            scale=scale)
        new_cache = {"k": k, "v": v}
    else:
        ck, cv = kv_cache["k"], kv_cache["v"]
        lcache = ck.shape[2]
        cl = torch.as_tensor(cache_len, device=x.device).reshape(-1).expand(bsz).long()
        slot = cl % lcache if cfg.sliding_window is not None else cl

        def valid():
            kpos = torch.arange(lcache, device=x.device)
            if cfg.sliding_window is None:
                return kpos[None, :] <= cl[:, None]
            # ring buffer: everything resident is in-window
            return kpos[None, :] < torch.clamp(cl + 1, max=lcache)[:, None]

        if "k_scale" in kv_cache:
            out, new_cache = _decode_attention_int8(q, k, v, kv_cache, slot, valid(), scale)
        else:
            _write_rows(ck, k, slot)
            _write_rows(cv, v, slot)
            new_cache = kv_cache
            if not isinstance(ck, DTensor):
                # each row's valid positions in the cache's dtype (a kernel on the card)
                out = decode_attention(q, ck, cv, cl, scale, x.dtype)
            else:
                scores = _qk(q, ck) * scale
                scores = torch.where(valid()[:, None, None, None], scores, NEG)
                probs, vd, idle = _idle_heads(torch.softmax(scores, dim=-1), cv)
                out = _pv(probs, vd)
                if idle:
                    out = reshape(out.redistribute(out.device_mesh, [
                        Replicate() if i in idle else p for i, p in enumerate(out.placements)]),
                        bsz, g, gq, s, hd)
        out = out.to(x.dtype)

    out = reshape(out.permute(0, 3, 1, 2, 4), bsz, s, hq * hd)
    return project(out, p.wo), new_cache


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
    h = F.silu(project(x, p.wg).to(F32)).to(x.dtype)
    return project(h * project(x, p.wu), p.wd)


class GeluMLP(nn.Module):
    """The GELU-gated MLP: ``wgu`` (d, 2 d_ff) holds the gate's columns,
    then the up projection's; ``wd`` (d_ff, d)."""

    def __init__(self, cfg: ModelConfig, gen, device):
        super().__init__()
        d, f, dt = cfg.d_model, cfg.d_ff, cdtype(cfg)
        self.wgu = _dense_init(gen, (d, 2 * f), dt, device)
        self.wd = _dense_init(gen, (f, d), dt, device, scale=f ** -0.5)


def gelu_mlp_apply(p: GeluMLP, x: torch.Tensor, delta=None) -> torch.Tensor:
    """down(gelu(g) * u), [g, u] = x @ wgu (+ ``delta``, a low-rank term of
    the caller's)."""
    gu = project(x, p.wgu)
    if delta is not None:
        gu = gu + delta
    g, u = gu.chunk(2, dim=-1)
    return project(F.gelu(g.to(F32)).to(x.dtype) * u, p.wd)


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
    return take_rows(p.embedding, tokens)


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``.  With DTensor ids it runs on each rank's ids, out as
    the ids are placed: DTensor's own rules for the lookup (with ids
    sharded on two mesh dims) and for its backward (an ``index_put``) fail
    on some PyTorch releases.  Per mesh dim, the table is gathered where it
    shards its rows or the ids are sharded, and keeps a shard of a later
    dim (the banked head's vocabulary, an adapter's width), which the
    output then carries.  Each rank's table gradient is its ids' sum, a
    partial sum over the mesh dims that split the ids, which DTensor
    reduces."""
    if not isinstance(ids, DTensor):
        return table[ids]
    if not isinstance(table, DTensor):
        return DTensor.from_local(table[ids.to_local()], ids.device_mesh,
                                  list(ids.placements), run_check=False)
    mesh = ids.device_mesh
    keep, grad, out = [], [], []
    for ip, tp in zip(ids.placements, table.placements):
        if ip.is_shard():
            keep.append(Replicate()), grad.append(Partial()), out.append(ip)
        elif tp.is_shard() and tp.dim > 0:
            keep.append(tp), grad.append(tp), out.append(Shard(ids.ndim + tp.dim - 1))
        else:
            keep.append(Replicate()), grad.append(Replicate()), out.append(Replicate())
    local = table.redistribute(mesh, keep).to_local(grad_placements=grad)
    shape = (*ids.shape, *table.shape[1:])
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local[ids.to_local()], mesh, out, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def mask_padded_vocab(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    pad = torch.arange(cfg.padded_vocab, device=logits.device) >= cfg.vocab_size
    return torch.where(pad, NEG, logits)


def logits_apply(embed: Embed, head: Weight, x: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """Project to the (padded) vocab in f32; padded rows masked to f32's min.
    On DTensors the logits keep the table's vocabulary shards
    (``project``)."""
    if cfg.tie_embeddings:
        logits = project(x.to(F32), embed.embedding.to(F32).t(), split_idle=False)
    else:
        logits = project(x.to(F32), head.w.to(F32), split_idle=False)
    return mask_padded_vocab(logits, cfg)


def head_init(cfg: ModelConfig, gen, device) -> Weight:
    shape = None if cfg.tie_embeddings else (cfg.d_model, cfg.padded_vocab)
    return Weight(shape, cdtype(cfg), gen, device)
