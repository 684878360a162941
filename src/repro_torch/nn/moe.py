"""Mixture-of-Experts layer with sort-based capacity dispatch.

Structurally this is BoundSwitch's grouped slot selection at *token*
granularity: the router computes the slot (expert) ids, tokens are grouped
so each expert processes a contiguous capacity block, and the expert
weights — a resident bank stacked (E, ...) — are indexed, never moved.
Overflow beyond an expert's capacity drops, as is standard for
capacity-factor MoE.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.configs.base import ModelConfig
from repro_torch.nn.modules import F32, _dense_init, cdtype, project, reshape


class MoE(nn.Module):
    def __init__(self, cfg: ModelConfig, gen, device):
        super().__init__()
        d, f, e, dt = cfg.d_model, cfg.d_ff, cfg.n_experts, cdtype(cfg)
        self.router = _dense_init(gen, (d, e), F32, device)
        self.wg = _dense_init(gen, (e, d, f), dt, device)
        self.wu = _dense_init(gen, (e, d, f), dt, device)
        self.wd = _dense_init(gen, (e, f, d), dt, device, scale=f ** -0.5)


@dataclasses.dataclass
class Dispatch:
    dest: torch.Tensor     # (T*k,) destination row in the (E*C) buffer
    token: torch.Tensor    # (T*k,) source token index
    weight: torch.Tensor   # (T*k,) combine weight (0 for dropped)
    capacity: int


def _bincount(ids: torch.Tensor, n: int) -> torch.Tensor:
    """``torch.bincount(ids, minlength=n)`` for ids below ``n``, as a
    scatter-add (which meta tensors run; bincount has no meta kernel)."""
    return torch.zeros(n, dtype=torch.long, device=ids.device).scatter_add_(
        0, ids.long(), torch.ones_like(ids, dtype=torch.long))


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor replicated on every mesh dim; a plain tensor as it is."""
    if isinstance(t, DTensor):
        return t.redistribute(t.device_mesh, [Replicate()] * t.device_mesh.ndim)
    return t


def dispatch_by_expert(expert_ids: torch.Tensor, gate_weights: torch.Tensor,
                       n_experts: int, capacity: int) -> Dispatch:
    """Group (token, expert) assignments into per-expert capacity blocks.

    expert_ids / gate_weights: (T, k).  Overflow beyond ``capacity`` per
    expert is dropped (weight zeroed, destination E*C, one past the
    buffer); underflow rows stay zero, so every expert sees exactly
    ``capacity`` rows.  Assignments with ``expert_id == n_experts`` (masked
    pad tokens) sort after every real assignment and never consume capacity.
    """
    t, k = expert_ids.shape
    dev = expert_ids.device
    flat_e = expert_ids.reshape(-1).long()
    flat_w = gate_weights.reshape(-1)
    flat_t = torch.arange(t * k, device=dev) // k
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = _bincount(flat_e, n_experts + 1)
    seg_start = torch.cumsum(counts, 0) - counts
    rank = torch.arange(t * k, device=dev) - seg_start[sorted_e]
    keep = (rank < capacity) & (sorted_e < n_experts)
    dest = torch.where(keep, sorted_e * capacity + rank, n_experts * capacity)
    return Dispatch(
        dest=dest,
        token=flat_t[order],
        weight=torch.where(keep, flat_w[order], 0.0),
        capacity=capacity,
    )


def moe_apply(p: MoE, x: torch.Tensor, cfg: ModelConfig, *,
              capacity: int | None = None, token_mask=None):
    """x: (B, S, d) -> (B, S, d); also returns the router aux loss.

    ``token_mask`` (B, S): masked (pad) tokens are excluded from dispatch —
    they never consume expert capacity and contribute zero output.
    """
    bsz, s, d = x.shape
    t = bsz * s
    e, k = cfg.n_experts, cfg.experts_per_token
    xt = reshape(x, t, d)

    logits = xt.to(F32) @ p.router                                # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_w, expert_ids = torch.topk(probs, k, dim=-1)             # (T, k)
    gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)
    if token_mask is not None:
        tm = token_mask.reshape(t) > 0
        expert_ids = torch.where(tm[:, None], expert_ids, e)      # pads -> drop id
        gate_w = torch.where(tm[:, None], gate_w, 0.0)

    mesh = xt.device_mesh if isinstance(xt, DTensor) else None
    if mesh is not None:
        # DTensor has no sharding rule for the routing's argsort and
        # bincount, nor (on some PyTorch releases) for the dispatch's
        # index_put: route, dispatch and combine on every rank's local copy
        # of the replicated tokens, ids and weights; only the expert
        # products (``project``: the experts over "model", FSDP's d split)
        # run on DTensors
        xt, gate_w = _whole(xt).to_local(), _whole(gate_w).to_local()
        expert_ids = expert_ids.full_tensor()

    if capacity is None:
        capacity = int(cfg.moe_capacity_factor * t * k / e)
        capacity = max(8, -(-capacity // 8) * 8)                  # mult of 8
    disp = dispatch_by_expert(expert_ids, gate_w, e, capacity)

    # scatter tokens into per-expert capacity blocks; the dropped rows land
    # in one extra row past E*C, sliced off (the reference's mode="drop")
    buf = xt.new_zeros((e * capacity + 1, d))
    buf[disp.dest] = xt[disp.token]
    he = reshape(buf[:e * capacity], e, capacity, d).to(F32)
    if mesh is not None:
        he = DTensor.from_local(he, mesh, [Replicate()] * mesh.ndim, run_check=False)

    g = project(he, p.wg.to(F32))
    u = project(he, p.wu.to(F32))
    hidden = (F.silu(g) * u).to(x.dtype)
    out_e = project(hidden.to(F32), p.wd.to(F32)).to(x.dtype)

    if mesh is not None:
        out_e = _whole(out_e).to_local()

    gathered = reshape(out_e, e * capacity, d)[torch.clamp(disp.dest, 0, e * capacity - 1)]
    contrib = gathered * disp.weight[:, None].to(x.dtype)
    yt = xt.new_zeros((t, d)).index_add_(
        0, disp.token, contrib)
    if mesh is not None:
        yt = DTensor.from_local(yt, mesh, [Replicate()] * mesh.ndim, run_check=False)

    # load-balancing auxiliary loss (Switch-style); pad ids (== E) count nowhere
    me = probs.mean(dim=0)                                        # (E,)
    ce = _bincount(expert_ids.reshape(-1), e + 1)[:e].to(F32) / (t * k)
    aux = e * torch.sum(me * ce)
    return reshape(yt, bsz, s, d), aux
