"""Mamba2 / SSD (state-space duality) block — chunked scan formulation.

The sequence is split into chunks of ``cfg.ssm_chunk``; within a chunk the
quadratic dual form runs (attention-like products on (l, l) decay
matrices), and the (B, H, P, N) state is carried from chunk to chunk.  The
work inside each chunk does not depend on the carried state, so it runs
for all chunks at once; only the state's recurrence (one multiply-add per
chunk) is a Python loop, the counterpart of the reference's ``lax.scan``.

``ssd_sequential`` is the token-recurrence oracle used by the tests; the
decode path reuses the same recurrence for O(1)-state generation.

On DTensors the block runs on each rank's shares (``_HeadShards``), as
GSPMD lays the reference out, read from its HLO: the "model" mesh dim
splits each part along its own axis in ``torch.chunk``'s way, which is
GSPMD's padded split (mamba2-130m over 16 ranks: the in-projection's 3352
columns 210 each, the conv's 1792 channels 112, the 24 heads 2 each on 12
ranks, d_inner's 1536 channels 96 for the gated norm and the
out-projection's rows), each rank's part gathered whole before the next;
the norm over d_inner and the C·Bᵀ scores (their contraction over the
state split 16 ways) are all-reduced, and the out-projection's rows give
a partial sum.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.nn.modules import F32, RMSNorm, _const, _dense_init, cdtype, reduce_pending


def ssm_groups(cfg: ModelConfig) -> int:
    """B/C groups: head h reads group h // (H / G).  One unless the
    configuration names more (``configs.zamba2_7b_instruct``)."""
    return getattr(cfg, "ssm_groups", 1)


def ssm_dims(cfg: ModelConfig):
    di = cfg.d_inner
    h = cfg.ssm_heads
    n = cfg.ssm_state
    conv_dim = di + 2 * ssm_groups(cfg) * n  # conv runs over [x, B, C]
    return di, h, n, conv_dim


class Mamba(nn.Module):
    def __init__(self, cfg: ModelConfig, gen, device):
        super().__init__()
        d = cfg.d_model
        di, h, n, conv_dim = ssm_dims(cfg)
        dt = cdtype(cfg)
        proj_out = 2 * di + 2 * ssm_groups(cfg) * n + h  # [z, x, B, C, dt]
        self.in_proj = _dense_init(gen, (d, proj_out), dt, device)
        self.conv_w = _dense_init(gen, (cfg.ssm_conv_width, conv_dim), dt, device, scale=0.5)
        self.conv_b = _const(0.0, (conv_dim,), dt, device)
        self.dt_bias = _const(0.0, (h,), F32, device)
        self.A_log = _const(0.0, (h,), F32, device)   # A = -exp(A_log) = -1 at init
        self.D = _const(1.0, (h,), F32, device)
        self.norm = RMSNorm(di, dt, device)
        self.out_proj = _dense_init(gen, (di, d), dt, device, scale=di ** -0.5)


# ---------------------------------------------------------------------------
# core SSD math
# ---------------------------------------------------------------------------

def _segsum(cum: torch.Tensor) -> torch.Tensor:
    """cum: (..., L) inclusive cumsum -> (..., L, L) lower-tri pair sums
    ``exp`` argument: cum_i - cum_j for i >= j, -inf above the diagonal."""
    l = cum.shape[-1]
    diff = cum[..., :, None] - cum[..., None, :]
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=cum.device))
    return torch.where(mask, diff, -torch.inf)


def ssd_chunked(x, dt, a, b, c, chunk: int, init_state=None, scores=None):
    """SSD over a full sequence.

    x: (B, S, H, P) values; dt: (B, S, H) positive step sizes;
    a: (H,) negative decay rates; b, c: (B, S, G, N) in G groups, head h
    reading group h // (H / G) ((B, S, N) is one group).
    ``scores``: the (B, S / chunk, G, chunk, chunk) C·Bᵀ products within
    each chunk, when the caller has them (``_HeadShards``); else computed
    here.  Returns y: (B, S, H, P) and final state (B, H, P, N).
    """
    if b.ndim == 3:
        b, c = b[:, :, None], c[:, :, None]
    bsz, s, h, p = x.shape
    g, n = b.shape[-2:]
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by chunk {chunk}")
    nc = s // chunk

    xc = x.reshape(bsz, nc, chunk, h, p).to(F32)
    dtc = dt.reshape(bsz, nc, chunk, h).to(F32)
    bc = b.reshape(bsz, nc, chunk, g, n).to(F32)
    cc = c.reshape(bsz, nc, chunk, g, n).to(F32)

    state = (torch.zeros((bsz, h, p, n), dtype=F32, device=x.device)
             if init_state is None else init_state.to(F32))

    cum = torch.cumsum(dtc * a, 2)                                  # (B, C, L, H) inclusive
    # intra-chunk (dual quadratic form)
    lmat = torch.exp(_segsum(cum.transpose(2, 3)))               # (B, C, H, L, L)
    if scores is None:
        scores = torch.einsum("bcign,bcjgn->bcgij", cc, bc)      # (B, C, G, L, L)
    m = (scores[:, :, :, None] * lmat.unflatten(2, (g, -1))).flatten(2, 3)  # (B, C, H, i, j)
    xdt = xc * dtc[..., None]                                    # (B, C, L, H, P)
    y_intra = torch.einsum("bchij,bcjhp->bcihp", m, xdt)
    # each chunk's own contribution to the state at its end
    decay_out = torch.exp(cum[:, :, -1:, :] - cum)               # (B, C, L, H)
    new_state = torch.einsum("bclgk,bclgn,bclgkp->bcgkpn", (decay_out * dtc).unflatten(3, (g, -1)),
                             bc, xc.unflatten(3, (g, -1))).flatten(2, 3)
    chunk_decay = torch.exp(cum[:, :, -1])[..., None, None]     # (B, C, H, 1, 1)
    entering = []
    for ci in range(nc):
        entering.append(state)
        state = chunk_decay[:, ci] * state + new_state[:, ci]
    # inter-chunk (incoming state)
    y_inter = torch.einsum("bcign,bcgkpn->bcigkp", cc,
                           torch.stack(entering, dim=1).unflatten(2, (g, -1))).flatten(3, 4)
    y_inter = y_inter * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).to(x.dtype).reshape(bsz, s, h, p)
    return y, state


def ssd_sequential(x, dt, a, b, c, init_state=None):
    """Token-recurrence oracle: state_t = exp(dt_t a) state + dt_t b_t x_t."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    state = (torch.zeros((bsz, h, p, n), dtype=F32, device=x.device)
             if init_state is None else init_state.to(F32))
    ys = []
    for t in range(s):
        state, yt = ssd_decode_step(state, x[:, t], dt[:, t], a, b[:, t], c[:, t])
        ys.append(yt)
    return torch.stack(ys, dim=1), state


def ssd_decode_step(state, xt, dtt, a, bt, ct):
    """One-token recurrence.  state: (B,H,P,N); xt: (B,H,P); dtt: (B,H);
    bt, ct: (B,G,N), head h reading group h // (H/G) ((B,N) is one group).
    Returns (new_state, y_t (B,H,P))."""
    if bt.ndim == 2:
        bt, ct = bt[:, None], ct[:, None]
    g = bt.shape[1]
    dtf = dtt.to(F32)
    decay = torch.exp(dtf * a)                                   # (B, H)
    upd = (dtf.unflatten(1, (g, -1))[..., None, None] * bt.to(F32)[:, :, None, None, :]
           * xt.to(F32).unflatten(1, (g, -1))[..., None])        # (B, G, H/G, P, N)
    state = decay[..., None, None] * state + upd.flatten(1, 2)
    yt = torch.einsum("bgn,bgkpn->bgkp", ct.to(F32), state.unflatten(1, (g, -1)))
    return state, yt.flatten(1, 2).to(xt.dtype)


# ---------------------------------------------------------------------------
# full mamba2 block
# ---------------------------------------------------------------------------

def _split_proj(proj, cfg: ModelConfig):
    di, h, n, _ = ssm_dims(cfg)
    gn = ssm_groups(cfg) * n
    return torch.split(proj, [di, di, gn, gn, h], dim=-1)  # z, x, B, C, dt


def gated_norm(p: RMSNorm, y, z, cfg: ModelConfig):
    """RMSNorm(y * SiLU(z)) * scale, normalised over each B/C group's
    d_inner / G channels (one group: the whole d_inner)."""
    g = (y * F.silu(z.to(F32)).to(y.dtype)).to(F32)
    g = g.reshape(*g.shape[:-1], ssm_groups(cfg), -1)
    g = g * torch.rsqrt(g.square().mean(dim=-1, keepdim=True) + cfg.norm_eps)
    return (g.reshape(y.shape) * p.scale.to(F32)).to(y.dtype)


def _causal_conv(xbc, conv_w, conv_b, width: int):
    """Depthwise causal conv over (B, S, C)."""
    pad = F.pad(xbc, (0, 0, width - 1, 0))
    out = sum(
        pad[:, i: i + xbc.shape[1], :] * conv_w[i][None, None, :]
        for i in range(width)
    )
    return out + conv_b[None, None, :]


def mamba_apply(p: Mamba, x, cfg: ModelConfig, *, ssm_state=None, conv_state=None,
                pad_mask=None, last_valid=None):
    """Mamba2 block.  Full-sequence when states are None; otherwise one-token
    decode carrying (ssm_state (B,H,P,N), conv_state (B, width-1, conv_dim)).

    ``pad_mask`` (B, S) zeroes dt at right-pad positions so the carried SSM
    state is exact for bucketed prefill; ``last_valid`` (B,) makes the carried
    conv window end at each row's true prompt end.

    Returns (out (B,S,d), new_ssm_state, new_conv_state).
    """
    if isinstance(x, DTensor):
        return _HeadShards(p, x, cfg).apply(ssm_state, conv_state, pad_mask, last_valid)
    bsz, s, _ = x.shape
    di, h, n, conv_dim = ssm_dims(cfg)
    w = cfg.ssm_conv_width
    proj = x @ p.in_proj
    z, xin, b, c, dt_raw = _split_proj(proj, cfg)

    xbc = torch.cat([xin, b, c], dim=-1)  # (B, S, conv_dim)
    if conv_state is None:
        conv_out = _causal_conv(xbc, p.conv_w, p.conv_b, w)
        if last_valid is not None:
            padded = F.pad(xbc, (0, 0, w - 1, 0))
            # window ending at each row's prompt end (start clamped into range)
            start = torch.clamp(last_valid.long(), 0, s)
            idx = start[:, None] + torch.arange(w - 1, device=x.device)
            new_conv_state = padded[torch.arange(bsz, device=x.device)[:, None], idx]
        else:
            new_conv_state = xbc[:, -(w - 1):, :] if s >= w - 1 else F.pad(
                xbc, (0, 0, w - 1 - s, 0))
    else:
        window = torch.cat([conv_state, xbc], dim=1)  # (B, w, C)
        conv_out = (torch.einsum("bwc,wc->bc", window, p.conv_w) + p.conv_b)[:, None, :]
        new_conv_state = window[:, 1:, :]
    conv_out = F.silu(conv_out.to(F32)).to(x.dtype)
    gn = ssm_groups(cfg) * n
    xs, bs, cs = torch.split(conv_out, [di, gn, gn], dim=-1)
    bs, cs = bs.unflatten(-1, (-1, n)), cs.unflatten(-1, (-1, n))  # (B, S, G, N)

    dt = torch.logaddexp(dt_raw.to(F32) + p.dt_bias, torch.zeros((), dtype=F32,
                                                                  device=x.device))
    if pad_mask is not None and ssm_state is None:
        dt = dt * pad_mask[..., None].to(dt.dtype)  # pads: no state update
    a = -torch.exp(p.A_log)
    xh = xs.reshape(bsz, s, h, cfg.ssm_head_dim)

    if ssm_state is None:
        chunk = min(cfg.ssm_chunk, s)
        while s % chunk:
            chunk //= 2
        y, new_state = ssd_chunked(xh, dt, a, bs, cs, max(chunk, 1))
    else:
        new_state, yt = ssd_decode_step(
            ssm_state, xh[:, 0], dt[:, 0], a, bs[:, 0], cs[:, 0])
        y = yt[:, None]
    y = y + p.D[None, None, :, None].to(y.dtype) * xh
    y = gated_norm(p.norm, y.reshape(bsz, s, di), z, cfg)
    return y @ p.out_proj, new_state, new_conv_state


class _HeadShards:
    """The mamba block of DTensors laid out per rank as GSPMD lays out the
    reference (module docstring).  Per mesh dim: "model" splits the block;
    a dim sharding the batch keeps it; a dim over which the input's
    features are scattered (a decode batch of one) splits the projections
    (``fdims``); any other dim holds the block whole.  Every weight is
    gathered whole and sliced, its gradient a partial sum.

    On "model" each part takes ``torch.chunk``'s slice of its own axis,
    the split GSPMD gets by padding that axis to a multiple of the ranks:
    the in-projection's columns (mamba2-130m's 3352 as 16 x 210), the
    conv's channels (1792 as 16 x 112), the SSM heads (24 padded to 32: 2
    on each of the first 12 ranks), the state's slice for C·Bᵀ (128 as
    16 x 8) and d_inner's channels for the gated norm and the
    out-projection's rows (1536 as 16 x 96).  Between the parts each
    rank's slice is gathered whole, each reader's gradient a partial sum."""

    def __init__(self, p: Mamba, x, cfg: ModelConfig):
        if ssm_groups(cfg) > 1:
            raise NotImplementedError(
                f"the mamba block on DTensors holds one B/C group; {cfg.name} has "
                f"{ssm_groups(cfg)}: run it on one card")
        self.p, self.cfg = p, cfg
        self.mesh = mesh = x.device_mesh
        names = mesh.mesh_dim_names
        self.mi = names.index("model") if "model" in names else None
        self.ways = mesh.size(self.mi) if self.mi is not None else 1
        x = reduce_pending(x)
        last, xp = x.ndim - 1, list(x.placements)
        if self.mi is not None and xp[self.mi].is_shard(last):
            # features sharded on "model" (an adapter's output in the
            # residual) move to an idle dim of that size, as in ``project``
            xp[self.mi] = Replicate()
            for j, q in enumerate(xp):
                if q.is_replicate() and j != self.mi and mesh.size(j) == self.ways:
                    xp[j] = Shard(last)
                    break
            x = x.redistribute(mesh, xp)
        # dims that shard the features (an idle dim of a decode batch of
        # one, where GSPMD scatters the residual): the in-projection splits
        # its contraction there, and over the idle pods too (``kdims``), and
        # the out-projection its columns there
        self.fdims = [i for i, q in enumerate(xp) if q.is_shard(last)]
        self.kdims = [i for i, (q, name) in enumerate(zip(xp, names))
                      if i in self.fdims or (self.fdims and name == "pod" and q.is_replicate())]
        # the batch's placements; the model dim and any other replicated
        self.keep = [q if q.is_shard(0) and i != self.mi else Replicate()
                     for i, q in enumerate(xp)]
        # the gradient of what every model rank reads whole, and of what
        # the feature dims' ranks compute alike: a partial sum
        self.part = [Partial() if i == self.mi or i in self.fdims else k
                     for i, k in enumerate(self.keep)]
        self.x = x

    def share(self, total: int, dims=None) -> slice:
        """This rank's slice of ``total`` in ``torch.chunk``'s split (the
        split of a ``Shard`` placement) over ``dims``, in their order
        (default: the model dim)."""
        lo, size = 0, total
        for i in ([self.mi] if dims is None else dims):
            if i is None:
                continue
            step = -(-size // self.mesh.size(i))
            start = min(size, self.mesh.get_local_rank(i) * step)
            lo, size = lo + start, min(step, size - start)
        return slice(lo, lo + size)

    def _at(self, i: int, placement) -> list:
        return [placement if j == i else k for j, k in enumerate(self.keep)]

    def local(self, t, grad=None):
        """A batch-placed DTensor (or a host tensor) as this rank's local
        tensor, the batch shard kept and the rest whole."""
        if not isinstance(t, DTensor):
            return t
        return t.redistribute(self.mesh, self.keep).to_local(grad_placements=grad)

    def weight(self, t, split=()):
        """A parameter gathered whole; its gradient a partial sum over the
        model dim (each rank reads its slices), the feature dims, the
        ``split`` dims (whose ranks read slices of it) and the batch dims."""
        whole = [Replicate()] * self.mesh.ndim
        grad = [Partial() if i == self.mi or i in self.fdims or i in split or k.is_shard()
                else Replicate() for i, k in enumerate(self.keep)]
        return t.redistribute(self.mesh, whole).to_local(grad_placements=grad)

    def dtensor(self, local, placements, shape):
        return DTensor.from_local(local, self.mesh, placements, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=torch.empty(shape, device="meta").stride())

    def gather(self, local, dim: int, shape, pending=()):
        """The rank's slice along ``dim`` (``share``'s, of ``shape``),
        gathered whole over the model dim, and its partial sums over the
        ``pending`` dims reduced; its gradient partial."""
        if self.mi is None and not pending:
            return local
        t = self.dtensor(local, [Shard(dim) if i == self.mi else Partial() if i in pending
                                 else k for i, k in enumerate(self.keep)], shape)
        return t.redistribute(self.mesh, self.keep).to_local(grad_placements=self.part)

    def reduce(self, local, shape):
        """Partial sums over the model dim, all-reduced; each rank reads the
        sum for its own slice, so its gradient is a partial sum too."""
        if self.mi is None:
            return local
        t = self.dtensor(local, self._at(self.mi, Partial()), shape)
        return t.redistribute(self.mesh, self.keep).to_local(grad_placements=self.part)

    def apply(self, ssm_state, conv_state, pad_mask, last_valid):
        p, cfg = self.p, self.cfg
        di, h, n, conv_dim = ssm_dims(cfg)
        hd, w = cfg.ssm_head_dim, cfg.ssm_conv_width
        feats = [Shard(2) if i in self.kdims else k for i, k in enumerate(self.part)]
        x = self.x.redistribute(self.mesh, [Shard(2) if i in self.kdims else k
                                            for i, k in enumerate(self.keep)]
                                ).to_local(grad_placements=feats)
        bsz_l, s, _ = x.shape
        bsz = self.x.shape[0]
        hs = self.share(h)
        heads = slice(hs.start * hd, hs.stop * hd)
        hl = hs.stop - hs.start

        cols, rows = self.share(2 * di + 2 * n + h), self.share(cfg.d_model, self.kdims)
        proj = self.gather(x @ self.weight(p.in_proj, self.kdims)[rows, cols], 2,
                           (bsz, s, 2 * di + 2 * n + h), pending=self.kdims)
        z, xin, _, _, dt_raw = _split_proj(proj, cfg)
        xbc = torch.cat([xin, proj[..., 2 * di:2 * di + 2 * n]], dim=-1)  # [x, B, C]

        ch = self.share(conv_dim)
        cw, cb = self.weight(p.conv_w)[:, ch], self.weight(p.conv_b)[ch]
        if conv_state is None:
            conv_out = _causal_conv(xbc[..., ch], cw, cb, w)
            if last_valid is not None:
                padded = F.pad(xbc, (0, 0, w - 1, 0))
                start = torch.clamp(self.local(last_valid).long(), 0, s)
                idx = start[:, None] + torch.arange(w - 1, device=x.device)
                window = padded[torch.arange(bsz_l, device=x.device)[:, None], idx]
            else:
                window = xbc[:, -(w - 1):, :] if s >= w - 1 else F.pad(
                    xbc, (0, 0, w - 1 - s, 0))
        else:
            window = torch.cat([self.local(conv_state), xbc], dim=1)
            conv_out = (torch.einsum("bwc,wc->bc", window[..., ch], cw) + cb)[:, None, :]
            window = window[:, 1:, :]
        conv_out = F.silu(conv_out.to(F32)).to(x.dtype)
        conv_out = self.gather(conv_out, 2, (bsz, s, conv_dim))
        xs, bs, cs = torch.split(conv_out, [di, n, n], dim=-1)

        dt = torch.logaddexp(dt_raw[..., hs].to(F32) + self.weight(p.dt_bias)[hs],
                             torch.zeros((), dtype=F32, device=x.device))
        if pad_mask is not None and ssm_state is None:
            dt = dt * self.local(pad_mask)[..., None].to(dt.dtype)
        a = -torch.exp(self.weight(p.A_log)[hs])
        xh = xs[..., heads].reshape(bsz_l, s, hl, hd)

        if ssm_state is None:
            chunk = min(cfg.ssm_chunk, s)
            while s % chunk:
                chunk //= 2
            chunk = max(chunk, 1)
            scores = None
            if self.ways > 1 and n % self.ways == 0:
                # C·Bᵀ over this rank's slice of the state, all-reduced
                st, nc = self.share(n), s // chunk
                part = torch.einsum("bcign,bcjgn->bcgij",
                                    cs[..., st].to(F32).reshape(bsz_l, nc, chunk, 1, -1),
                                    bs[..., st].to(F32).reshape(bsz_l, nc, chunk, 1, -1))
                scores = self.reduce(part, (bsz, nc, 1, chunk, chunk))
            y, state = ssd_chunked(xh, dt, a, bs, cs, chunk, scores=scores)
        else:
            state_in = self.local(ssm_state)[:, hs]
            state, yt = ssd_decode_step(state_in, xh[:, 0], dt[:, 0], a, bs[:, 0], cs[:, 0])
            y = yt[:, None]
        y = y + self.weight(p.D)[hs][None, None, :, None].to(y.dtype) * xh
        # the heads gathered, then the gated norm and the out-projection's
        # rows on this rank's share of d_inner's channels
        y = self.gather(y, 2, (bsz, s, h, hd)).reshape(bsz_l, s, di)
        dc = self.share(di)
        g = (y[..., dc] * F.silu(z[..., dc].to(F32)).to(y.dtype)).to(F32)
        if self.ways == 1:
            var = g.square().mean(dim=-1, keepdim=True)
        else:  # the mean over the whole d_inner: each rank's sum, all-reduced
            var = self.reduce(g.square().sum(dim=-1, keepdim=True), (bsz, s, 1)) / di
        scale = self.weight(p.norm.scale)[dc]
        yn = (g * torch.rsqrt(var + cfg.norm_eps) * scale.to(F32)).to(y.dtype)
        out = yn @ self.weight(p.out_proj)[dc, self.share(cfg.d_model, self.fdims)]
        out = reduce_pending(self.dtensor(
            out, [Partial() if i == self.mi else Shard(2) if i in self.fdims else k
                  for i, k in enumerate(self.keep)], (bsz, s, cfg.d_model)))
        new_state = self.dtensor(state, self._at(self.mi, Shard(1)) if self.mi is not None
                                 else self.keep, (bsz, h, hd, n))
        new_state = new_state.redistribute(self.mesh, self.keep)
        new_conv = self.dtensor(window, self.keep, (bsz, w - 1, conv_dim))
        return out, new_state, new_conv


def init_mamba_state(cfg: ModelConfig, batch: int, device):
    di, h, n, conv_dim = ssm_dims(cfg)
    return (
        torch.zeros((batch, h, cfg.ssm_head_dim, n), dtype=F32, device=device),
        torch.zeros((batch, cfg.ssm_conv_width - 1, conv_dim), dtype=cdtype(cfg),
                    device=device),
    )
