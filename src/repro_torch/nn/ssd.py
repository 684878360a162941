"""Mamba2 / SSD (state-space duality) block — chunked scan formulation.

The sequence is split into chunks of ``cfg.ssm_chunk``; within a chunk the
quadratic dual form runs (attention-like products on (l, l) decay
matrices), and the (B, H, P, N) state is carried from chunk to chunk.  The
work inside each chunk does not depend on the carried state, so it runs
for all chunks at once; only the state's recurrence (one multiply-add per
chunk) is a Python loop, the counterpart of the reference's ``lax.scan``.

``ssd_sequential`` is the token-recurrence oracle used by the tests; the
decode path reuses the same recurrence for O(1)-state generation.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.nn.modules import F32, RMSNorm, _const, _dense_init, cdtype, rmsnorm


def ssm_dims(cfg: ModelConfig):
    di = cfg.d_inner
    h = cfg.ssm_heads
    n = cfg.ssm_state
    conv_dim = di + 2 * n  # conv runs over [x, B, C]
    return di, h, n, conv_dim


class Mamba(nn.Module):
    def __init__(self, cfg: ModelConfig, gen, device):
        super().__init__()
        d = cfg.d_model
        di, h, n, conv_dim = ssm_dims(cfg)
        dt = cdtype(cfg)
        proj_out = 2 * di + 2 * n + h  # [z, x, B, C, dt]
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


def ssd_chunked(x, dt, a, b, c, chunk: int, init_state=None):
    """SSD over a full sequence.

    x: (B, S, H, P) values; dt: (B, S, H) positive step sizes;
    a: (H,) negative decay rates; b, c: (B, S, N) (single B/C group).
    Returns y: (B, S, H, P) and final state (B, H, P, N).
    """
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by chunk {chunk}")
    nc = s // chunk

    xc = x.reshape(bsz, nc, chunk, h, p).to(F32)
    dtc = dt.reshape(bsz, nc, chunk, h).to(F32)
    bc = b.reshape(bsz, nc, chunk, n).to(F32)
    cc = c.reshape(bsz, nc, chunk, n).to(F32)

    state = (torch.zeros((bsz, h, p, n), dtype=F32, device=x.device)
             if init_state is None else init_state.to(F32))

    cum = torch.cumsum(dtc * a, dim=2)                           # (B, C, L, H) inclusive
    # intra-chunk (dual quadratic form)
    lmat = torch.exp(_segsum(cum.transpose(2, 3)))               # (B, C, H, L, L)
    scores = torch.einsum("bcin,bcjn->bcij", cc, bc)             # (B, C, L, L)
    m = scores[:, :, None] * lmat                                # (B, C, H, i, j)
    xdt = xc * dtc[..., None]                                    # (B, C, L, H, P)
    y_intra = torch.einsum("bchij,bcjhp->bcihp", m, xdt)
    # each chunk's own contribution to the state at its end
    decay_out = torch.exp(cum[:, :, -1:, :] - cum)               # (B, C, L, H)
    new_state = torch.einsum("bclh,bcln,bclhp->bchpn", decay_out * dtc, bc, xc)
    chunk_decay = torch.exp(cum[:, :, -1])[..., None, None]     # (B, C, H, 1, 1)
    entering = []
    for ci in range(nc):
        entering.append(state)
        state = chunk_decay[:, ci] * state + new_state[:, ci]
    # inter-chunk (incoming state)
    y_inter = torch.einsum("bcin,bchpn->bcihp", cc, torch.stack(entering, dim=1))
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
    bt, ct: (B,N).  Returns (new_state, y_t (B,H,P))."""
    dtf = dtt.to(F32)
    decay = torch.exp(dtf * a)                                   # (B, H)
    upd = dtf[:, :, None, None] * bt.to(F32)[:, None, None, :] * xt.to(F32)[..., None]
    state = decay[..., None, None] * state + upd
    yt = torch.einsum("bn,bhpn->bhp", ct.to(F32), state)
    return state, yt.to(xt.dtype)


# ---------------------------------------------------------------------------
# full mamba2 block
# ---------------------------------------------------------------------------

def _split_proj(proj, cfg: ModelConfig):
    di, h, n, _ = ssm_dims(cfg)
    return torch.split(proj, [di, di, n, n, h], dim=-1)  # z, x, B, C, dt


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
    xs, bs, cs = torch.split(conv_out, [di, n, n], dim=-1)

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
    y = y.reshape(bsz, s, di)
    y = rmsnorm(p.norm, y * F.silu(z.to(F32)).to(y.dtype), cfg.norm_eps)
    return y @ p.out_proj, new_state, new_conv_state


def init_mamba_state(cfg: ModelConfig, batch: int, device):
    di, h, n, conv_dim = ssm_dims(cfg)
    return (
        torch.zeros((batch, h, cfg.ssm_head_dim, n), dtype=F32, device=device),
        torch.zeros((batch, cfg.ssm_conv_width - 1, conv_dim), dtype=cdtype(cfg),
                    device=device),
    )
