"""Plain reference of a Mamba2 language model (arXiv:2405.21060) with a bank
of output heads, in float32.

Per layer, on the residual stream x (pre-norm):

    u            = RMSNorm(x) * ln1
    z, xBC, dt   = split(u @ in_proj, [d_inner, d_inner + 2 N, H])
    xBC          = SiLU(causal depthwise conv of width W over xBC + conv_b)
    x_s, B, C    = split(xBC, [d_inner, N, N])          one B/C group
    dt           = softplus(dt + dt_bias);  A = -exp(A_log)   a scalar a head
    h_t          = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T        the SSD recurrence
    y_t          = h_t C_t + D x_t                            per head of P channels
    x           += (RMSNorm(y * SiLU(z)) * norm) @ out_proj

then the final RMSNorm and the head: the request's slot of ``bank_head``
(d x V), with the padded vocabulary masked.  The recurrence runs in the
publication's chunked dual form (chunks of ``ssm_chunk``: the quadratic form
inside a chunk, the state carried from chunk to chunk), which computes the
same h_t and y_t.

It imports nothing of the program.  The weights are the harness's tree of
tensors, keyed by the program's parameter names (``layers`` stacked on a
leading layer axis), upcast to float32 by ``as_f32``.  TF32 is turned
off for every product (``exact``).  ``fp8`` rounds every matrix to float8
e4m3 with a scale per matrix (its largest magnitude at 448): the control, the
precision next below the model's bfloat16.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

F32 = torch.float32


def exact() -> None:
    """No TF32 in any float32 product."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


MATRICES = ("embedding", "in_proj", "conv_w", "out_proj", "w")


def as_f32(w: dict) -> dict:
    """The weights tree upcast to float32, leaf by leaf."""
    return {k: as_f32(v) if isinstance(v, dict) else v.to(F32) for k, v in w.items()}


def fp8(w: dict) -> dict:
    """The float32 weights tree with each matrix rounded to float8 e4m3
    under a scale of its own (a stacked leaf: one a layer or a slot), so
    that its largest magnitude maps to 448; vectors kept."""
    out = {}
    for k, v in w.items():
        if isinstance(v, dict):
            out[k] = fp8(v)
            continue
        if k not in MATRICES:
            out[k] = v
            continue
        flat = v.reshape(v.shape[0] if v.ndim == 3 else 1, -1)
        scale = flat.abs().amax(dim=1, keepdim=True).clamp_min(1e-30) / 448.0
        out[k] = ((flat / scale).to(torch.float8_e4m3fn).to(F32) * scale).reshape(v.shape)
    return out


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def ssd(x, dt, a, b, c, chunk: int):
    """y_t = C_t . h_t with h_t = exp(dt_t a) h_{t-1} + dt_t x_t B_t^T.
    x: (Bt, S, H, P); dt: (Bt, S, H); a: (H,); b, c: (Bt, S, N); S a multiple
    of ``chunk``.  Returns (Bt, S, H, P)."""
    bt, s, h, p = x.shape
    n = b.shape[-1]
    nc = s // chunk
    x = x.reshape(bt, nc, chunk, h, p)
    dt = dt.reshape(bt, nc, chunk, h)
    b = b.reshape(bt, nc, chunk, n)
    c = c.reshape(bt, nc, chunk, n)
    la = torch.cumsum(dt * a, dim=2)                         # log decay to t
    # inside a chunk: y_i = sum_{j <= i} (C_i . B_j) exp(la_i - la_j) dt_j x_j
    causal = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool, device=x.device))
    seg = la[:, :, :, None, :] - la[:, :, None, :, :]          # (bt, nc, i, j, h)
    decay = torch.where(causal[None, None, :, :, None], torch.exp(
        torch.where(causal[None, None, :, :, None], seg, 0.0)), 0.0)
    cb = torch.einsum("bcin,bcjn->bcij", c, b)
    y = torch.einsum("bcij,bcijh,bcjh,bcjhp->bcihp", cb, decay, dt, x)
    # each chunk's state at its end, then carried across the chunks
    to_end = torch.exp(la[:, :, -1:, :] - la) * dt              # (bt, nc, l, h)
    own = torch.einsum("bclh,bcln,bclhp->bchpn", to_end, b, x)
    state = torch.zeros(bt, h, p, n, dtype=F32, device=x.device)
    entering = []
    for k in range(nc):
        entering.append(state)
        state = torch.exp(la[:, k, -1])[:, :, None, None] * state + own[:, k]
    h0 = torch.stack(entering, dim=1)                           # (bt, nc, h, p, n)
    y = y + torch.einsum("bcin,bchpn->bcihp", c, h0) * torch.exp(la)[..., None]
    return y.reshape(bt, s, h, p)


def mixer(u, p: dict, m: dict):
    """One Mamba2 block on (Bt, S, d) float32; ``p`` one layer's weights."""
    d = m["d_model"]
    di = m["ssm_expand"] * d
    hp, n, w = m["ssm_head_dim"], m["ssm_state"], m["ssm_conv_width"]
    h = di // hp
    bt, s, _ = u.shape
    z, xbc, dt = torch.split(u @ p["in_proj"], [di, di + 2 * n, h], dim=-1)
    conv = F.conv1d(F.pad(xbc.transpose(1, 2), (w - 1, 0)),
                    p["conv_w"].t()[:, None, :], p["conv_b"], groups=di + 2 * n)
    xbc = F.silu(conv.transpose(1, 2))
    xs, b, c = torch.split(xbc, [di, n, n], dim=-1)
    dt = F.softplus(dt + p["dt_bias"])
    a = -torch.exp(p["A_log"])
    xs = xs.reshape(bt, s, h, hp)
    y = ssd(xs, dt, a, b, c, m["ssm_chunk"]) + p["D"][:, None] * xs
    y = y.reshape(bt, s, di) * F.silu(z)
    return rmsnorm(y, p["norm"]["scale"], m["norm_eps"]) @ p["out_proj"]


def _layer(tree, i):
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def hidden(w: dict, tokens: torch.Tensor, m: dict) -> torch.Tensor:
    """The final-normed hidden state (Bt, S, d) of ``tokens`` (Bt, S),
    S a multiple of ``ssm_chunk`` (right padding changes no earlier
    position: every step is causal); ``w`` float32 (``as_f32``)."""
    x = w["embed"]["embedding"][tokens]
    lay = w["layers"]
    for i in range(m["n_layers"]):
        lp = _layer(lay, i)
        x = x + mixer(rmsnorm(x, lp["ln1"]["scale"], m["norm_eps"]), lp["mamba"], m)
    return rmsnorm(x, w["final_norm"]["scale"], m["norm_eps"])


def logits(w: dict, h: torch.Tensor, slots: torch.Tensor, m: dict) -> torch.Tensor:
    """(T, V) logits of hidden rows ``h`` (T, d) under the head slot of
    each row (``slots`` (T,)), the padded vocabulary masked."""
    bank = w["bank_head"]["w"]
    out = torch.empty(h.shape[0], bank.shape[-1], dtype=F32, device=h.device)
    for s in torch.unique(slots).tolist():
        sel = slots == s
        out[sel] = h[sel] @ bank[s]
    out[:, m["vocab_size"]:] = -torch.inf
    return out
