"""Plain reference of the published Zamba2 language model (Zyphra's
Zamba2-7B-Instruct, arXiv:2411.15242 and arXiv:2405.16712; the layer
equations as ``transformers``' ``models/zamba2/modeling_zamba2.py`` writes
them), in float32.

With e the token embeddings and x the residual stream (x = e at the start),
layer i of ``n_layers`` is

    x  += mamba_i(RMSNorm(x + t_i) * ln1_i)

where t_i is zero except at the hybrid sites: at site j (layer
``hybrid_layer_ids[j]``), with block b = j mod ``num_mem_blocks``,

    a     = RMSNorm([x, e]) * ln_attn_b                       (2 d wide)
    o     = Attention_b(a) @ wo_b        q, k, v = a @ wq_b, wk_b, wv_b;
                                         RoPE (halves) on each head of
                                         head_dim; causal softmax of
                                         q k^T (head_dim / 2) ** -0.5
    h     = RMSNorm(o) * ln_mlp_b
    g, u  = split(h @ wgu_b + (h @ lora_a_j) @ lora_b_j)      gate first
    t_i   = (GELU(g) * u) @ wd_b @ linear_j

so t_i joins the Mamba layer's input and not the residual stream
(``Zamba2MambaDecoderLayer`` keeps ``residual`` before adding it).  A Mamba
layer is ``mamba2_lm.mixer``'s with G B/C groups: ``in_proj`` gives [z, x,
B (G N), C (G N), dt], the causal conv runs over d_inner + 2 G N channels,
head h reads group h // (H / G), and the gated norm RMSNorm(y SiLU(z))
normalises each group's d_inner / G channels (``Zamba2RMSNormGated``).
dt = softplus(dt + dt_bias), unclamped (the published ``time_step_limit``
is null).  Then the final RMSNorm and the head, tied to the embedding.

It imports nothing of the program; it takes ``exact``, ``as_f32`` and
``rmsnorm`` from ``mamba2_lm.py`` beside it.  Its SSD is ``mamba2_lm``'s
chunked dual form, one B/C group at a time, with the product inside a
chunk taken in two steps so that no (chunk x chunk x heads x P) tensor is
ever held (at the check's 16,384 tokens a block, 56 heads of 64 would
need 60 GB).  The weights are the harness's tree keyed by the program's
parameter names (``layers``, ``blocks`` and ``sites`` stacked on a leading
axis), upcast by ``as_f32``.  ``fp8`` is the control: every matrix rounded
to float8 e4m3 under a scale of its own (one a layer, block or site).
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import torch
import torch.nn.functional as F


def _sibling(name: str):
    key = f"bench_reference_{name}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, Path(__file__).with_name(f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return sys.modules[key]


_m2 = _sibling("mamba2_lm")
F32 = torch.float32
exact, as_f32, rmsnorm = _m2.exact, _m2.as_f32, _m2.rmsnorm

MATRICES = ("embedding", "in_proj", "conv_w", "out_proj", "wq", "wk", "wv", "wo",
            "wgu", "wd", "lora_a", "lora_b", "linear")


def fp8(w: dict) -> dict:
    """The float32 weights tree with each matrix rounded to float8 e4m3
    under a scale of its own (a stacked leaf: one a layer, block or site),
    its largest magnitude at 448; vectors kept.  Slice by slice, so that
    the copy needs no more than its own room."""
    out = {}
    for k, v in w.items():
        if isinstance(v, dict):
            out[k] = fp8(v)
            continue
        if k not in MATRICES:
            out[k] = v
            continue
        q = torch.empty_like(v)
        for dst, src in zip(q if v.ndim == 3 else [q], v if v.ndim == 3 else [v]):
            scale = src.abs().amax().clamp_min(1e-30) / 448.0
            dst.copy_((src / scale).to(torch.float8_e4m3fn).to(F32) * scale)
        out[k] = q
    return out


def _layer(tree, i):
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def ssd(x, dt, a, b, c, chunk: int):
    """y_t = C_t . h_t with h_t = exp(dt_t a) h_{t-1} + dt_t x_t B_t^T, one
    B/C group.  x: (Bt, S, H, P); dt: (Bt, S, H); a: (H,); b, c: (Bt, S, N);
    S a multiple of ``chunk``.  Returns (Bt, S, H, P)."""
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
    w = torch.where(causal[None, None, :, :, None], torch.exp(
        torch.where(causal[None, None, :, :, None], seg, 0.0)), 0.0)
    del seg
    w = w * torch.einsum("bcin,bcjn->bcij", c, b)[..., None] * dt[:, :, None]
    y = torch.einsum("bcijh,bcjhp->bcihp", w, x)
    del w
    # each chunk's state at its end, then carried across the chunks
    to_end = torch.exp(la[:, :, -1:, :] - la) * dt              # (bt, nc, l, h)
    own = torch.einsum("bclhp,bcln->bchpn", to_end[..., None] * x, b)
    state = torch.zeros(bt, h, p, n, dtype=F32, device=x.device)
    entering = []
    for k in range(nc):
        entering.append(state)
        state = torch.exp(la[:, k, -1])[:, :, None, None] * state + own[:, k]
    h0 = torch.stack(entering, dim=1)                           # (bt, nc, h, p, n)
    y = y + torch.einsum("bcin,bchpn->bcihp", c, h0) * torch.exp(la)[..., None]
    return y.reshape(bt, s, h, p)


def mixer(u, p: dict, m: dict):
    """One Mamba2 block with G B/C groups on (Bt, S, d) float32."""
    d, g = m["d_model"], m["ssm_groups"]
    di = m["ssm_expand"] * d
    hp, n, w = m["ssm_head_dim"], m["ssm_state"], m["ssm_conv_width"]
    h, conv_dim = di // hp, di + 2 * g * n
    bt, s, _ = u.shape
    z, xbc, dt = torch.split(u @ p["in_proj"], [di, conv_dim, h], dim=-1)
    conv = F.conv1d(F.pad(xbc.transpose(1, 2), (w - 1, 0)),
                    p["conv_w"].t()[:, None, :], p["conv_b"], groups=conv_dim)
    xs, b, c = torch.split(F.silu(conv.transpose(1, 2)), [di, g * n, g * n], dim=-1)
    b, c = b.reshape(bt, s, g, n), c.reshape(bt, s, g, n)
    dt = F.softplus(dt + p["dt_bias"])
    a = -torch.exp(p["A_log"])
    xs = xs.reshape(bt, s, h, hp)
    hg = h // g
    y = torch.cat([ssd(xs[:, :, k * hg:(k + 1) * hg], dt[..., k * hg:(k + 1) * hg],
                       a[k * hg:(k + 1) * hg], b[:, :, k], c[:, :, k], m["ssm_chunk"])
                   for k in range(g)], dim=2)
    y = (y + p["D"][:, None] * xs).reshape(bt, s, di) * F.silu(z)
    y = y.reshape(bt, s, g, di // g)
    y = y * torch.rsqrt(y.square().mean(-1, keepdim=True) + m["norm_eps"])
    return (y.reshape(bt, s, di) * p["norm"]["scale"]) @ p["out_proj"]


def rope(x, theta: float):
    """x (Bt, S, heads, D) rotated by position, halves together."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=F32, device=x.device) / half)
    ang = torch.arange(x.shape[1], dtype=F32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(a, p: dict, m: dict):
    """Causal attention over (Bt, S, 2 d), one row at a time: (Bt, S, d)."""
    bt, s, _ = a.shape
    hq, hk, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    q = rope((a @ p["wq"]).reshape(bt, s, hq, hd), m["rope_theta"])
    k = rope((a @ p["wk"]).reshape(bt, s, hk, hd), m["rope_theta"])
    v = (a @ p["wv"]).reshape(bt, s, hk, hd)
    k, v = k.repeat_interleave(hq // hk, dim=2), v.repeat_interleave(hq // hk, dim=2)
    causal = torch.ones(s, s, dtype=torch.bool, device=a.device).tril()
    out = torch.empty(bt, s, hq, hd, dtype=F32, device=a.device)
    for r in range(bt):
        sc = torch.einsum("qhd,khd->hqk", q[r], k[r]) * (hd / 2) ** -0.5
        pr = torch.softmax(sc.masked_fill(~causal, -torch.inf), dim=-1)
        out[r] = torch.einsum("hqk,khd->qhd", pr, v[r])
    return out.reshape(bt, s, hq * hd) @ p["wo"]


def site(x, e, bp: dict, sp: dict, m: dict):
    """A hybrid site: its block over [x, e], the site's delta, its linear."""
    eps = m["norm_eps"]
    a = rmsnorm(torch.cat([x, e], dim=-1), bp["ln_attn"]["scale"], eps)
    h = rmsnorm(attention(a, bp["attn"], m), bp["ln_mlp"]["scale"], eps)
    g, u = (h @ bp["mlp"]["wgu"] + (h @ sp["lora_a"]) @ sp["lora_b"]).chunk(2, dim=-1)
    return (F.gelu(g) * u) @ bp["mlp"]["wd"] @ sp["linear"]


def hidden(w: dict, tokens: torch.Tensor, m: dict) -> torch.Tensor:
    """The final-normed hidden state (Bt, S, d) of ``tokens`` (Bt, S), S a
    multiple of ``ssm_chunk`` (right padding changes no earlier position:
    every step is causal); ``w`` float32 (``as_f32``)."""
    e = w["embed"]["embedding"][tokens]
    x = e
    sites = {layer: j for j, layer in enumerate(m["hybrid_layer_ids"])}
    for i in range(m["n_layers"]):
        lp = _layer(w["layers"], i)
        xin = x
        if i in sites:
            j = sites[i]
            xin = x + site(x, e, _layer(w["blocks"], j % m["num_mem_blocks"]),
                           _layer(w["sites"], j), m)
        x = x + mixer(rmsnorm(xin, lp["ln1"]["scale"], m["norm_eps"]), lp["mamba"], m)
    return rmsnorm(x, w["final_norm"]["scale"], m["norm_eps"])


def logits(w: dict, h: torch.Tensor, slots: torch.Tensor, m: dict) -> torch.Tensor:
    """(T, V) logits of hidden rows ``h`` (T, d) under the tied head (one
    resident model: ``slots`` unused), the padded vocabulary masked."""
    out = h @ w["embed"]["embedding"].t()
    out[:, m["vocab_size"]:] = -torch.inf
    return out
