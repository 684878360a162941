"""The yardstick's count for the published Zamba2 hybrid (family ``zamba2``):
the model's FLOPs per token, term by term, from the configuration's widths
(a multiply and an add count two).  The peak is ``lm_work``'s: 989e12 bf16
FLOP/s of one NVIDIA H100 SXM, dense.
"""

from __future__ import annotations


def flops_per_token(m: dict) -> float | None:
    """FLOPs of one token through the model, ``m`` the configuration's
    ``model`` block:

    * a Mamba layer (``n_layers`` of them), with d_inner = expand d, H =
      d_inner / P heads and G B/C groups:
      in_proj   2 d (2 d_inner + 2 G N + H)
      SSD scan  5 H P N: the recurrence's decay (H P N multiplies), dt x B^T
                (H P N), the add (H P N), y = h C (2 H P N)
      out_proj  2 d_inner d
    * a hybrid site (one a ``hybrid_layer_ids`` entry), with a = 2 d the
      attention's input [hidden, embeddings], h_q x hd its heads' width:
      q, k, v   2 a (h_q + 2 h_kv) hd
      o         2 h_q hd d
      gate_up   2 d 2 d_ff,  down  2 d_ff d
      the LoRA  2 (d r + r 2 d_ff),  the linear  2 d d
    * the head  2 d V, V the true vocabulary (tied to the embedding).

    Left out: the conv, norms, gates, RoPE and softmax (elementwise, under
    1 % of the total), and attention's context term, 4 (h_q hd) x context a
    site (at the chat mix's ~330 tokens of mean context, 4 x 7168 x 330 x 13
    = 0.12 GFLOP, 0.6 % of the 22.24 GFLOP a token).  Another family:
    None, and a reader that gets None reports nothing."""
    if m["family"] != "zamba2":
        return None
    d, f, v = int(m["d_model"]), int(m["d_ff"]), int(m["vocab_size"])
    di = int(m["ssm_expand"]) * d
    p, n, g = int(m["ssm_head_dim"]), int(m["ssm_state"]), int(m["ssm_groups"])
    h = di // p
    mamba = 2 * d * (2 * di + 2 * g * n + h) + 5 * h * p * n + 2 * di * d
    a, hd, r = 2 * d, int(m["head_dim"]), int(m["shared_adapter_rank"])
    hq, hkv = int(m["n_heads"]), int(m["n_kv_heads"])
    site = (2 * a * (hq + 2 * hkv) * hd + 2 * hq * hd * d + 2 * d * 2 * f + 2 * f * d
            + 2 * (d * r + r * 2 * f) + 2 * d * d)
    return float(int(m["n_layers"]) * mamba + len(m["hybrid_layer_ids"]) * site
                 + 2 * d * v)
