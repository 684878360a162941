"""The yardstick's counts for a served language model: the model's FLOPs per
token and the least bytes a decode tick must move, term by term, from the
configuration's widths.  Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet,
dense): 989e12 bf16 FLOP/s and 3.35e12 B/s of HBM.

Only the Mamba2 family (``ssm``) is counted here; another family returns
None, and a reader that gets None reports nothing.
"""

from __future__ import annotations

BF16_FLOPS_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12


def _dims(m: dict) -> dict:
    d = int(m["d_model"])
    di = int(m["ssm_expand"]) * d
    p, n, w = int(m["ssm_head_dim"]), int(m["ssm_state"]), int(m["ssm_conv_width"])
    return dict(d=d, di=di, h=di // p, p=p, n=n, w=w, conv=di + 2 * n,
                layers=int(m["n_layers"]), vocab=int(m["vocab_size"]),
                proj=2 * di + 2 * n + di // p)


def flops_per_token(m: dict) -> float | None:
    """FLOPs of one token through the model (a multiply and an add count
    two), where ``m`` is the configuration's ``model`` block:

    * in_proj:  2 d (2 d_inner + 2 N + H)        a layer
    * SSD scan: 5 H P N                          a layer: the recurrence's
      decay (H P N multiplies), dt x B^T (H P N), the add (H P N), and
      y = h C (2 H P N), the least work of the scan per token
    * out_proj: 2 d_inner d                      a layer
    * head:     2 d V                            once, V the true vocabulary

    The conv (2 W (d_inner + 2N) a layer), the norms, the gate and the skip
    are left out: elementwise work under 1 % of the total."""
    if m["family"] != "ssm":
        return None
    k = _dims(m)
    per_layer = (2 * k["d"] * k["proj"] + 5 * k["h"] * k["p"] * k["n"]
                 + 2 * k["di"] * k["d"])
    return float(k["layers"] * per_layer + 2 * k["d"] * k["vocab"])


def decode_bytes(m: dict, rows: int, head_slots: int) -> float | None:
    """The least bytes a decode tick of ``rows`` active rows over
    ``head_slots`` distinct head slots must move:

    * the non-embedding weights once, bf16 (2 B), f32 (4 B) where the model
      keeps them so:  per layer ln1 (d), in_proj (d x proj), conv_w
      (W x conv) and conv_b (conv), dt_bias, A_log and D (3 H, f32), the
      gated norm (d_inner), out_proj (d_inner x d); the final norm (d)
    * each distinct head slot once: d x V x 2 B
    * the rows' embeddings: rows x d x 2 B
    * the SSM state of the active rows read and written, f32:
      2 x rows x layers x H x P x N x 4 B
    * their conv state read and written, bf16: 2 x rows x layers x (W-1) x
      conv x 2 B
    * the logits written once, f32: rows x V x 4 B"""
    if m["family"] != "ssm":
        return None
    k = _dims(m)
    per_layer = 2 * (k["d"] + k["d"] * k["proj"] + k["w"] * k["conv"] + k["conv"]
                     + k["di"] + k["di"] * k["d"]) + 4 * 3 * k["h"]
    weights = k["layers"] * per_layer + 2 * k["d"]
    heads = head_slots * k["d"] * k["vocab"] * 2
    embed = rows * k["d"] * 2
    state = 2 * rows * k["layers"] * k["h"] * k["p"] * k["n"] * 4
    conv = 2 * rows * k["layers"] * (k["w"] - 1) * k["conv"] * 2
    out = rows * k["vocab"] * 4
    return float(weights + heads + embed + state + conv + out)
