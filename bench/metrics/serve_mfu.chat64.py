"""The whole serving step's share of the card's bf16 dense peak, %, for the
published Zamba2 hybrid: every prompt token prefilled and every row decoded
inside the window, times the model's FLOPs per token
(``benchkit.hybrid_work.flops_per_token``: the Mamba layers, the hybrid
sites, the head), over the window x 989e12."""

from benchkit import hybrid_work, lm_work


def read(ctx):
    if not ctx.get("processed_window"):
        return None
    f = hybrid_work.flops_per_token(ctx["model"])
    if f is None:
        return None
    return 100.0 * ctx["processed_window"] * f / (ctx["window_s"]
                                                  * lm_work.BF16_FLOPS_PER_S)
