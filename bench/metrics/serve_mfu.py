"""The whole serving step's share of the card's bf16 dense peak, %: every
prompt token prefilled and every row decoded inside the window, times the
model's FLOPs per token (``benchkit.lm_work.flops_per_token``: in_proj,
SSD scan, out_proj a layer, the head once), over the window x 989e12."""

from benchkit import lm_work


def read(ctx):
    if not ctx.get("processed_window"):
        return None
    f = lm_work.flops_per_token(ctx["model"])
    if f is None:
        return None
    return 100.0 * ctx["processed_window"] * f / (ctx["window_s"]
                                                  * lm_work.BF16_FLOPS_PER_S)
