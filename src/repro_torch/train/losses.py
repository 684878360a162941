"""Loss functions (fp32 accumulation), torch port."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cross_entropy(logits, labels, mask=None):
    """Token-level CE.  logits: (B, S, V) fp32 (padded-vocab rows already
    -inf-masked); labels: (B, S) integer; mask: (B, S) {0,1}."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels[..., None].to(torch.int64))[..., 0]
    nll = lse - picked
    if mask is None:
        return nll.mean()
    mask = mask.to(torch.float32)
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def weighted_bce_with_logits(scores, labels, pos_weight: float = 1.0):
    """Binary CE over raw scores (the BNN verdict head).  ``pos_weight``
    reproduces the paper's recall-oriented (4.0) vs precision-oriented (0.5)
    slot training."""
    scores = scores.to(torch.float32)
    labels = labels.to(torch.float32)
    log_p = F.logsigmoid(scores)
    log_np = F.logsigmoid(-scores)
    loss = -(pos_weight * labels * log_p + (1.0 - labels) * log_np)
    return loss.mean()
