"""Loss functions (fp32 accumulation), torch port."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor


def _vocab_sharded(logits) -> bool:
    """Whether a DTensor's last dim is split over a mesh dim of more than
    one rank."""
    if not isinstance(logits, DTensor):
        return False
    mesh = logits.device_mesh
    return any(p.is_shard(logits.ndim - 1) and mesh.size(i) > 1
               for i, p in enumerate(logits.placements))


def cross_entropy(logits, labels, mask=None):
    """Token-level CE.  logits: (B, S, V) fp32 (padded-vocab rows already
    -inf-masked); labels: (B, S) integer; mask: (B, S) {0,1}."""
    logits = logits.to(torch.float32)
    if _vocab_sharded(logits):
        # each rank's max and exp-sum over its own columns, all-reduced:
        # DTensor's logsumexp would gather the vocabulary whole
        top = logits.detach().amax(dim=-1, keepdim=True)
        lse = torch.log(torch.exp(logits - top).sum(dim=-1)) + top[..., 0]
    else:
        lse = torch.logsumexp(logits, dim=-1)
    if isinstance(logits, DTensor):
        # DTensor's gather along a sharded vocab dim fails; the masked sum
        # keeps the vocab dim sharded and is exact (one non-zero term)
        vocab = torch.arange(logits.shape[-1], device=logits.device)
        picked = torch.where(vocab == labels[..., None], logits, 0.0).sum(-1)
    else:
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
