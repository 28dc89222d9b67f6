"""Binary cross-entropy in probability and in logit space — counterpart
of ``apex_tpu/ops/losses.py``.

The reference bans probability-space ``binary_cross_entropy`` under fp16
autocast because ``log(p)`` needs the full float range
(``apex/amp/lists/functional_overrides.py:59-70``), and keeps the safe
``binary_cross_entropy_with_logits``.  Both are here with the JAX
package's formulas; both are overridable (a torch-function mode sees
their calls), so the O1 policy of :mod:`apex_tpu_torch.amp.autocast`
bans the first under fp16 (fp32 under bf16) and runs the second in fp32.
"""

from __future__ import annotations

import torch

from ..amp.autocast import overridable


def _reduce(loss, weight, reduction):
    if weight is not None:
        loss = loss * weight
    if reduction == "mean":
        return torch.mean(loss)
    if reduction == "sum":
        return torch.sum(loss)
    return loss


@overridable
def binary_cross_entropy(probs, targets, weight=None, reduction="mean"):
    """``-[t log(p + tiny) + (1 - t) log(1 - p + tiny)]`` in the dtype of
    ``probs`` (tiny: its smallest normal); fragile in half precision."""
    t = torch.as_tensor(targets, dtype=probs.dtype, device=probs.device)
    tiny = torch.finfo(probs.dtype).tiny
    loss = -(t * torch.log(probs + tiny)
             + (1.0 - t) * torch.log(1.0 - probs + tiny))
    return _reduce(loss, weight, reduction)


@overridable
def binary_cross_entropy_with_logits(logits, targets, weight=None,
                                     pos_weight=None, reduction="mean"):
    """Logit-space BCE in fp32 through the stable log-sum-exp form:
    ``max(x, 0) - x t + log1p(exp(-|x|))`` (with ``pos_weight``:
    ``(1 - t) x + (1 + (w - 1) t) (log1p(exp(-|x|)) + max(-x, 0))``)."""
    x = logits.to(torch.float32)
    t = torch.as_tensor(targets, dtype=torch.float32, device=x.device)
    softplus = torch.log1p(torch.exp(-torch.abs(x)))
    if pos_weight is not None:
        log_w = 1.0 + (pos_weight - 1.0) * t
        loss = (1.0 - t) * x + log_w * (softplus + torch.clamp(-x, min=0.0))
    else:
        loss = torch.clamp(x, min=0.0) - x * t + softplus
    return _reduce(loss, weight, reduction)
