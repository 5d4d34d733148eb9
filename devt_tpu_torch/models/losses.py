"""Loss functions: port of ``devt_tpu/models/losses.py``.

BCE-with-logits for multi-label genre tagging, BCE on probabilities, and
cross-entropy with integer labels.  All compute in f32 whatever the input
dtype.  The contrastive (NT-Xent) and distillation losses come with their
models (ROADMAP.md queue 1, item 5).
"""

from __future__ import annotations

import torch


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor
                    ) -> torch.Tensor:
    """Mean binary cross-entropy on logits, in the stable
    ``max(x, 0) - x t + log1p(exp(-|x|))`` form."""
    logits = logits.float()
    targets = targets.float()
    loss = torch.clamp(logits, min=0.0) - logits * targets \
        + torch.log1p(torch.exp(-logits.abs()))
    return loss.mean()


def bce(probs: torch.Tensor, targets: torch.Tensor, eps: float = 1e-7
        ) -> torch.Tensor:
    """Mean BCE on probabilities, clipped to [eps, 1 - eps]."""
    p = probs.float().clamp(eps, 1.0 - eps)
    t = targets.float()
    return (-(t * torch.log(p) + (1.0 - t) * torch.log(1.0 - p))).mean()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy with integer labels."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[:, None]).mean()
