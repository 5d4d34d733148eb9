"""Loss functions: port of ``devt_tpu/models/losses.py``.

BCE-with-logits for multi-label genre tagging, BCE on probabilities,
cross-entropy with integer labels, and FrameTransformer's distillation
loss.  All compute in f32 whatever the input dtype.  The contrastive
(NT-Xent) losses come with their model (ROADMAP.md queue 1, item 5).
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


def distillation_loss(student_logits: torch.Tensor,
                      teacher_logits: torch.Tensor) -> torch.Tensor:
    """Cross-entropy of the student's distil-token logits against the
    argmax of the teacher's logits, which carry no gradient (the reference
    takes a hard target, ``torch.argmax(vid, dim=-1)``)."""
    labels = torch.argmax(teacher_logits.detach(), dim=-1)
    return cross_entropy(student_logits, labels)
