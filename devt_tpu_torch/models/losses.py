"""Loss functions: port of ``devt_tpu/models/losses.py``.

BCE-with-logits for multi-label genre tagging, BCE on probabilities,
cross-entropy with integer labels, FrameTransformer's distillation loss,
and the contrastive encoder's two SimCLR losses: ``nt_xent`` and
``contrastive_loss``.  All compute in f32 whatever the input dtype.
"""

from __future__ import annotations

import torch

from devt_tpu_torch.parallel.collectives import all_gather_rows


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


def _cosine_sim_matrix(z: torch.Tensor) -> torch.Tensor:
    """Pairwise cosine similarity of the rows of (2N, D): (2N, 2N), f32."""
    z = z.float()
    z = z / torch.clamp(torch.linalg.vector_norm(z, dim=-1, keepdim=True),
                        min=1e-8)
    return z @ z.T


def _positives(sim: torch.Tensor, n: int) -> torch.Tensor:
    """The diagonals at offsets +n and -n: each row's other view."""
    return torch.cat([torch.diagonal(sim, n), torch.diagonal(sim, -n)])


def nt_xent(z_i: torch.Tensor, z_j: torch.Tensor, temperature: float = 0.5,
            axis_name: str | None = None) -> torch.Tensor:
    """NT-Xent over 2N rows: each row's positive (its other view) against
    the 2N - 2 rows that are neither itself nor its positive, which are
    masked with -1e9; the cross-entropy summed over the 2N rows and
    divided by 2N.

    With ``axis_name`` (inside ``parallel.collectives.axis_scope``, as the
    DP step runs) the projections of every rank are gathered first, so
    every rank scores its positives against the global negative pool: N
    is the global batch."""
    if axis_name is not None:
        z_i = all_gather_rows(z_i, axis_name)
        z_j = all_gather_rows(z_j, axis_name)
    n = z_i.shape[0]
    big_n = 2 * n
    sim = _cosine_sim_matrix(torch.cat([z_i, z_j])) / temperature
    pos = _positives(sim, n)
    eye = torch.eye(big_n, dtype=torch.bool, device=sim.device)
    masked = eye | torch.roll(eye, n, dims=1) | torch.roll(eye, -n, dims=1)
    neg = sim.masked_fill(masked, -1e9)
    logits = torch.cat([pos[:, None], neg], dim=1)
    return -torch.log_softmax(logits, dim=1)[:, 0].sum() / big_n


def contrastive_loss(z_i: torch.Tensor, z_j: torch.Tensor,
                     temperature: float = 0.5) -> torch.Tensor:
    """The single-process SimCLR loss: the denominator masks only each
    row's similarity with itself, so the positive is in it; the inputs are
    used as given (the step normalises them first)."""
    n = z_i.shape[0]
    sim = _cosine_sim_matrix(torch.cat([z_i, z_j]))
    nominator = torch.exp(_positives(sim, n) / temperature)
    negatives = 1.0 - torch.eye(2 * n, dtype=torch.float32,
                                device=sim.device)
    denominator = (negatives * torch.exp(sim / temperature)).sum(dim=1)
    return -torch.log(nominator / denominator).sum() / (2 * n)
