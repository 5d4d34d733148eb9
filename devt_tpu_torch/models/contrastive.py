"""Contrastive model pieces: port of ``devt_tpu/models/contrastive.py``.

Only ``l2_normalize`` for now, which the distillation step's cosine
similarity needs (``train/steps.py``).  The contrastive encoder itself and
its NT-Xent loss come with their own slice (ROADMAP.md queue 1, item 5).
"""

from __future__ import annotations

import torch


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """torch ``F.normalize(p=2)`` semantics, written as the JAX package
    writes it: ``x / max(||x||, eps)``."""
    norm = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / torch.clamp(norm, min=eps)
