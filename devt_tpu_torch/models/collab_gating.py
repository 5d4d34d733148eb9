"""Collaborative gating, the pairwise expert fusion: port of
``devt_tpu/models/collab_gating.py``, in its vectorised form.

Per scene, with each expert projected once by one shared Linear,
p_i = P(e_i):

  t_i     = Σ_{j≠i} (p_i + p_j) = (E - 2)·p_i + Σ_j p_j
  a_i     = P(t_i)                         (the same Linear again)
  gated_i = p_i · σ(p_i + a_i)             (the context-gating GLU)
  out     = L2-normalise(W_geu · Σ_i gated_i)

Experts narrower than ``proj_dim`` are resized to it by nearest
neighbour, torch ``F.interpolate``'s default mode.  Names follow the flax
tree (``projection``, ``geu_fc``).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from devt_tpu_torch.models.contrastive import l2_normalize
from devt_tpu_torch.models.layers import dense, init_weights, widen


def interpolate_nearest_1d(x: torch.Tensor, out_size: int) -> torch.Tensor:
    """torch ``F.interpolate(mode='nearest')`` on the last axis."""
    n = x.shape[-1]
    if n == out_size:
        return x
    idx = (torch.arange(out_size, device=x.device) * n) // out_size
    return x.index_select(-1, idx)


class CollaborativeGating(nn.Module):
    def __init__(self, proj_dim: int = 2048, output_dim: int = 1024,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.proj_dim, self.dtype = proj_dim, dtype
        self.projection = nn.Linear(proj_dim, proj_dim)
        self.geu_fc = nn.Linear(proj_dim, output_dim)

    def init_weights(self, generator: torch.Generator
                     ) -> "CollaborativeGating":
        """flax's initializers: lecun-normal kernels, zero biases."""
        init_weights(self, generator)
        return self

    def forward(self, experts: torch.Tensor | Sequence[torch.Tensor]
                ) -> torch.Tensor:
        """experts: (B, S, E, D ≤ proj_dim), or a sequence of E tensors
        (B, S, D_i ≤ proj_dim) of different widths, each resized
        alone → (B, S, output_dim)."""
        dt = self.dtype
        if isinstance(experts, torch.Tensor):
            experts = interpolate_nearest_1d(experts.to(dt), self.proj_dim)
        else:
            experts = torch.stack([interpolate_nearest_1d(e.to(dt),
                                                          self.proj_dim)
                                   for e in experts], dim=-2)
        p = dense(self.projection, experts, dt)              # (B, S, E, D)
        # the JAX package's sums of a bf16 tensor accumulate in f32
        total = widen(p).sum(dim=-2, keepdim=True).to(dt)
        t = (p.shape[-2] - 2) * p + total
        a = dense(self.projection, t, dt)
        gated = p * torch.sigmoid(p + a)
        fused = widen(gated).sum(dim=-2).to(dt)             # (B, S, D)
        return l2_normalize(dense(self.geu_fc, fused, dt))
