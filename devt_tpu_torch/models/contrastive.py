"""The SimCLR-style contrastive encoder: port of
``devt_tpu/models/contrastive.py``.

  * the encoder Linear (no bias) → ReLU → BatchNorm → Linear (no bias) →
    ReLU → Linear, whose output is the embedding;
  * the projector ReLU → Linear → ReLU → Dropout(0.1) → Linear;
  * ``forward`` returns ``(embedding, projection)``;
  * the expert aggregation modes none / avg_pool / mean_pool / concat /
    collab_gate, where ``mean_pool`` is adaptive *max* pooling to the input
    width, as in the JAX package;
  * ``l2_normalize``, which the training step applies to the projections
    before ``models.losses.contrastive_loss`` (and the distillation step to
    its logits).

Parameters stay f32; ``dtype`` is the compute type, as flax's ``dtype=``.
The BatchNorm is ``models/resnet.py``'s (flax's statistics; a training
forward returns its new statistics through ``collect_batch_stats``);
``bn_sync_axis`` names the mesh axis it syncs its batch statistics over,
which the DP step sets for the length of a step (``parallel/
train_step.py:_sync_bn``).
Names follow the flax tree (``enc_fc1``, ``enc_bn``, ``enc_fc2``,
``enc_fc3``, ``proj_fc1``, ``proj_fc2``).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from devt_tpu_torch.models.layers import (DropoutRng, dense, dropout,
                                          init_weights)
from devt_tpu_torch.models.resnet import BatchNorm


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """torch ``F.normalize(p=2)`` semantics, written as the JAX package
    writes it: ``x / max(||x||, eps)``."""
    norm = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / torch.clamp(norm, min=eps)


def _bins(n: int, out_size: int) -> list[tuple[int, int]]:
    """torch's adaptive pooling bins: [floor(i n / out), ceil((i+1) n /
    out)) for each output i."""
    return [((i * n) // out_size, ((i + 1) * n + out_size - 1) // out_size)
            for i in range(out_size)]


def adaptive_avg_pool_1d(x: torch.Tensor, out_size: int) -> torch.Tensor:
    """torch ``F.adaptive_avg_pool1d`` semantics on the last axis, summed
    as the JAX package sums it: differences of one cumulative sum."""
    starts, ends = zip(*_bins(x.shape[-1], out_size))
    cums = torch.cat([torch.zeros(x.shape[:-1] + (1,), dtype=x.dtype,
                                  device=x.device), x.cumsum(-1)], dim=-1)
    starts = torch.tensor(starts, device=x.device)
    ends = torch.tensor(ends, device=x.device)
    seg = cums.index_select(-1, ends) - cums.index_select(-1, starts)
    return seg / (ends - starts).to(x.dtype)


def adaptive_max_pool_1d(x: torch.Tensor, out_size: int) -> torch.Tensor:
    """torch ``F.adaptive_max_pool1d`` semantics on the last axis."""
    return torch.stack([x[..., s:e].amax(dim=-1)
                        for s, e in _bins(x.shape[-1], out_size)], dim=-1)


def expert_aggregation(experts: Sequence[torch.Tensor], mode: str,
                       input_size: int):
    """Aggregate a sequence of per-modality tensors (..., d_i) into one
    (..., input_size) tensor; ``collab_gate`` passes them through (the
    gating happens upstream, in ``models/collab_gating.py``)."""
    if mode == "none":
        return experts[0]
    if mode == "concat":
        return torch.cat(list(experts), dim=-1)
    if mode == "avg_pool":
        return adaptive_avg_pool_1d(torch.cat(list(experts), dim=-1),
                                    input_size)
    if mode == "mean_pool":
        return adaptive_max_pool_1d(torch.cat(list(experts), dim=-1),
                                    input_size)
    if mode == "collab_gate":
        return experts
    raise ValueError(f"unknown aggregation {mode!r}")


class ContrastiveEncoder(nn.Module):
    """Encoder + projector; ``forward`` returns (embedding, projection)."""

    def __init__(self, input_shape: int = 2048, hidden_layer: int = 2048,
                 projection_size: int = 305, output_shape: int = 128,
                 dropout: float = 0.1, dtype: torch.dtype = torch.float32,
                 bn_sync_axis: str | None = None):
        super().__init__()
        self.dropout, self.dtype = dropout, dtype
        self.enc_fc1 = nn.Linear(input_shape, hidden_layer, bias=False)
        self.enc_bn = BatchNorm(hidden_layer, dtype, axis_name=bn_sync_axis)
        self.enc_fc2 = nn.Linear(hidden_layer, hidden_layer, bias=False)
        self.enc_fc3 = nn.Linear(hidden_layer, projection_size)
        self.proj_fc1 = nn.Linear(projection_size, projection_size)
        self.proj_fc2 = nn.Linear(projection_size, output_shape)

    @property
    def bn_sync_axis(self) -> str | None:
        """The mesh axis the encoder's BatchNorm syncs over (None: its own
        batch's statistics)."""
        return self.enc_bn.axis_name

    @bn_sync_axis.setter
    def bn_sync_axis(self, name: str | None) -> None:
        self.enc_bn.axis_name = name

    def init_weights(self, generator: torch.Generator
                     ) -> "ContrastiveEncoder":
        """flax's initializers: lecun-normal kernels, zero biases, unit
        BatchNorm scales, running statistics (0, 1)."""
        init_weights(self, generator)
        return self

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: DropoutRng | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        dt = self.dtype
        h = torch.relu(dense(self.enc_fc1, x.to(dt), dt))
        h = self.enc_bn(h, train)
        h = torch.relu(dense(self.enc_fc2, h, dt))
        embedding = dense(self.enc_fc3, h, dt)
        p = torch.relu(dense(self.proj_fc1, torch.relu(embedding), dt))
        p = dropout(p, self.dropout, train, rng)
        return embedding, dense(self.proj_fc2, p, dt)
