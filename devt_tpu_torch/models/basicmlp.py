"""The MLP baseline over aggregated expert embeddings: port of
``devt_tpu/models/basicmlp.py``.

fc1 (in → in) → ReLU → fc2 (in → bottleneck) → ReLU → BatchNorm →
fc3 (bottleneck → bottleneck) → ReLU, the embedding → fc4 (→ classes),
trained with cross-entropy.  The BatchNorm follows the bottleneck's
width, as in the JAX package, and is ``models/resnet.py``'s.  Names follow
the flax tree (``fc1`` … ``fc4``, ``bn``).
"""

from __future__ import annotations

import torch
from torch import nn

from devt_tpu_torch.models.layers import dense, init_weights
from devt_tpu_torch.models.resnet import BatchNorm


class BasicMLP(nn.Module):
    def __init__(self, input_shape: int = 2048, bottle_neck: int = 1024,
                 n_classes: int = 305, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Linear(input_shape, input_shape)
        self.fc2 = nn.Linear(input_shape, bottle_neck)
        self.bn = BatchNorm(bottle_neck, dtype)
        self.fc3 = nn.Linear(bottle_neck, bottle_neck)
        self.fc4 = nn.Linear(bottle_neck, n_classes)

    def init_weights(self, generator: torch.Generator) -> "BasicMLP":
        """flax's initializers: lecun-normal kernels, zero biases, unit
        BatchNorm scale, running statistics (0, 1)."""
        init_weights(self, generator)
        return self

    def forward(self, x: torch.Tensor, train: bool = False,
                return_embedding: bool = False):
        dt = self.dtype
        h = torch.relu(dense(self.fc1, x.to(dt), dt))
        h = torch.relu(dense(self.fc2, h, dt))
        h = self.bn(h, train)
        embedding = torch.relu(dense(self.fc3, h, dt))
        logits = dense(self.fc4, embedding, dt)
        if return_embedding:
            return logits, embedding
        return logits
