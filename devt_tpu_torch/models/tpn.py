"""The temporal pyramid network (TPN): port of ``devt_tpu/models/tpn.py``.

A spatial pyramid over ResNet-34's layer2/3/4 features of each frame,
then a multi-scale temporal relation module over the frame sequence.

  * Backbone: ``models/resnet.py``'s ResNet-34 with ``output="stages"``,
    the frames folded into the batch.
  * Spatial pyramid: a global mean of each stage, then a 1x1 convolution
    with bias on the low (128) and mid (256) branches.  The high branch
    has none, as in the JAX package (the reference defines one and never
    applies it).
  * Frame feature: concat(high 512, mid 256, low 128) = 896.
  * ``Reasoning``: for each scale g in [start, max_group], the sums of g
    adjacent frames (``sum_group``; trailing frames that fill no group are
    dropped), flattened, through a per-scale MLP with a sigmoid output;
    the predictions averaged over the scales.  fc1's input width is
    (T // g) · 896, so a TPN is built for one T (20 in the registry).

The JAX package's mean or sum of a bf16 tensor accumulates in f32 and
rounds the result to bf16; so do these.  Names follow the flax tree
(``backbone``, ``low_reduce``, ``mid_reduce``, ``reason.scale{g}_fc{k}``).
"""

from __future__ import annotations

import torch
from torch import nn

from devt_tpu_torch.models.layers import (DropoutRng, dense, dropout,
                                          init_weights, widen)
from devt_tpu_torch.models.resnet import resnet34


def sum_group(x: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, T, D) → (B, (T // groups) · D): the sums of each ``groups``
    adjacent frames, concatenated."""
    b, t, d = x.shape
    n = t // groups
    sums = widen(x[:, :n * groups].reshape(b, n, groups, d)).sum(dim=2)
    return sums.to(x.dtype).reshape(b, n * d)


class Reasoning(nn.Module):
    """The multi-scale temporal relation module."""

    def __init__(self, num_segments: int = 4, num_frames: int = 5,
                 num_class: int = 15, img_dim: int = 896,
                 max_group: int = 4, start: int = 2, bottleneck: int = 512,
                 dropout: tuple[float, float] = (0.6, 0.5),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.scales = range(start, max_group + 1)
        self.dropout, self.dtype = dropout, dtype
        total = num_segments * num_frames
        for g in self.scales:
            setattr(self, f"scale{g}_fc1",
                    nn.Linear((total // g) * img_dim, bottleneck))
            setattr(self, f"scale{g}_fc2", nn.Linear(bottleneck, bottleneck))
            setattr(self, f"scale{g}_fc3", nn.Linear(bottleneck, num_class))

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: DropoutRng | None = None) -> torch.Tensor:
        """x: (B, T, img_dim) → (B, num_class) probabilities."""
        dt = self.dtype
        prediction = None
        for g in self.scales:
            h = torch.relu(sum_group(x, g))
            h = torch.relu(dense(getattr(self, f"scale{g}_fc1"), h, dt))
            h = dropout(h, self.dropout[0], train, rng)
            h = torch.relu(dense(getattr(self, f"scale{g}_fc2"), h, dt))
            h = dropout(h, self.dropout[1], train, rng)
            h = torch.sigmoid(dense(getattr(self, f"scale{g}_fc3"), h, dt))
            prediction = h if prediction is None else prediction + h
        return prediction / len(self.scales)


class TPN(nn.Module):
    """(B, T, H, W, C) frames, T = num_segments · num_frames →
    (B, num_class) probabilities averaged over the scales."""

    def __init__(self, num_segments: int = 4, num_frames: int = 5,
                 num_class: int = 15, dropout: tuple[float, float] = (0.6,
                                                                      0.5),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.backbone = resnet34(output="stages", dtype=dtype)
        self.low_reduce = nn.Conv2d(128, 128, 1)
        self.mid_reduce = nn.Conv2d(256, 256, 1)
        self.reason = Reasoning(num_segments, num_frames, num_class,
                                dropout=dropout, dtype=dtype)

    def init_weights(self, generator: torch.Generator) -> "TPN":
        """flax's initializers: lecun-normal Dense and Conv kernels, zero
        biases, unit BatchNorm scales, running statistics (0, 1)."""
        init_weights(self, generator)
        return self

    def _pool(self, stage: torch.Tensor) -> torch.Tensor:
        """(N, H, W, C) → (N, C): the global mean, accumulated in f32."""
        return widen(stage).mean(dim=(1, 2)).to(self.dtype)

    def _reduce(self, c: nn.Conv2d, v: torch.Tensor) -> torch.Tensor:
        """A 1x1 convolution with bias of a 1x1 map: a Dense."""
        dt = self.dtype
        return torch.nn.functional.linear(v, c.weight.flatten(1).to(dt),
                                          c.bias.to(dt))

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: DropoutRng | None = None) -> torch.Tensor:
        b, t = x.shape[:2]
        frames = x.reshape((b * t,) + tuple(x.shape[2:])).to(self.dtype)
        low, mid, high = self.backbone(frames, train)
        feat = torch.cat([self._pool(high),
                          self._reduce(self.mid_reduce, self._pool(mid)),
                          self._reduce(self.low_reduce, self._pool(low))],
                         dim=-1)                              # (B·T, 896)
        return self.reason(feat.reshape(b, t, -1), train, rng)
