"""Video backbones, R(2+1)D-18 and R3D-18: port of
``devt_tpu/models/r2plus1d.py``.

The reference's clip encoder is torchvision's ``r2plus1d_18`` with its
classifier replaced by a Linear to 896.  Every 3x3x3 convolution is
factorised into a (1, 3, 3) spatial convolution into ``midplanes``
channels and a (3, 1, 1) temporal one, with BatchNorm and ReLU between.
``midplanes = (in * out * 27) // (in * 9 + 3 * out)`` keeps the pair's
parameter count that of the full 3-D convolution (torchvision's formula).

The interface is the JAX package's channels-last (B, T, H, W, C) clip;
the convolutions get its (B, C, T, H, W) view, whose strides are those of
``torch.channels_last_3d``, so no transposing copy is made.  BatchNorm,
the convolutions' compute type and the names follow ``models/resnet.py``
(``stem_spatial``, ``stem_temporal``, ``layer{i}_{j}``, ``conv1.spatial``,
``conv1.temporal``, ``bn1``, ``downsample``; R3D's ``stem``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from devt_tpu_torch.models.layers import dense
from devt_tpu_torch.models.resnet import BatchNorm, ConvBN, conv

# the JAX package's ConvBN3d: ConvBN with a 3-D kernel
ConvBN3d = ConvBN


def _midplanes(inp: int, outp: int) -> int:
    return (inp * outp * 3 * 3 * 3) // (inp * 3 * 3 + 3 * outp)


class Conv2Plus1D(nn.Module):
    """(1, 3, 3) spatial convolution → BatchNorm → ReLU → (3, 1, 1)
    temporal convolution."""

    def __init__(self, cin: int, features: int, midplanes: int,
                 stride: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        s = stride
        self.dtype = dtype
        self.spatial = ConvBN3d(cin, midplanes, (1, 3, 3), (1, s, s),
                                (0, 1, 1), dtype)
        self.temporal = nn.Conv3d(midplanes, features, (3, 1, 1), (s, 1, 1),
                                  (1, 0, 0), bias=False)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return conv(self.temporal, F.relu(self.spatial(x, train)), self.dtype)


class VideoBasicBlock(nn.Module):
    """Residual block of two (2+1)-D convolutions.  ``midplanes`` comes
    from the block's (in, planes) pair and serves both convolutions
    (torchvision's quirk, kept for its weights)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        mid = _midplanes(inplanes, planes)
        self.conv1 = Conv2Plus1D(inplanes, planes, mid, stride, dtype)
        self.bn1 = BatchNorm(planes, dtype)
        self.conv2 = Conv2Plus1D(planes, planes, mid, 1, dtype)
        self.bn2 = BatchNorm(planes, dtype)
        if stride != 1 or inplanes != planes:
            s = stride
            self.downsample = ConvBN3d(inplanes, planes, (1, 1, 1),
                                       (s, s, s), (0, 0, 0), dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x, train), train))
        out = self.bn2(self.conv2(out, train), train)
        identity = (self.downsample(x, train) if hasattr(self, "downsample")
                    else x)
        return F.relu(out + identity)


class R3DBasicBlock(nn.Module):
    """Plain 3x3x3 residual block (torchvision's ``r3d_18``, the
    reference's video expert extractor)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        s = stride
        self.conv1 = ConvBN3d(inplanes, planes, (3, 3, 3), (s, s, s),
                              (1, 1, 1), dtype)
        self.conv2 = ConvBN3d(planes, planes, (3, 3, 3), (1, 1, 1),
                              (1, 1, 1), dtype)
        if s != 1 or inplanes != planes:
            self.downsample = ConvBN3d(inplanes, planes, (1, 1, 1),
                                       (s, s, s), (0, 0, 0), dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        out = self.conv2(F.relu(self.conv1(x, train)), train)
        identity = (self.downsample(x, train) if hasattr(self, "downsample")
                    else x)
        return F.relu(out + identity)


class _VideoResNet(nn.Module):
    """The stages, pooling and head shared by R(2+1)D and R3D; the
    subclass builds its stem."""

    def _build_stages(self, block: type, layers: Sequence[int],
                      num_classes: int) -> None:
        self.blocks: list[str] = []
        inplanes = 64
        for li, (planes, blocks) in enumerate(zip((64, 128, 256, 512),
                                                  layers)):
            stride = 1 if li == 0 else 2
            for bi in range(blocks):
                self.blocks.append(f"layer{li + 1}_{bi}")
                setattr(self, self.blocks[-1],
                        block(inplanes, planes, stride if bi == 0 else 1,
                              self.dtype))
                inplanes = planes
        if self.output == "logits":
            self.fc = nn.Linear(inplanes, num_classes)

    def _stem(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x.permute(0, 4, 1, 2, 3)   # (B, C, T, H, W), channels-last
        x = self._stem(x, train)
        for name in self.blocks:
            x = getattr(self, name)(x, train)
        if self.output == "stages":
            return x.permute(0, 2, 3, 4, 1)    # layer4's map, pre-pool
        x = x.mean(dim=(2, 3, 4))              # global average pool
        if self.output == "features":
            return x
        return dense(self.fc, x, self.dtype)


class R2Plus1D(_VideoResNet):
    """R(2+1)D video ResNet: (B, T, H, W, C) → logits, features, or with
    ``output="stages"`` layer4's map (B, T/8, H/16, W/16, 512)."""

    def __init__(self, layers: Sequence[int] = (2, 2, 2, 2),
                 num_classes: int = 400, output: str = "logits",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if output not in ("logits", "features", "stages"):
            raise ValueError(f"unknown output {output!r}")
        self.output, self.dtype = output, dtype
        # (1, 7, 7) spatial into 45 channels, then (3, 1, 1) temporal to 64
        self.stem_spatial = ConvBN3d(3, 45, (1, 7, 7), (1, 2, 2), (0, 3, 3),
                                     dtype)
        self.stem_temporal = ConvBN3d(45, 64, (3, 1, 1), (1, 1, 1),
                                      (1, 0, 0), dtype)
        self._build_stages(VideoBasicBlock, layers, num_classes)

    def _stem(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        x = F.relu(self.stem_spatial(x, train))
        return F.relu(self.stem_temporal(x, train))


class R3D(_VideoResNet):
    """3-D ResNet (torchvision's ``r3d_18``): (B, T, H, W, C) → logits or
    features."""

    def __init__(self, layers: Sequence[int] = (2, 2, 2, 2),
                 num_classes: int = 400, output: str = "logits",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if output not in ("logits", "features"):
            raise ValueError(f"unknown output {output!r}")
        self.output, self.dtype = output, dtype
        self.stem = ConvBN3d(3, 64, (3, 7, 7), (1, 2, 2), (1, 3, 3), dtype)
        self._build_stages(R3DBasicBlock, layers, num_classes)

    def _stem(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        return F.relu(self.stem(x, train))


def r2plus1d_18(**kw) -> R2Plus1D:
    return R2Plus1D(layers=(2, 2, 2, 2), **kw)


def r3d_18(**kw) -> R3D:
    return R3D(layers=(2, 2, 2, 2), **kw)
