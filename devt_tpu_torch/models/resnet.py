"""ResNet backbones (2-D): port of ``devt_tpu/models/resnet.py``.

torchvision's ResNet semantics (the reference's frozen ``ImgResNet`` frame
encoder, and TPN's multi-stage trunk) behind the JAX package's
channels-last interface: an image batch is (B, H, W, C).  Inside, the
convolutions get the batch's (B, C, H, W) view, whose strides are those of
``torch.channels_last``, so cuDNN runs NHWC convolutions on the card and
no transposing copy is made.

Convolutions are ``F.conv2d`` (cuDNN on the card): the JAX package leaves
them to XLA, outside any Pallas kernel.  ``dtype`` is the compute type, as
flax's ``dtype=``: input and kernel are cast to it at each convolution.

``BatchNorm`` has flax's semantics, not ``nn.BatchNorm2d``'s: statistics
in f32 whatever the compute type, the running variance updated with the
biased batch variance, momentum 0.9 on the old value.  ``train`` is an
argument, as in flax, and not the module's mode: FrameTransformer runs its
image backbone with ``train=False`` while it trains.  In eval the running
averages normalise; in training the batch statistics do, and the new
running averages go to ``collect_batch_stats`` (the train step returns
them as ``new_model_state``, and ``TrainState.apply_gradients`` copies them
into the buffers), never into the buffers directly.

Submodule names follow the flax tree (``stem``, ``layer{i}_{j}``,
``conv1.conv``, ``conv1.bn``, ``downsample``, ``fc``).  BatchNorm's
``scale`` and ``bias`` are ``weight`` and ``bias``, and its
``batch_stats`` ``mean`` and ``var`` are the buffers ``running_mean`` and
``running_var``; ``utils/jax_bridge.py`` maps them by name.

A BatchNorm whose ``axis_name`` is set (flax's ``axis_name=``) syncs its
batch statistics across the ranks of that mesh axis: the mean and E[x²]
of each rank, before the variance, are averaged over the axis
(``parallel.collectives.pmean_grad``), so every rank normalises by the
global batch's statistics.  This is flax's arithmetic, not
``torch.nn.SyncBatchNorm``'s (Welford counts, an unbiased running
variance).
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from devt_tpu_torch.models.layers import dense
from devt_tpu_torch.parallel.collectives import pmean_grad

BN_MOMENTUM = 0.9   # torch BatchNorm momentum 0.1 ⇒ flax momentum 1-0.1
BN_EPS = 1e-5

_COLLECTORS: list[dict] = []


@contextlib.contextmanager
def collect_batch_stats() -> Iterator[dict]:
    """Inside, a BatchNorm that normalises by its batch statistics records
    its new running statistics ``(mean, var)`` in the yielded dict, keyed
    by the module, and leaves its buffers as they are.  A training forward
    outside raises."""
    out: dict = {}
    _COLLECTORS.append(out)
    try:
        yield out
    finally:
        _COLLECTORS.pop()


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=dtype,
    axis_name=axis_name)`` over axis 1 of an (N, C, ...) tensor."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32,
                 axis_name: str | None = None):
        super().__init__()
        self.dtype = dtype
        self.axis_name = axis_name
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        # at least f32, as flax promotes the statistics' type
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if train:
            axes = (0,) + tuple(range(2, x.dim()))
            mean, mean2 = xf.mean(axes), (xf * xf).mean(axes)
            if self.axis_name is not None:
                mean, mean2 = pmean_grad(torch.cat([mean, mean2]),
                                         self.axis_name).chunk(2)
            # flax's fast variance: E[x²] - E[x]², clipped at 0
            var = torch.clamp(mean2 - mean * mean, min=0.0)
            new = (BN_MOMENTUM * self.running_mean
                   + (1.0 - BN_MOMENTUM) * mean.detach(),
                   BN_MOMENTUM * self.running_var
                   + (1.0 - BN_MOMENTUM) * var.detach())
            if not _COLLECTORS:
                raise RuntimeError("a training forward of BatchNorm runs "
                                   "inside collect_batch_stats")
            _COLLECTORS[-1][self] = new
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(self.dtype)


def conv(c: nn.Conv2d | nn.Conv3d, x: torch.Tensor,
         dtype: torch.dtype) -> torch.Tensor:
    """flax ``Conv(dtype=...)`` without bias on the (N, C, ...) view of a
    channels-last batch: input and kernel cast to ``dtype``, the kernel
    laid out channels-last like the input.

    On the CPU a bf16 convolution runs in f32 on the bf16-rounded input
    and kernel, and rounds its result (and so, in the backward, each
    gradient it returns) to bf16, the arithmetic of cuDNN's bf16
    convolution on the card.  PyTorch's own CPU bf16 convolution is not
    trusted: PyTorch 2.11's ``conv3d`` returns the weight gradient of a
    (3, 1, 1) kernel at (8, 1152, 2, 7, 7) → 512 off by 2.3e18 times the
    leaf's largest element (``tools/bf16_conv_cpu.py``)."""
    fmt = torch.channels_last if x.dim() == 4 else torch.channels_last_3d
    fn = F.conv2d if x.dim() == 4 else F.conv3d
    w = c.weight.to(dtype=dtype, memory_format=fmt)
    if x.device.type == "cpu" and dtype == torch.bfloat16:
        return fn(x.to(dtype).float(), w.float(), None, c.stride,
                  c.padding).to(dtype)
    return fn(x.to(dtype), w, None, c.stride, c.padding)


class ConvBN(nn.Module):
    """Convolution without bias, then BatchNorm; 2-D or 3-D by the length
    of ``kernel`` (``ConvBN`` and ``ConvBN3d`` of the JAX package)."""

    def __init__(self, cin: int, features: int, kernel: Sequence[int],
                 strides: Sequence[int] | None = None,
                 padding: int | Sequence[int] = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cls = nn.Conv2d if len(kernel) == 2 else nn.Conv3d
        self.dtype = dtype
        self.conv = cls(cin, features, tuple(kernel),
                        tuple(strides or (1,) * len(kernel)), padding,
                        bias=False)
        self.bn = BatchNorm(features, dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.bn(conv(self.conv, x, self.dtype), train)


class BasicBlock(nn.Module):
    """3x3 + 3x3 residual block."""
    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 downsample: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        s = (stride, stride)
        self.conv1 = ConvBN(cin, planes, (3, 3), s, 1, dtype)
        self.conv2 = ConvBN(planes, planes, (3, 3), (1, 1), 1, dtype)
        if downsample:
            self.downsample = ConvBN(cin, planes * self.expansion, (1, 1), s,
                                     0, dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        out = self.conv2(F.relu(self.conv1(x, train)), train)
        identity = (self.downsample(x, train) if hasattr(self, "downsample")
                    else x)
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    """1x1 → 3x3 → 1x1 residual block."""
    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 downsample: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        s = (stride, stride)
        self.conv1 = ConvBN(cin, planes, (1, 1), (1, 1), 0, dtype)
        self.conv2 = ConvBN(planes, planes, (3, 3), s, 1, dtype)
        self.conv3 = ConvBN(planes, planes * self.expansion, (1, 1), (1, 1),
                            0, dtype)
        if downsample:
            self.downsample = ConvBN(cin, planes * self.expansion, (1, 1), s,
                                     0, dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        out = F.relu(self.conv1(x, train))
        out = F.relu(self.conv2(out, train))
        out = self.conv3(out, train)
        identity = (self.downsample(x, train) if hasattr(self, "downsample")
                    else x)
        return F.relu(out + identity)


class ResNet(nn.Module):
    """torchvision-semantics ResNet trunk on (B, H, W, C) images.

    ``output``: ``"logits"`` (global average pool → ``fc``),
    ``"features"`` (the pooled (B, C) vector) or ``"stages"`` (layer2,
    layer3 and layer4's maps, channels-last)."""

    def __init__(self, block: type = BasicBlock,
                 layers: Sequence[int] = (2, 2, 2, 2),
                 num_classes: int = 1000, output: str = "logits",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if output not in ("logits", "features", "stages"):
            raise ValueError(f"unknown output {output!r}")
        self.output, self.dtype = output, dtype
        self.stem = ConvBN(3, 64, (7, 7), (2, 2), 3, dtype)
        self.stages: list[list[str]] = []
        inplanes = 64
        for li, (planes, blocks) in enumerate(zip((64, 128, 256, 512),
                                                  layers)):
            stride = 1 if li == 0 else 2
            names = []
            for bi in range(blocks):
                s = stride if bi == 0 else 1
                down = bi == 0 and (s != 1
                                    or inplanes != planes * block.expansion)
                cin = inplanes if bi == 0 else planes * block.expansion
                names.append(f"layer{li + 1}_{bi}")
                setattr(self, names[-1], block(cin, planes, s, down, dtype))
            inplanes = planes * block.expansion
            self.stages.append(names)
        if output == "logits":
            self.fc = nn.Linear(inplanes, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False):
        x = x.permute(0, 3, 1, 2)   # the (B, C, H, W) view, channels-last
        x = F.relu(self.stem(x, train))
        x = F.max_pool2d(x, 3, 2, 1)
        stages = []
        for names in self.stages:
            for name in names:
                x = getattr(self, name)(x, train)
            stages.append(x)
        if self.output == "stages":
            return tuple(t.permute(0, 2, 3, 1) for t in stages[1:])
        x = x.mean(dim=(2, 3))      # global average pool
        if self.output == "features":
            return x
        return dense(self.fc, x, self.dtype)


def resnet18(**kw) -> ResNet:
    return ResNet(block=BasicBlock, layers=(2, 2, 2, 2), **kw)


def resnet34(**kw) -> ResNet:
    return ResNet(block=BasicBlock, layers=(3, 4, 6, 3), **kw)


def resnet50(**kw) -> ResNet:
    return ResNet(block=Bottleneck, layers=(3, 4, 6, 3), **kw)
