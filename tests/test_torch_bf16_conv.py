"""The port's bf16 convolution on the CPU (``models/resnet.py:conv``)
rounds like a sound bf16 convolution: its forward, input gradient and
weight gradient within 1e-2 of the largest element of the f64
convolution of the same bf16-rounded operands (a sound one, accumulating
in f32 and rounding once, lands within about 4e-3).  The shapes are
R(2+1)D-18's temporal convolutions of layers 3 and 4 at FrameTransformer's
clip, where PyTorch 2.11's own CPU bf16 ``conv3d`` returned a weight
gradient off by 2.3e18 times its largest element
(``tools/bf16_conv_cpu.py``), and a 3 x 3 of ResNet-34's layer 4.
Imports no JAX."""

from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F

from devt_tpu_torch.models.resnet import conv

# six test workers share the host's cores, and torch's default of one
# intra-op thread a core oversubscribes them: two threads a worker
torch.set_num_threads(2)

LIMIT = 1e-2


@pytest.mark.parametrize("n,cin,t,h,cout,kernel,stride", [
    (8, 1152, 2, 7, 512, (3, 1, 1), (1, 1, 1)),
    (8, 1152, 4, 7, 512, (3, 1, 1), (2, 1, 1)),
    (8, 576, 3, 14, 256, (3, 1, 1), (1, 1, 1)),
    (20, 512, None, 7, 512, (3, 3), (1, 1)),
])
def test_cpu_bf16_conv_rounds_once(n, cin, t, h, cout, kernel, stride):
    g = torch.Generator().manual_seed(0)
    two_d = t is None
    spatial = (h, h) if two_d else (t, h, h)
    fmt = torch.channels_last if two_d else torch.channels_last_3d
    pad = tuple(k // 2 for k in kernel)
    fan_in = cin * torch.Size(kernel).numel()
    w = (torch.randn((cout, cin) + kernel, generator=g)
         / fan_in ** 0.5).bfloat16().float()
    x = torch.randn((n, cin) + spatial, generator=g).bfloat16().to(
        memory_format=fmt)
    raw = F.conv2d if two_d else F.conv3d
    out = raw(x[:1].float(), w, None, stride, pad).shape[1:]
    go = torch.randn((n,) + tuple(out), generator=g).bfloat16()

    def grads(fn, x, w, go):
        x, w = x.detach().requires_grad_(), w.detach().requires_grad_()
        y = fn(x, w)
        return (y,) + torch.autograd.grad(y, (x, w), go.to(y.dtype))

    got = grads(lambda a, b: conv(SimpleNamespace(
        weight=b, stride=stride, padding=pad), a, torch.bfloat16), x, w, go)
    want = grads(lambda a, b: raw(a, b, None, stride, pad), x.double(),
                 w.double(), go.double())
    assert got[0].dtype == got[1].dtype == torch.bfloat16
    for name, a, b in zip(("forward", "input gradient", "weight gradient"),
                          got, want):
        err = ((a.double() - b).abs().max() / b.abs().max()).item()
        assert err <= LIMIT, (name, err)
